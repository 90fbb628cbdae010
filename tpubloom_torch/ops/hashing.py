"""Hash family in plain PyTorch: MurmurHash3_x86_32 + FNV-1a over fixed-shape keys.

The port's copy of the framework's bit-exactness contract
(``tpubloom/ops/hashing.py`` holds the spec; the tests hold this module to
it and to the published vectors). The same arithmetic runs inside the CUDA
kernels (``tpubloom_torch/csrc/bloom_hash.cuh``); this module is what the
plain versions of those kernels, and the CPU tests, use.

Base hashes (u32 each)::

  h_a = murmur3_32(key, seed)
  h_b = murmur3_32(key, seed XOR 0x9E3779B9)      # golden ratio
  g_a = fnv1a_32(key)
  g_b = murmur3_32(key, seed XOR 0x85EBCA6B)      # murmur fmix constant

Unsigned 32-bit arithmetic: torch's ``uint32`` has no ``+``, ``>>`` or
``<<`` on the CPU, so every value here is an ``int64`` tensor holding a
u32 in its low 32 bits, masked with ``0xFFFFFFFF`` after each add, shift
and multiply. Multiplies by a 32-bit constant are split into 16-bit
halves so no intermediate leaves the int64 range.

Routing (the sharded filter array)::

  shard = murmur3_32(key, seed XOR 0x517CC1B7) mod n_shards

a true ``mod`` (n_shards need not be a power of two), independent of the
position hashes. A slot that holds shards ``[shard_lo, shard_lo +
shards_per_dev)`` owns a key when its shard falls in that range; padding
(``lengths < 0``) hashes as length 0 and is never owned.

The flat-layout ``positions``/``split_*`` helpers come with the flat
layout; the blocked layout needs only the base hashes.
"""

from __future__ import annotations

import dataclasses

import torch

# MurmurHash3_x86_32 constants (public domain algorithm by Austin Appleby).
_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_FMIX1 = 0x85EBCA6B
_FMIX2 = 0xC2B2AE35

# FNV-1a 32-bit constants.
_FNV_OFFSET = 0x811C9DC5
_FNV_PRIME = 0x01000193

# Seed derivation constants (part of the position spec above).
SEED_XOR_HB = 0x9E3779B9
SEED_XOR_GB = 0x85EBCA6B
SEED_XOR_ROUTE = 0x517CC1B7

M32 = 0xFFFFFFFF


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for an int64 tensor of u32 values and a u32
    constant, without leaving the int64 range."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    r = r % 32
    return ((x << r) | (x >> (32 - r))) & M32


def key_words(keys: torch.Tensor) -> torch.Tensor:
    """``uint8[..., L]`` -> int64 ``[..., L/4]`` little-endian u32 words."""
    L = keys.shape[-1]
    if L % 4 != 0:
        raise ValueError(f"key buffer length must be a multiple of 4, got {L}")
    b = keys.to(torch.int64).reshape(keys.shape[:-1] + (L // 4, 4))
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def murmur3_32(keys: torch.Tensor, lengths: torch.Tensor, seed: int) -> torch.Tensor:
    """MurmurHash3_x86_32 of each key.

    Args:
      keys: ``uint8[..., L]`` zero-padded key bytes, L a multiple of 4.
        Bytes at positions >= length MUST be zero (``pack_keys``
        guarantees this); they flow into the tail word, where zeros are
        exactly what the reference algorithm's partial tail load produces.
      lengths: integer ``[...]`` true byte lengths, 0 <= length <= L.
      seed: u32 seed.

    Returns:
      int64 ``[...]`` hashes in [0, 2^32), bit-exact with the canonical C
      implementation.
    """
    blocks = key_words(keys)
    lengths = lengths.to(torch.int64)
    h = torch.full(lengths.shape, int(seed) & M32, dtype=torch.int64, device=keys.device)
    for i in range(blocks.shape[-1]):
        kk = mul32(blocks[..., i], _C1)
        kk = rotl32(kk, 15)
        kk = mul32(kk, _C2)
        rem = lengths - 4 * i  # bytes of the key at/after this block
        # Full block: mix + rotate + scramble. Tail (1-3 bytes): mix only.
        h_full = (mul32(rotl32(h ^ kk, 13), 5) + 0xE6546B64) & M32
        h_tail = h ^ kk
        h = torch.where(rem >= 4, h_full, torch.where(rem > 0, h_tail, h))
    # Finalization.
    h = h ^ (lengths & M32)
    h = h ^ (h >> 16)
    h = mul32(h, _FMIX1)
    h = h ^ (h >> 13)
    h = mul32(h, _FMIX2)
    h = h ^ (h >> 16)
    return h


def fnv1a_32(keys: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """FNV-1a 32-bit of each key (same shape contract as :func:`murmur3_32`).
    The byte loop runs over the static buffer length and is masked by the
    true length, so padding bytes never enter the hash."""
    lengths = lengths.to(torch.int64)
    kb = keys.to(torch.int64)
    h = torch.full(lengths.shape, _FNV_OFFSET, dtype=torch.int64, device=keys.device)
    for j in range(keys.shape[-1]):
        h_next = mul32(h ^ kb[..., j], _FNV_PRIME)
        h = torch.where(j < lengths, h_next, h)
    return h


def base_hashes(
    keys: torch.Tensor, lengths: torch.Tensor, seed: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The four u32 base hashes ``(h_a, h_b, g_a, g_b)`` of the spec."""
    h_a = murmur3_32(keys, lengths, seed)
    h_b = murmur3_32(keys, lengths, seed ^ SEED_XOR_HB)
    g_a = fnv1a_32(keys, lengths)
    g_b = murmur3_32(keys, lengths, seed ^ SEED_XOR_GB)
    return h_a, h_b, g_a, g_b


def route_shards(
    keys: torch.Tensor, lengths: torch.Tensor, n_shards: int, seed: int
) -> torch.Tensor:
    """Owning shard of each key: int64 ``[...]`` in ``[0, n_shards)``.
    Negative lengths (padding) hash as length 0."""
    h = murmur3_32(keys, lengths.clamp(min=0), seed ^ SEED_XOR_ROUTE)
    return h % n_shards


@dataclasses.dataclass(frozen=True)
class ShardRoute:
    """The shards one slot of a sharded filter holds: ``shards_per_dev``
    shards from ``shard_lo`` on, out of ``n_shards``. The slot's state is
    those shards' block rows, shard-major: shard ``shard_lo + s`` is rows
    ``[s * n_blocks_per_shard, (s + 1) * n_blocks_per_shard)``."""

    n_shards: int
    shard_lo: int
    shards_per_dev: int


def route_local(
    keys: torch.Tensor, lengths: torch.Tensor, route: ShardRoute, seed: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(local_row, owned)``: each key's shard relative to the slot
    (int64, meaningful only where owned) and whether the slot owns it
    (False for padding)."""
    local = route_shards(keys, lengths, route.n_shards, seed) - route.shard_lo
    owned = (local >= 0) & (local < route.shards_per_dev) & (lengths >= 0)
    return local, owned
