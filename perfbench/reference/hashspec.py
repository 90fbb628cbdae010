"""The filter's hash and position spec, frozen for the benchmark, in plain
PyTorch: the yardstick's own copy, so that a later change to the program
cannot move it.

Keys are ``uint8[B, L]`` (L a multiple of 4, bytes past a key's length
zero) with ``int`` lengths ``[B]``; a negative length marks padding, which
hashes as length 0 and is never valid. Every value is an ``int64`` tensor
holding an unsigned 32-bit number, masked after each add, shift and
multiply, so the same code runs on the CPU and on the card.

Base hashes::

  h_a = murmur3_32(key, seed)
  h_b = murmur3_32(key, seed ^ 0x9E3779B9)
  g_a = fnv1a_32(key)
  g_b = murmur3_32(key, seed ^ 0x85EBCA6B)

Blocked layout (``n_blocks = m / block_bits``, both powers of two): the key's
row is ``h_a mod n_blocks``; its k in-block bits are, for ``chunk``, the
``log2(block_bits)``-bit slices ``i·log2(block_bits)`` of the 96-bit pool
``h_b | g_a << 32 | g_b << 64``, and for ``ap`` ``(g_a + i·(g_b | 1)) mod
2^32 mod block_bits``. Global bit ``row · block_bits + bit``.

Flat layout: m a power of two, the 64-bit walk ``(h_b, h_a) + i·(g_b, g_a |
1) mod 2^64`` masked to ``m - 1``; any other m (< 2^31) ``(h_a + i·(g_a | 1)
mod 2^32) mod m``.

Bit ``p`` of a filter is bit ``p mod 8`` (least significant first) of byte
``p div 8`` of its state: the little-endian bytes of its ``uint32`` words.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
SEED_XOR_HB = 0x9E3779B9
SEED_XOR_GB = 0x85EBCA6B


def _mul(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x · c mod 2^32`` for u32 values ``x`` and a u32 constant, in two
    16-bit halves of ``c`` so that nothing leaves the int64 range."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def murmur3_32(keys: torch.Tensor, lengths: torch.Tensor, seed: int) -> torch.Tensor:
    """MurmurHash3_x86_32 of each key (Austin Appleby's public-domain
    algorithm)."""
    n = lengths.clamp(min=0).to(torch.int64)
    b = keys.to(torch.int64)
    h = torch.full(n.shape, seed & M32, dtype=torch.int64, device=keys.device)
    for i in range(keys.shape[1] // 4):
        w = b[:, 4 * i] | (b[:, 4 * i + 1] << 8) | (b[:, 4 * i + 2] << 16) | (b[:, 4 * i + 3] << 24)
        kk = _mul(_rotl(_mul(w, 0xCC9E2D51), 15), 0x1B873593)
        left = n - 4 * i
        mixed = (_mul(_rotl(h ^ kk, 13), 5) + 0xE6546B64) & M32
        h = torch.where(left >= 4, mixed, torch.where(left > 0, h ^ kk, h))
    h = h ^ (n & M32)
    h = _mul(h ^ (h >> 16), 0x85EBCA6B)
    h = _mul(h ^ (h >> 13), 0xC2B2AE35)
    return h ^ (h >> 16)


def fnv1a_32(keys: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """FNV-1a, 32 bits, over each key's first ``length`` bytes."""
    n = lengths.clamp(min=0).to(torch.int64)
    b = keys.to(torch.int64)
    h = torch.full(n.shape, 0x811C9DC5, dtype=torch.int64, device=keys.device)
    for j in range(keys.shape[1]):
        h = torch.where(n > j, _mul(h ^ b[:, j], 0x01000193), h)
    return h


def blocked_bits(keys, lengths, *, m: int, k: int, seed: int, block_bits: int,
                 block_hash: str) -> torch.Tensor:
    """The k global bit indices of each key in a blocked filter: int64
    ``[B, k]``."""
    nb_log2 = block_bits.bit_length() - 1
    row = murmur3_32(keys, lengths, seed) & ((m // block_bits) - 1)
    g_a = fnv1a_32(keys, lengths)
    g_b = murmur3_32(keys, lengths, seed ^ SEED_XOR_GB)
    bits = []
    if block_hash == "chunk":
        if k * nb_log2 > 96:
            raise ValueError(f"chunk needs k·log2(block_bits) <= 96, got k={k}, {nb_log2}")
        pool = (murmur3_32(keys, lengths, seed ^ SEED_XOR_HB), g_a, g_b)
        for i in range(k):
            w, off = divmod(i * nb_log2, 32)
            v = pool[w] >> off
            if off + nb_log2 > 32:
                v = v | ((pool[w + 1] << (32 - off)) & M32)
            bits.append(v & (block_bits - 1))
    elif block_hash == "ap":
        p, stride = g_a, g_b | 1
        for i in range(k):
            bits.append(p & (block_bits - 1))
            p = (p + stride) & M32
    else:
        raise ValueError(f"block_hash must be chunk or ap, got {block_hash!r}")
    return row[:, None] * block_bits + torch.stack(bits, dim=1)


def flat_bits(keys, lengths, *, m: int, k: int, seed: int) -> torch.Tensor:
    """The k bit indices of each key in a flat filter: int64 ``[B, k]``."""
    h_a = murmur3_32(keys, lengths, seed)
    g_a = fnv1a_32(keys, lengths) | 1
    out = []
    if m & (m - 1) == 0:
        if m > 1 << 36:
            raise ValueError("a power-of-two m is at most 2^36")
        hi, lo = murmur3_32(keys, lengths, seed ^ SEED_XOR_HB), h_a
        g_b = murmur3_32(keys, lengths, seed ^ SEED_XOR_GB)
        for i in range(k):
            out.append(((hi << 32) | lo) & (m - 1))
            nxt = (lo + g_a) & M32
            hi = (hi + g_b + (nxt < lo).to(torch.int64)) & M32
            lo = nxt
    else:
        if m >= 1 << 31:
            raise ValueError("an m that is not a power of two is below 2^31")
        p = h_a
        for i in range(k):
            out.append(p % m)
            p = (p + g_a) & M32
    return torch.stack(out, dim=1)
