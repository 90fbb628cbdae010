"""The CPU driver: a numpy bloom filter (plain and counting) and a blocked
one, on the exact position spec of :mod:`tpubloom_torch.ops.hashing` and
:mod:`tpubloom_torch.ops.blocked`.

The counterpart of ``tpubloom/cpu_ref.py``: the reference's ``:ruby``
driver (BASELINE config 1, "pure-Ruby driver (CPU ref)"), the client-side
implementation that defines the semantics, and the yardstick of the
baseline's "FPR drift vs CPU ref". The class name is the caller's request
for the host: nothing on a card path reaches these classes, and the card
filters never fall back to them. Their words have the bytes of the port's
filters of the same layout (``to_bytes`` / ``from_bytes`` cross between
them).

The hot loops run on the host C++ library (:mod:`tpubloom_torch.native`)
where it applies: ``use_native=None`` (default) takes it for plain
filters, ``False`` pins numpy (the tests hold the two bit for bit), and
``True`` on a counting filter raises. A failed build of the library
raises; nothing falls back to numpy.

This module imports numpy and the port's torch-free modules, never torch.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from tpubloom_torch import native
from tpubloom_torch.config import FilterConfig
from tpubloom_torch.utils.packing import pack_keys, redis_bitmap_to_words, words_to_redis_bitmap

# the seed derivation of the position spec (tpubloom_torch/ops/hashing.py,
# which imports torch)
SEED_XOR_HB = 0x9E3779B9
SEED_XOR_GB = 0x85EBCA6B

_C1 = np.uint32(0xCC9E2D51)
_C2 = np.uint32(0x1B873593)
_FNV_OFFSET = np.uint32(0x811C9DC5)
_FNV_PRIME = np.uint32(0x01000193)


def _rotl32(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def murmur3_32_np(keys: np.ndarray, lengths: np.ndarray, seed: int) -> np.ndarray:
    """Vectorized MurmurHash3_x86_32 — mirrors tpubloom_torch.ops.hashing.murmur3_32."""
    keys = np.asarray(keys, dtype=np.uint8)
    lengths = np.asarray(lengths, dtype=np.int32)
    L = keys.shape[-1]
    kb = keys.astype(np.uint32)
    blocks = (
        kb[..., 0::4]
        | (kb[..., 1::4] << np.uint32(8))
        | (kb[..., 2::4] << np.uint32(16))
        | (kb[..., 3::4] << np.uint32(24))
    )
    h = np.full(lengths.shape, np.uint32(seed), dtype=np.uint32)
    for i in range(L // 4):
        kk = blocks[..., i] * _C1
        kk = _rotl32(kk, 15)
        kk = kk * _C2
        rem = lengths - 4 * i
        h_full = _rotl32(h ^ kk, 13) * np.uint32(5) + np.uint32(0xE6546B64)
        h_tail = h ^ kk
        h = np.where(rem >= 4, h_full, np.where(rem > 0, h_tail, h))
    h = h ^ lengths.astype(np.uint32)
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    h = h ^ (h >> np.uint32(16))
    return h


def fnv1a_32_np(keys: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Vectorized FNV-1a 32 — mirrors tpubloom_torch.ops.hashing.fnv1a_32."""
    keys = np.asarray(keys, dtype=np.uint8)
    lengths = np.asarray(lengths, dtype=np.int32)
    L = keys.shape[-1]
    h = np.full(lengths.shape, _FNV_OFFSET, dtype=np.uint32)
    kb = keys.astype(np.uint32)
    for j in range(L):
        h_next = (h ^ kb[..., j]) * _FNV_PRIME
        h = np.where(j < lengths, h_next, h)
    return h


def positions_np(
    keys: np.ndarray, lengths: np.ndarray, *, m: int, k: int, seed: int
) -> np.ndarray:
    """The k positions per key as ``uint64[B, k]`` (exact spec arithmetic)."""
    h_a = murmur3_32_np(keys, lengths, seed).astype(np.uint64)
    if (m & (m - 1)) == 0:
        h_b = murmur3_32_np(keys, lengths, seed ^ SEED_XOR_HB).astype(np.uint64)
        g_a = fnv1a_32_np(keys, lengths).astype(np.uint64)
        g_b = murmur3_32_np(keys, lengths, seed ^ SEED_XOR_GB).astype(np.uint64)
        H1 = (h_b << np.uint64(32)) | h_a
        H2 = ((g_b << np.uint64(32)) | g_a) | np.uint64(1)
        i = np.arange(k, dtype=np.uint64)
        with np.errstate(over="ignore"):
            pos = H1[..., None] + i * H2[..., None]  # u64 wrap == mod 2^64
        return pos & np.uint64(m - 1)
    if m >= (1 << 31):
        raise ValueError("non-power-of-two m must be < 2^31")
    g_a = fnv1a_32_np(keys, lengths) | np.uint32(1)
    i = np.arange(k, dtype=np.uint32)
    with np.errstate(over="ignore"):
        pos32 = h_a.astype(np.uint32)[..., None] + i * g_a[..., None]
    return (pos32 % np.uint32(m)).astype(np.uint64)


def blocked_positions_np(
    keys: np.ndarray,
    lengths: np.ndarray,
    *,
    n_blocks: int,
    block_bits: int,
    k: int,
    seed: int,
    block_hash: str = "ap",
) -> tuple[np.ndarray, np.ndarray]:
    """Blocked-spec coordinates (mirrors tpubloom_torch.ops.blocked.block_positions,
    both in-block variants): returns ``(blk int64[B], bit uint32[B, k])``."""
    h_a = murmur3_32_np(keys, lengths, seed)
    g_a = fnv1a_32_np(keys, lengths)
    g_b = murmur3_32_np(keys, lengths, seed ^ SEED_XOR_GB)
    blk = (h_a & np.uint32(n_blocks - 1)).astype(np.int64)
    mask = np.uint32(block_bits - 1)
    if block_hash == "chunk":
        nb = (block_bits - 1).bit_length()
        if k * nb > 96:
            raise ValueError(
                f"chunk in-block hash needs k*log2(block_bits) <= 96 "
                f"(k={k}, {nb} bits/position)"
            )
        h_b = murmur3_32_np(keys, lengths, seed ^ SEED_XOR_HB)
        pool = (h_b, g_a, g_b)
        cols = []
        for i in range(k):
            sh = i * nb
            w, off = sh >> 5, sh & 31
            v = pool[w] >> np.uint32(off)
            if off + nb > 32:
                v = v | (pool[w + 1] << np.uint32(32 - off))
            cols.append(v & mask)
        return blk, np.stack(cols, axis=-1)
    if block_hash != "ap":
        raise ValueError(f"block_hash must be 'chunk' or 'ap', got {block_hash!r}")
    stride = g_b | np.uint32(1)
    i = np.arange(k, dtype=np.uint32)
    with np.errstate(over="ignore"):
        p = g_a[..., None] + i * stride[..., None]  # u32 wrap == mod 2^32
    return blk, p & mask


class _CPUFilter:
    """What the two CPU classes share: packing, the scalar forms, clear,
    and the raw little-endian words (``to_bytes`` / ``from_bytes``, the
    bytes of the port's filter of the same layout)."""

    config: FilterConfig
    words: np.ndarray

    def _pack(self, keys: Sequence[bytes | str]) -> tuple[np.ndarray, np.ndarray]:
        return pack_keys(keys, self.config.key_len, key_policy=self.config.key_policy)

    def insert(self, key: bytes | str) -> None:
        self.insert_batch([key])

    def include(self, key: bytes | str) -> bool:
        return bool(self.include_batch([key])[0])

    def clear(self) -> None:
        self.words[:] = 0
        self.n_inserted = 0

    def _set_words(self, words) -> None:
        """Replace storage from a flat array (checkpoint restore)."""
        self.words = (
            np.asarray(words, dtype=np.uint32).reshape(self.words.shape).copy()
        )

    def _popcount(self) -> int:
        return int(np.unpackbits(self.words.view(np.uint8)).sum())

    def to_bytes(self) -> bytes:
        return self.words.astype("<u4").tobytes()

    @classmethod
    def from_bytes(cls, config: FilterConfig, data: bytes):
        f = cls(config)
        f._set_words(np.frombuffer(data, dtype="<u4"))
        return f


class CPUBlockedBloomFilter(_CPUFilter):
    """The CPU driver for the blocked layout (the spec of
    :mod:`tpubloom_torch.ops.blocked`); ``words`` is ``uint32[NB, W]``."""

    def __init__(self, config: FilterConfig, *, use_native: bool | None = None):
        if not config.block_bits:
            config = config.replace(block_bits=512)
        self.config = config
        self.n_inserted = 0
        self.use_native = True if use_native is None else use_native
        if self.use_native:
            native.available()
        self.words = np.zeros(
            (config.n_blocks, config.words_per_block), dtype=np.uint32
        )

    def _spec_kwargs(self) -> dict:
        # the one definition of the blocked-spec parameter set, shared by
        # the native dispatch and the NumPy path
        return dict(
            n_blocks=self.config.n_blocks,
            block_bits=self.config.block_bits,
            k=self.config.k,
            seed=self.config.seed,
            block_hash=self.config.block_hash,
        )

    def _coords(self, keys_u8: np.ndarray, lengths: np.ndarray):
        blk, bit = blocked_positions_np(keys_u8, lengths, **self._spec_kwargs())
        word = (bit >> np.uint32(5)).astype(np.int64)
        mask = np.uint32(1) << (bit & np.uint32(31))
        return blk, word, mask

    def insert_batch(self, keys: Sequence[bytes | str]) -> None:
        keys_u8, lengths = self._pack(keys)
        if self.use_native:
            native.blocked_insert(self.words, keys_u8, lengths, **self._spec_kwargs())
        else:
            blk, word, mask = self._coords(keys_u8, lengths)
            k = self.config.k
            np.bitwise_or.at(
                self.words, (np.repeat(blk, k), word.ravel()), mask.ravel()
            )
        self.n_inserted += len(keys)

    def include_batch(self, keys: Sequence[bytes | str]) -> np.ndarray:
        keys_u8, lengths = self._pack(keys)
        if self.use_native:
            return native.blocked_query(
                self.words, keys_u8, lengths, **self._spec_kwargs()
            ).astype(bool)
        blk, word, mask = self._coords(keys_u8, lengths)
        vals = self.words[blk[:, None], word]
        return np.all((vals & mask) == mask, axis=-1)

    def fill_ratio(self) -> float:
        return self._popcount() / self.config.m


class CPUBloomFilter(_CPUFilter):
    """The CPU driver for the flat layout, plain or counting (4-bit
    saturating counters): the reference front-end's ``insert`` /
    ``include`` / ``clear`` and the batch forms. ``words`` is
    ``uint32[n_words]`` (bits) or ``uint32[n_counter_words]`` (counters)."""

    def __init__(self, config: FilterConfig, *, use_native: bool | None = None):
        """``use_native=None`` (default) takes the C++ hot path for plain
        filters; False pins numpy; True on a counting filter raises."""
        self.config = config
        self.n_inserted = 0
        if use_native is None:
            use_native = not config.counting
        if use_native and config.counting:
            raise ValueError("native path covers plain filters only")
        self.use_native = use_native
        if use_native:
            native.available()
        if config.counting:
            self.words = np.zeros(config.n_counter_words, dtype=np.uint32)
        else:
            self.words = np.zeros(config.n_words, dtype=np.uint32)

    def _positions(self, keys_u8: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        return positions_np(
            keys_u8, lengths, m=self.config.m, k=self.config.k, seed=self.config.seed
        )

    # -- plain-filter ops ---------------------------------------------------

    def insert_batch(self, keys: Sequence[bytes | str]) -> None:
        keys_u8, lengths = self._pack(keys)
        if self.use_native:
            native.hash_insert(
                self.words, keys_u8, lengths,
                m=self.config.m, k=self.config.k, seed=self.config.seed,
            )
        else:
            pos = self._positions(keys_u8, lengths).ravel()
            if self.config.counting:
                self._counter_add(pos, +1)
            else:
                word = (pos >> np.uint64(5)).astype(np.int64)
                bit = (pos & np.uint64(31)).astype(np.uint32)
                np.bitwise_or.at(self.words, word, np.uint32(1) << bit)
        self.n_inserted += len(keys)

    def include_batch(self, keys: Sequence[bytes | str]) -> np.ndarray:
        keys_u8, lengths = self._pack(keys)
        if self.use_native:
            return native.hash_query(
                self.words, keys_u8, lengths,
                m=self.config.m, k=self.config.k, seed=self.config.seed,
            ).astype(bool)
        pos = self._positions(keys_u8, lengths)
        if self.config.counting:
            vals = self._counter_get(pos)
            return np.all(vals > 0, axis=-1)
        word = (pos >> np.uint64(5)).astype(np.int64)
        bit = (pos & np.uint64(31)).astype(np.uint32)
        hits = (self.words[word] >> bit) & np.uint32(1)
        return np.all(hits == 1, axis=-1)

    # -- counting-filter ops ------------------------------------------------

    def delete_batch(self, keys: Sequence[bytes | str]) -> None:
        if not self.config.counting:
            raise ValueError("delete requires a counting filter")
        keys_u8, lengths = self._pack(keys)
        pos = self._positions(keys_u8, lengths).ravel()
        self._counter_add(pos, -1)
        self.n_inserted = max(0, self.n_inserted - len(keys))

    def delete(self, key: bytes | str) -> None:
        self.delete_batch([key])

    def _counter_add(self, pos: np.ndarray, delta: int) -> None:
        """Saturating nibble add / sub, one ``delta`` a position: the
        sequential semantics of ``tpubloom``'s loop (increments saturate
        at 15, decrements floor at 0), which for one sign a call is a
        counter's pre-batch value plus its multiplicity, clipped to
        [0, 15]; each counter's change lands in its word by one add."""
        pos, cnt = np.unique(pos, return_counts=True)
        word = (pos >> np.uint64(3)).astype(np.int64)
        shift = (np.uint64(4) * (pos & np.uint64(7))).astype(np.int64)
        cur = (self.words[word].astype(np.int64) >> shift) & 15
        new = np.clip(cur + delta * cnt.astype(np.int64), 0, 15)
        # a nibble's new value is in [0, 15], so its change never carries
        # into a neighbour: the adds wrap mod 2^32 as the word's bits do
        np.add.at(self.words, word, (((new - cur) << shift) & 0xFFFFFFFF).astype(np.uint32))

    def _counter_get(self, pos: np.ndarray) -> np.ndarray:
        word = (pos >> np.uint64(3)).astype(np.int64)
        nib = (pos & np.uint64(7)).astype(np.uint32)
        return (self.words[word] >> (np.uint32(4) * nib)) & np.uint32(15)

    # -- introspection / persistence ----------------------------------------

    def fill_ratio(self) -> float:
        if self.config.counting:
            raise ValueError("fill_ratio is for plain filters")
        return self._popcount() / self.config.m

    def estimated_fpr(self) -> float:
        return self.fill_ratio() ** self.config.k

    def to_redis_bitmap(self) -> bytes:
        if self.config.counting:
            raise ValueError("Redis bitmap export is for plain filters")
        return words_to_redis_bitmap(self.words, self.config.m)

    @classmethod
    def from_redis_bitmap(cls, config: FilterConfig, data: bytes) -> "CPUBloomFilter":
        f = cls(config)
        f.words = redis_bitmap_to_words(data, config.m)
        return f
