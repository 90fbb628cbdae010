"""ctypes bindings of the host C++ library ``native/bloomhash.cpp``.

The counterpart of ``tpubloom/native``: the same functions, names and
signatures over the port's copy of the library. The library is built by
``g++`` at first use, never at import (:mod:`tpubloom_torch.ops._build`,
into the git-ignored ``_build/``). There is no quiet fallback: where the
native path is asked for or chosen, a failed build raises with the
compiler's log, and nothing takes numpy instead.

Every wrapper checks the arrays it hands to C (dtype, contiguity, shape)
before it passes a pointer.
"""

from __future__ import annotations

import ctypes

import numpy as np

from tpubloom_torch.ops import _build

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_i32, _i64, _u32, _u64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint64

#: ``{symbol: (argtypes, restype)}`` of every C function of the library
SIGNATURES = {
    "bh_murmur3_batch": ([_u8p, _i32p, _i64, _i32, _u32, _u32p], None),
    "bh_fnv1a_batch": ([_u8p, _i32p, _i64, _i32, _u32p], None),
    "bh_positions": ([_u8p, _i32p, _i64, _i32, _u64, _i32, _u32, _u64p], None),
    "bh_insert": ([_u32p, _u64p, _i64], None),
    "bh_query": ([_u32p, _u64p, _i64, _i32, _u8p], None),
    "bh_hash_insert": ([_u32p, _u8p, _i32p, _i64, _i32, _u64, _i32, _u32], None),
    "bh_hash_query": ([_u32p, _u8p, _i32p, _i64, _i32, _u64, _i32, _u32, _u8p], None),
    "bh_blocked_insert": ([_u32p, _u8p, _i32p, _i64, _i32, _u64, _i32, _i32, _u32, _i32], None),
    "bh_blocked_query": ([_u32p, _u8p, _i32p, _i64, _i32, _u64, _i32, _i32, _u32, _i32, _u8p],
                         None),
    "bh_pack": ([_u8p, _i32p, _i64, _i32, _u8p], None),
}

#: the most positions a key the blocked loops hold (``uint32_t bits[64]``)
MAX_K = 64


def _lib() -> ctypes.CDLL:
    return _build.load_library("bloomhash", SIGNATURES)


def available() -> bool:
    """Build (if needed) and load the library: True once it is loaded. A
    failed build raises with ``g++``'s output; this never answers False."""
    _lib()
    return True


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _keys(keys: np.ndarray, lens: np.ndarray) -> tuple[np.ndarray, np.ndarray, int, int]:
    keys = np.ascontiguousarray(keys, dtype=np.uint8)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    if keys.ndim != 2 or lens.shape != (keys.shape[0],):
        raise ValueError(f"bad shapes: keys {keys.shape}, lens {lens.shape}")
    B, L = keys.shape
    if B and (int(lens.min()) < 0 or int(lens.max()) > L):
        raise ValueError(f"lens must be in [0, {L}]; got [{int(lens.min())}, {int(lens.max())}]")
    return keys, lens, B, L


def _words(words: np.ndarray, n_words: int) -> None:
    """The state the C loops write in place: C-contiguous ``uint32`` of
    ``n_words`` words (no copy may stand in for it)."""
    if not (isinstance(words, np.ndarray) and words.dtype == np.uint32
            and words.flags.c_contiguous and words.size == n_words):
        raise ValueError(f"words must be a C-contiguous uint32 array of {n_words} words")


def _check_k(k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")


def murmur3_batch(keys: np.ndarray, lens: np.ndarray, seed: int) -> np.ndarray:
    keys, lens, B, L = _keys(keys, lens)
    out = np.empty(B, dtype=np.uint32)
    _lib().bh_murmur3_batch(_ptr(keys, ctypes.c_uint8), _ptr(lens, ctypes.c_int32), B, L,
                            _u32(seed), _ptr(out, ctypes.c_uint32))
    return out


def fnv1a_batch(keys: np.ndarray, lens: np.ndarray) -> np.ndarray:
    keys, lens, B, L = _keys(keys, lens)
    out = np.empty(B, dtype=np.uint32)
    _lib().bh_fnv1a_batch(_ptr(keys, ctypes.c_uint8), _ptr(lens, ctypes.c_int32), B, L,
                          _ptr(out, ctypes.c_uint32))
    return out


def positions_batch(keys: np.ndarray, lens: np.ndarray, *, m: int, k: int, seed: int) -> np.ndarray:
    keys, lens, B, L = _keys(keys, lens)
    out = np.empty((B, k), dtype=np.uint64)
    _lib().bh_positions(_ptr(keys, ctypes.c_uint8), _ptr(lens, ctypes.c_int32), B, L,
                        _u64(m), k, _u32(seed), _ptr(out, ctypes.c_uint64))
    return out


def _flat_words(m: int) -> int:
    return (m + 31) // 32


def hash_insert(words: np.ndarray, keys: np.ndarray, lens: np.ndarray, *, m: int, k: int,
                seed: int) -> None:
    """Fused flat-spec insert into ``uint32[ceil(m / 32)]`` (in place)."""
    _words(words, _flat_words(m))
    keys, lens, B, L = _keys(keys, lens)
    _lib().bh_hash_insert(_ptr(words, ctypes.c_uint32), _ptr(keys, ctypes.c_uint8),
                          _ptr(lens, ctypes.c_int32), B, L, _u64(m), k, _u32(seed))


def hash_query(words: np.ndarray, keys: np.ndarray, lens: np.ndarray, *, m: int, k: int,
               seed: int) -> np.ndarray:
    _words(words, _flat_words(m))
    keys, lens, B, L = _keys(keys, lens)
    out = np.empty(B, dtype=np.uint8)
    _lib().bh_hash_query(_ptr(words, ctypes.c_uint32), _ptr(keys, ctypes.c_uint8),
                         _ptr(lens, ctypes.c_int32), B, L, _u64(m), k, _u32(seed),
                         _ptr(out, ctypes.c_uint8))
    return out


def _check_chunk_pool(block_bits: int, k: int, block_hash: str) -> None:
    """The chunk spec slices k positions out of the 96-bit (h_b, g_a, g_b)
    pool; the C++ side indexes the pool unchecked, so validate here as
    ``cpu_ref.blocked_positions_np`` and ``FilterConfig`` do."""
    if block_hash == "chunk":
        nb = (block_bits - 1).bit_length()
        if k * nb > 96:
            raise ValueError(
                f"block_hash='chunk' needs k*log2(block_bits) <= 96 "
                f"(k={k}, {nb} bits/position) — use 'ap'"
            )


def _blocked(words, keys, lens, n_blocks, block_bits, k, block_hash):
    _check_chunk_pool(block_bits, k, block_hash)
    _check_k(k)
    _words(words, n_blocks * (block_bits // 32))
    return _keys(keys, lens)


def blocked_insert(words: np.ndarray, keys: np.ndarray, lens: np.ndarray, *, n_blocks: int,
                   block_bits: int, k: int, seed: int, block_hash: str = "ap") -> None:
    """Fused blocked-spec insert into ``uint32[n_blocks, W]`` (in place)."""
    keys, lens, B, L = _blocked(words, keys, lens, n_blocks, block_bits, k, block_hash)
    _lib().bh_blocked_insert(_ptr(words, ctypes.c_uint32), _ptr(keys, ctypes.c_uint8),
                             _ptr(lens, ctypes.c_int32), B, L, _u64(n_blocks), block_bits, k,
                             _u32(seed), int(block_hash == "chunk"))


def blocked_query(words: np.ndarray, keys: np.ndarray, lens: np.ndarray, *, n_blocks: int,
                  block_bits: int, k: int, seed: int, block_hash: str = "ap") -> np.ndarray:
    keys, lens, B, L = _blocked(words, keys, lens, n_blocks, block_bits, k, block_hash)
    out = np.empty(B, dtype=np.uint8)
    _lib().bh_blocked_query(_ptr(words, ctypes.c_uint32), _ptr(keys, ctypes.c_uint8),
                            _ptr(lens, ctypes.c_int32), B, L, _u64(n_blocks), block_bits, k,
                            _u32(seed), int(block_hash == "chunk"), _ptr(out, ctypes.c_uint8))
    return out


def pack_joined(joined: bytes, lens: np.ndarray, key_len: int) -> np.ndarray:
    """Scatter a concatenated key buffer into a zero-padded
    ``uint8[B, key_len]`` matrix (the C++ ingest hot loop)."""
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    B = lens.shape[0]
    if B:
        if int(lens.min()) < 0 or int(lens.max()) > key_len:
            raise ValueError(
                f"lens must be in [0, key_len={key_len}]; "
                f"got [{int(lens.min())}, {int(lens.max())}]"
            )
        if int(lens.sum()) != len(joined):
            raise ValueError(
                f"joined buffer is {len(joined)} bytes but lens sum to "
                f"{int(lens.sum())}"
            )
    out = np.zeros((B, key_len), dtype=np.uint8)
    src = np.frombuffer(joined, dtype=np.uint8)
    _lib().bh_pack(_ptr(src, ctypes.c_uint8), _ptr(lens, ctypes.c_int32), B, key_len,
                   _ptr(out, ctypes.c_uint8))
    return out
