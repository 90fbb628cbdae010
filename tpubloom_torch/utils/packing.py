"""Host-side key packing: variable-length keys -> fixed-shape arrays.

A framework-free copy of ``tpubloom/utils/packing.py``. Key packing turns
variable-length byte-string keys into the ``uint8[B, L]`` + ``int32[B]``
arrays the hash kernels consume; bytes past a key's length are zero (the
hash-kernel contract). The Redis-bitmap conversions carry the flat
layout's words to and from the reference gem's string bitmaps.

An all-``bytes`` batch within ``key_len`` takes a fast path, one join
plus one scatter, as in ``tpubloom``: the scatter is the host library's
``native.pack_joined`` (C++), and :func:`scatter_joined` is its plain
numpy version, which the tests hold it to. Both produce the same bytes as
the per-key loop.
"""

from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np

from tpubloom_torch import native

_BIT_REVERSE = np.array(
    [int(f"{i:08b}"[::-1], 2) for i in range(256)], dtype=np.uint8
)


def pack_keys(
    keys: Sequence[bytes | str],
    key_len: int,
    *,
    key_policy: str = "error",
) -> tuple[np.ndarray, np.ndarray]:
    """Pack keys into zero-padded ``uint8[B, key_len]`` + ``int32[B]`` lengths.

    str keys are UTF-8 encoded. Keys longer than ``key_len`` either raise
    (``key_policy='error'``) or are replaced by their 16-byte BLAKE2b digest
    (``key_policy='digest'`` — requires ``key_len >= 16``); the digest is
    deterministic, so filter semantics are preserved up to digest collisions.
    """
    if key_policy == "digest" and key_len < 16:
        raise ValueError("key_policy='digest' requires key_len >= 16")
    B = len(keys)
    if B and all(type(k) is bytes for k in keys):
        lens = np.fromiter((len(k) for k in keys), dtype=np.int32, count=B)
        if int(lens.max()) <= key_len:
            return native.pack_joined(b"".join(keys), lens, key_len), lens
    out = np.zeros((B, key_len), dtype=np.uint8)
    lens = np.zeros((B,), dtype=np.int32)
    for i, key in enumerate(keys):
        if isinstance(key, str):
            key = key.encode("utf-8")
        elif not isinstance(key, (bytes, bytearray, memoryview)):
            raise TypeError(f"key {i} must be bytes or str, got {type(key)}")
        kb = bytes(key)
        if len(kb) > key_len:
            if key_policy == "error":
                raise ValueError(
                    f"key {i} is {len(kb)} bytes > key_len={key_len}; "
                    "use key_policy='digest' or raise key_len"
                )
            kb = hashlib.blake2b(kb, digest_size=16).digest()
        out[i, : len(kb)] = np.frombuffer(kb, dtype=np.uint8)
        lens[i] = len(kb)
    return out, lens


def scatter_joined(joined: bytes, lens: np.ndarray, key_len: int) -> np.ndarray:
    """The plain numpy version of ``native.pack_joined``: the keys of a
    concatenated buffer, one a row of a zero-padded ``uint8[B, key_len]``
    matrix (one masked scatter)."""
    out = np.zeros((lens.shape[0], key_len), dtype=np.uint8)
    mask = np.arange(key_len, dtype=np.int32)[None, :] < lens[:, None]
    out[mask] = np.frombuffer(joined, dtype=np.uint8)
    return out


def pack_keys_dense(keys: np.ndarray, lengths: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Validate an already-packed (keys, lengths) pair and zero the padding.

    Accepts ``uint8[B, L]`` + integer lengths; returns arrays with every byte
    at position >= length forced to zero (the hash-kernel contract).
    """
    keys = np.ascontiguousarray(keys, dtype=np.uint8)
    lengths = np.asarray(lengths, dtype=np.int32)
    if keys.ndim != 2 or lengths.shape != (keys.shape[0],):
        raise ValueError(f"bad shapes: keys {keys.shape}, lengths {lengths.shape}")
    mask = np.arange(keys.shape[1], dtype=np.int32)[None, :] < lengths[:, None]
    return np.where(mask, keys, 0).astype(np.uint8), lengths


def words_to_redis_bitmap(words: np.ndarray, m: int) -> bytes:
    """Serialize a packed ``uint32`` bit array to Redis SETBIT byte order.

    Bit ``pos`` of the array (bit ``pos & 31``, LSB-first, of word ``pos
    >> 5``) is bit ``7 - (pos & 7)`` of byte ``pos >> 3``: exactly the
    string value the reference's ``:ruby`` driver would have produced by
    SETBIT-ing the same positions, cut to ``ceil(m / 8)`` bytes."""
    le = np.ascontiguousarray(words, dtype=np.uint32).astype("<u4", copy=False)
    return _BIT_REVERSE[le.reshape(-1).view(np.uint8)[: (m + 7) // 8]].tobytes()


def redis_bitmap_to_words(data: bytes, m: int) -> np.ndarray:
    """Parse a Redis string bitmap back into the packed ``uint32[(m + 31)
    // 32]`` array (bytes past ``ceil(m / 8)`` are ignored, missing ones
    are zero)."""
    n_words = (m + 31) // 32
    buf = np.zeros(n_words * 4, dtype=np.uint8)
    nbytes = min(len(data), (m + 7) // 8)
    buf[:nbytes] = np.frombuffer(data, dtype=np.uint8, count=nbytes)
    return _BIT_REVERSE[buf].view("<u4").astype(np.uint32, copy=False)
