"""Host-side key packing: variable-length keys -> fixed-shape arrays.

A framework-free copy of the key-packing half of
``tpubloom/utils/packing.py``. Key packing turns variable-length
byte-string keys into the ``uint8[B, L]`` + ``int32[B]`` arrays the hash
kernels consume; bytes past a key's length are zero (the hash-kernel
contract). The Redis-bitmap conversions belong to the flat layout and
come with it.

Where ``tpubloom`` takes a C++ fast path for all-``bytes`` batches, this
copy takes a vectorized NumPy one (one join plus one masked scatter); both
produce the same bytes as the per-key loop.
"""

from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np


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
            out = np.zeros((B, key_len), dtype=np.uint8)
            mask = np.arange(key_len, dtype=np.int32)[None, :] < lens[:, None]
            out[mask] = np.frombuffer(b"".join(keys), dtype=np.uint8)
            return out, lens
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
