"""A checkpoint payload's bytes and their CRC32C, from a filter's words.

:func:`payload_crc32c` turns a snapshot of a filter's state (``uint32``
words) into the payload of its checkpoint blob and the payload's CRC32C,
the two things ``tpubloom/checkpoint.py`` ``_serialize`` and ``_frame``
make on the host with numpy (``utils/packing.py`` ``words_to_redis_bitmap``
and ``utils/crc32c.py``):

* byte ``i`` of the payload is byte ``i`` of the little-endian words, with
  its bits reversed when ``bit_reverse`` is set (the flat bit filter's
  ``redis_bitmap`` format, the reference gem's SETBIT string), cut at
  ``nbytes`` (``ceil(m / 8)`` for a bitmap, ``4 n_words`` for raw words);
* the CRC is the standard Castagnoli one over those bytes (reflected
  polynomial 0x82F63B78, init and xorout 0xFFFFFFFF), what
  :func:`tpubloom_torch.utils.crc32c.crc32c` returns for them.

On the card it is one launch pair of ``tpubloom_torch/csrc/checksum.cu``
(a warp a run of 4 KiB chunks, then one CTA combining the runs' CRCs); on the
CPU, :func:`payload_crc32c_plain`, the same chunk-then-combine algorithm
in torch ops: vectorised over the chunks, looped over a chunk's 1024
words with four slicing-by-4 table lookups a word, and the chunks' raw
CRCs combined in Python. A CUDA tensor takes the kernel or raises.

CRC is linear on the raw register (zero init): ``raw(A || B) = raw(A)
x^(8|B|) mod P xor raw(B)``, and zero bytes in front of a chunk leave its
raw CRC unchanged, so a ragged last chunk is checksummed right-aligned
behind zeros. The standard CRC is ``~(raw(D) xor 0xFFFFFFFF x^(8|D|) mod
P)``: init and xorout are applied once, to the whole payload.

Every call on the card counts one launch pair in
``LAUNCHES["payload_crc32c"]`` (the plain version counts nothing).
"""

from __future__ import annotations

import ctypes
import functools
import math
import warnings

import numpy as np
import torch

from tpubloom_torch.ops import _build, sweep

POLY = 0x82F63B78  # reflected CRC32C polynomial
CHUNK = 4096  # bytes a chunk: a warp's on the card (tpb_checksum_chunk_bytes)
M32 = 0xFFFFFFFF

#: Launch pairs since the last :func:`reset_launch_counts` (CUDA only).
LAUNCHES: dict[str, int] = {"payload_crc32c": 0}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "tpb_checksum_chunk_bytes": ([], ctypes.c_int),
    "tpb_payload_crc32c": ([_P, _I64, _P, _P, _P, _I64, ctypes.c_int, _P], ctypes.c_int),
    "tpb_pinned_alloc": ([_I64, ctypes.POINTER(ctypes.c_void_p)], ctypes.c_int),
    "tpb_pinned_free": ([_P], ctypes.c_int),
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def _library() -> ctypes.CDLL:
    return _build.load_library("checksum", _SIGNATURES)


# -- GF(2) arithmetic mod P, reflected (bit 31 holds x^0) --------------------------


def gf2_mul(a: int, b: int) -> int:
    """``a * b mod P`` (zlib's ``multmodp``)."""
    p = 0
    for i in range(31, -1, -1):
        if (a >> i) & 1:
            p ^= b
        b = (b >> 1) ^ (POLY if b & 1 else 0)
    return p


@functools.lru_cache(maxsize=None)
def _x2n() -> tuple[int, ...]:
    """``x^(2^k) mod P`` for k < 64."""
    out = [0x40000000]  # x^1
    for _ in range(63):
        out.append(gf2_mul(out[-1], out[-1]))
    return tuple(out)


def shift_bytes(v: int, nbytes: int) -> int:
    """``v x^(8 nbytes) mod P``: a raw CRC register advanced through
    ``nbytes`` zero bytes."""
    x2n, bits, k = _x2n(), nbytes << 3, 0
    while bits:
        if bits & 1:
            v = gf2_mul(x2n[k], v)
        bits >>= 1
        k += 1
    return v


@functools.lru_cache(maxsize=None)
def _advance_chunk() -> tuple[tuple[int, ...], ...]:
    """Four 256-entry tables that advance a register through one chunk of
    zeros, a byte of the register each (the map is linear)."""
    k = shift_bytes(0x80000000, CHUNK)
    return tuple(tuple(gf2_mul(k, b << (8 * j)) for b in range(256)) for j in range(4))


@functools.lru_cache(maxsize=None)
def _byte_tables() -> np.ndarray:
    """Slicing tables: ``T[0]`` the byte table, ``T[j]`` a byte advanced
    through ``j`` more zero bytes."""
    t = np.zeros((4, 256), dtype=np.int64)
    for b in range(256):
        c = b
        for _ in range(8):
            c = (c >> 1) ^ (POLY if c & 1 else 0)
        t[0, b] = c
    for j in range(1, 4):
        t[j] = (t[j - 1] >> 8) ^ t[0][t[j - 1] & 0xFF]
    return t


def combine(raws: list[int], nbytes: int) -> int:
    """The standard CRC32C of a payload of ``nbytes`` bytes from its
    chunks' raw CRCs (zero init; every chunk ``CHUNK`` bytes but the last,
    which holds the rest)."""
    if nbytes == 0:
        return 0
    adv = _advance_chunk()
    raw, last = 0, nbytes - (len(raws) - 1) * CHUNK
    for v in raws[:-1]:
        raw = adv[0][raw & 0xFF] ^ adv[1][(raw >> 8) & 0xFF] ^ adv[2][(raw >> 16) & 0xFF] \
            ^ adv[3][raw >> 24] ^ v
    raw = shift_bytes(raw, last) ^ raws[-1]
    return ~(raw ^ shift_bytes(M32, nbytes)) & M32


# -- the plain version -------------------------------------------------------------


def _check(words: torch.Tensor, nbytes: int) -> torch.Tensor:
    if words.dtype not in (torch.uint32, torch.int32):
        raise TypeError(f"words must be uint32 (or its int32 view), got {words.dtype}")
    if words.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {words.device}")
    if nbytes < 0 or nbytes > 4 * words.numel():
        raise ValueError(f"nbytes={nbytes} outside the {4 * words.numel()} bytes of the words")
    return words.view(torch.int32).reshape(-1)


def reverse_bits_in_bytes(w32: torch.Tensor) -> torch.Tensor:
    """Each byte's bits reversed in place of an int32 tensor (the
    Redis-bitmap byte order of the flat bit filter's words)."""
    w = ((w32 >> 1) & 0x55555555) | ((w32 & 0x55555555) << 1)
    w = ((w >> 2) & 0x33333333) | ((w & 0x33333333) << 2)
    return ((w >> 4) & 0x0F0F0F0F) | ((w & 0x0F0F0F0F) << 4)


def payload_crc32c_plain(words: torch.Tensor, nbytes: int, bit_reverse: bool):
    """:func:`payload_crc32c` in torch ops, on the words' device:
    ``(uint8[nbytes] payload, crc)``."""
    w32 = _check(words, nbytes)
    if bit_reverse:
        w32 = reverse_bits_in_bytes(w32)
    payload = w32.view(torch.uint8)[:nbytes].clone()
    if nbytes == 0:
        return payload, 0
    n_chunks = math.ceil(nbytes / CHUNK)
    body = (n_chunks - 1) * CHUNK
    rows = torch.zeros(n_chunks * CHUNK, dtype=torch.uint8, device=payload.device)
    rows[:body] = payload[:body]
    rows[n_chunks * CHUNK - (nbytes - body):] = payload[body:]  # right-aligned behind zeros
    cols = rows.view(torch.int32).view(n_chunks, CHUNK // 4)
    t = torch.from_numpy(_byte_tables()).to(payload.device)
    crc = torch.zeros(n_chunks, dtype=torch.int64, device=payload.device)
    for i in range(CHUNK // 4):
        crc = crc ^ (cols[:, i].to(torch.int64) & M32)
        crc = t[3][crc & 0xFF] ^ t[2][(crc >> 8) & 0xFF] ^ t[1][(crc >> 16) & 0xFF] ^ t[0][crc >> 24]
    return payload, combine(crc.tolist(), nbytes)


# -- the kernel --------------------------------------------------------------------


def launch_payload_crc32c(words: torch.Tensor, nbytes: int, bit_reverse: bool):
    """One launch pair on the current stream of the words' CUDA device,
    without waiting: ``(uint8[nbytes] payload, int32[1] crc)`` on the
    card (the CRC's bits in an int32)."""
    w32 = _check(words, nbytes)
    if w32.device.type != "cuda":
        raise ValueError("launch_payload_crc32c takes a CUDA tensor")
    if not w32.is_contiguous() or w32.data_ptr() % 16:
        raise ValueError("the checksum kernel takes contiguous, 16-byte aligned words")
    payload = torch.empty(nbytes, dtype=torch.uint8, device=w32.device)
    crc = torch.zeros(1, dtype=torch.int32, device=w32.device)
    if nbytes == 0:
        return payload, crc
    lib = _library()
    chunk = lib.tpb_checksum_chunk_bytes()
    if chunk != CHUNK:
        raise RuntimeError(f"checksum.cu chunks {chunk} bytes, this module {CHUNK}")
    # a raw CRC a warp of the grid: at most the chunks rounded up to a CTA's 8 warps
    scratch = torch.empty(math.ceil(nbytes / CHUNK) + 8, dtype=torch.int32, device=w32.device)
    with torch.cuda.device(w32.device):
        stream = torch.cuda.current_stream(w32.device).cuda_stream
        err = lib.tpb_payload_crc32c(w32.data_ptr(), w32.numel(), payload.data_ptr(),
                                     scratch.data_ptr(), crc.data_ptr(), nbytes,
                                     1 if bit_reverse else 0, stream)
    sweep._raise_on(err, "payload_crc32c")
    LAUNCHES["payload_crc32c"] += 1
    return payload, crc


def payload_crc32c(words: torch.Tensor, nbytes: int, bit_reverse: bool):
    """``(payload, crc)``: ``uint8[nbytes]`` payload bytes of ``words``
    (each byte's bits reversed if ``bit_reverse``) on the words' device,
    and their CRC32C as an int. The kernel pair on a CUDA tensor, the
    plain version on a CPU one."""
    if words.device.type == "cpu":
        return payload_crc32c_plain(words, nbytes, bit_reverse)
    payload, crc = launch_payload_crc32c(words, nbytes, bit_reverse)
    return payload, int(crc.item()) & M32


def bytes_crc32c(data, device) -> int:
    """CRC32C of a bytes-like ``data`` computed on ``device`` (the kernel
    on a CUDA device, the plain version on the CPU): what a restore to the
    card checks a payload with. The bytes cross to the device once."""
    n = len(data)
    words = torch.empty(math.ceil(n / 4), dtype=torch.int32, device=device)
    view = words.view(torch.uint8)
    view[n:].zero_()
    if n:
        with warnings.catch_warnings():  # read-only bytes: only read here
            warnings.simplefilter("ignore", UserWarning)
            view[:n].copy_(torch.frombuffer(data, dtype=torch.uint8))
    return payload_crc32c(words, n, False)[1]


class PinnedBuffer:
    """A page-locked host buffer of ``nbytes`` (``cudaHostAlloc``), as a
    uint8 tensor and a numpy array over the same memory; freed by
    :meth:`free`, never by the caching allocator."""

    def __init__(self, nbytes: int):
        self.nbytes = nbytes
        ptr = ctypes.c_void_p()
        err = _library().tpb_pinned_alloc(max(nbytes, 1), ctypes.byref(ptr))
        if err:
            raise RuntimeError(f"cudaHostAlloc of {nbytes} bytes failed: CUDA error {err}")
        self._ptr = ptr.value
        raw = (ctypes.c_uint8 * max(nbytes, 1)).from_address(self._ptr)
        self.array = np.frombuffer(raw, dtype=np.uint8, count=nbytes)
        self.tensor = torch.from_numpy(self.array)

    def free(self) -> None:
        if self._ptr is not None:
            self.tensor = self.array = None
            err = _library().tpb_pinned_free(self._ptr)
            self._ptr = None
            if err:
                raise RuntimeError(f"cudaFreeHost failed: CUDA error {err}")
