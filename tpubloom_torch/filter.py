"""The port's front-end classes on PyTorch: BloomFilter and
CountingBloomFilter (the flat, Redis-bitmap-compatible layout),
BlockedBloomFilter and BlockedCountingBloomFilter.

The same surfaces as their namesakes in ``tpubloom.filter``:
``insert_batch`` (optionally test-and-insert, blocked bit filter only),
``include_batch``, the fixed-width ``insert_packed`` / ``include_packed``,
the staged ``stage_batch`` / ``launch_insert`` / ``launch_query`` API, the
device-array ``insert_arrays`` / ``include_arrays``, ``clear``,
``words_logical``, ``to_bytes`` / ``from_bytes`` and ``stats``; the bit
filters add ``fill_ratio`` and its FPR gauges, the counting filters
``delete_batch`` / ``delete``, and the flat bit filter
``to_redis_bitmap`` / ``from_redis_bitmap``.

Device: the filter lives on the CUDA card unless the caller passes
``device="cpu"``; without a card and without that argument the
constructor raises. On the card every insert and query runs the
hand-written kernels (:mod:`tpubloom_torch.ops.sweep`); on the CPU their
plain versions.

Storage: a blocked filter's ``self.words`` is ``uint32[NB·W/128, 128]``
(the fat view of ``tpubloom.filter.blocked_device_shape``; the logical
``[NB, W]`` where the fat view does not divide), a flat filter's
``uint32[n_words]`` (bits) or ``uint32[n_counter_words]`` (4-bit
counters), with the same bytes as ``tpubloom``'s. Inserts and deletes
update it in place, where ``tpubloom`` donates the buffer to its jitted
step.

Batches: host batches are padded to the next power of two (minimum 64),
as in ``tpubloom``; padded entries carry ``length = -1`` at the tail and
set nothing and report False.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from tpubloom_torch.config import FilterConfig
from tpubloom_torch.obs import context as obs
from tpubloom_torch.obs import counters as obs_counters
from tpubloom_torch.ops import sweep
from tpubloom_torch.params import blocked_fpr
from tpubloom_torch.utils.packing import (
    pack_keys, redis_bitmap_to_words, words_to_redis_bitmap,
)

_POPCOUNT8 = [bin(i).count("1") for i in range(256)]


def _pad_to_bucket(n: int, minimum: int = 64) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def blocked_storage_fat(config: FilterConfig) -> bool:
    """Whether the blocked storage uses the fat [NB/J, 128] view (the
    same row-major bytes as [NB, W]); mirrors ``tpubloom`` so that the
    two packages hold identically shaped state."""
    w = config.words_per_block
    return 128 % w == 0 and config.n_blocks % (128 // w) == 0


def blocked_device_shape(config: FilterConfig) -> tuple[int, int]:
    """Storage shape: the fat [NB*W/128, 128] view when
    :func:`blocked_storage_fat` holds, else the logical [NB, W]."""
    nb, w = config.n_blocks, config.words_per_block
    if blocked_storage_fat(config):
        return (nb * w // 128, 128)
    return (nb, w)


def _zero_storage(shape, device: torch.device) -> torch.Tensor:
    # zeros as int32 then viewed: uint32 is a storage type in torch, with
    # few kernels of its own
    return torch.zeros(shape, dtype=torch.int32, device=device).view(torch.uint32)


def resolve_device(device) -> torch.device:
    """The card unless the caller names a device; no card and no device
    is an error, never a quiet run on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


class _FilterBase:
    """Shared packing / padding / batch plumbing.

    Subclasses provide ``self.words`` and ``_insert`` / ``_query`` over
    it, and inherit the whole batch + scalar API.
    """

    def __init__(self, config: FilterConfig, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.n_inserted = 0
        self.n_queried = 0

    def _pack_padded(self, keys: Sequence[bytes | str]):
        with obs.phase("host_prep"):
            keys_u8, lengths = pack_keys(
                keys, self.config.key_len, key_policy=self.config.key_policy
            )
            B = len(keys)
            Bp = _pad_to_bucket(B)
            if Bp != B:
                keys_u8 = np.pad(keys_u8, ((0, Bp - B), (0, 0)))
                lengths = np.pad(lengths, (0, Bp - B), constant_values=-1)
        return keys_u8, lengths, B

    def _stage_batch(self, keys_u8: np.ndarray, lengths: np.ndarray):
        """H2D staging under its own phase span."""
        with obs.phase("h2d"):
            return (
                torch.from_numpy(np.ascontiguousarray(keys_u8)).to(self.device),
                torch.from_numpy(np.ascontiguousarray(lengths)).to(self.device),
            )

    def _prep_packed(self, rows: np.ndarray):
        """Host prep for FIXED-WIDTH pre-packed keys (the ``fixed`` wire
        encoding): ``rows`` is ``uint8[B, W]``, every key exactly W bytes.
        Pads columns to ``key_len`` and rows to the bucket."""
        with obs.phase("host_prep"):
            B, W = rows.shape
            key_len = self.config.key_len
            if W > key_len:
                raise ValueError(
                    f"fixed-width keys are {W} bytes > key_len={key_len}; "
                    "ship them msgpack-encoded (key_policy applies there)"
                )
            if W < key_len:
                rows = np.pad(rows, ((0, 0), (0, key_len - W)))
            lengths = np.full((B,), W, dtype=np.int32)
            Bp = _pad_to_bucket(B)
            if Bp != B:
                rows = np.pad(rows, ((0, Bp - B), (0, 0)))
                lengths = np.pad(lengths, (0, Bp - B), constant_values=-1)
        return rows, lengths, B

    # staged pipeline API: host prep + H2D split from the kernel launch, so
    # a batching caller can stage batch N+1 while batch N's kernel runs,
    # then fence N through the returned handle (see ops.sweep.InFlight).

    def stage_batch(self, keys=None, *, rows=None):
        """Host prep + H2D only — returns an opaque staged batch for
        :meth:`launch_insert` / :meth:`launch_query`. Exactly one of
        ``keys`` (a key sequence) or ``rows`` (fixed-width ``uint8[B,
        W]``) must be given."""
        if rows is not None:
            keys_u8, lengths, B = self._prep_packed(np.asarray(rows, np.uint8))
        else:
            keys_u8, lengths, B = self._pack_padded(keys)
        d_keys, d_lengths = self._stage_batch(keys_u8, lengths)
        return d_keys, d_lengths, B

    def launch_insert(self, staged):
        """Launch the insert kernel on a staged batch WITHOUT waiting;
        returns the completion handle (a CUDA event, None on the CPU) the
        caller fences on before acking the batch."""
        d_keys, d_lengths, B = staged
        with obs.phase("kernel"):
            self._insert(d_keys, d_lengths)
        self.n_inserted += B
        return self._completion()

    def launch_query(self, staged):
        """Launch the membership kernel on a staged batch; returns
        ``(device hits, valid count)`` — the caller's copy to the host is
        the fence + D2H."""
        d_keys, d_lengths, B = staged
        with obs.phase("kernel_query"):
            hits = self._query(d_keys, d_lengths)
        self.n_queried += B
        return hits, B

    def _completion(self):
        """A handle with ``synchronize()`` for the device work queued so
        far on the filter's state (None on the CPU)."""
        return sweep.record_fence(self.device)

    def _kernel_fence(self) -> None:
        """Wait for the device work queued so far (under an active
        request context, so that the kernel phase covers real work)."""
        fence = self._completion()
        if fence is not None:
            fence.synchronize()

    # fixed-width batch API (the `fixed` wire encoding's server path)

    def insert_packed(self, rows: np.ndarray) -> int:
        """Insert fixed-width pre-packed keys (``uint8[B, W]``, W <=
        key_len)."""
        self.launch_insert(self.stage_batch(rows=rows))
        if obs.current() is not None:
            with obs.phase("kernel"):
                self._kernel_fence()
        return int(rows.shape[0])

    def include_packed(self, rows: np.ndarray) -> np.ndarray:
        """Membership for fixed-width pre-packed keys."""
        hits, B = self.launch_query(self.stage_batch(rows=rows))
        if obs.current() is not None:
            with obs.phase("kernel_query"):
                self._kernel_fence()
        with obs.phase("d2h"):
            out = hits.cpu().numpy()
        return out[:B]

    @property
    def words_logical(self) -> np.ndarray:
        """Host copy of the storage in its LOGICAL shape: ``[NB, W]`` for
        a blocked layout, the flat word array otherwise."""
        if not self.config.block_bits:
            return self._host_words()
        return self._host_words().reshape(
            self.config.n_blocks, self.config.words_per_block
        )

    def _state_tensors(self) -> list[torch.Tensor]:
        """The tensors that hold the filter's state, in the order of its
        bytes (one here; a sharded filter's slots)."""
        return [self.words]

    def _host_words(self) -> np.ndarray:
        # copies go through the int32 view: uint32 is a storage type in
        # torch, with few kernels of its own on the card
        return np.concatenate([
            t.view(torch.int32).cpu().numpy().view(np.uint32).reshape(-1)
            for t in self._state_tensors()
        ])

    def _set_words(self, words) -> None:
        """Replace storage from an array of the same bytes (checkpoint
        restore, interop)."""
        arr = np.array(words, dtype=np.uint32).reshape(-1)
        tensors = self._state_tensors()
        if arr.size != sum(t.numel() for t in tensors):
            raise ValueError(
                f"{arr.size} words given, the filter holds "
                f"{sum(t.numel() for t in tensors)}"
            )
        off = 0
        for t in tensors:
            part = arr[off : off + t.numel()].reshape(t.shape)
            t.view(torch.int32).copy_(torch.from_numpy(part.view(np.int32)))
            off += t.numel()

    def clear(self) -> None:
        """Reference ``#clear`` — zero the array."""
        for t in self._state_tensors():
            t.view(torch.int32).zero_()
        self.n_inserted = 0

    # persistence (raw little-endian words, row-major — the same bytes as
    # tpubloom's to_bytes for the same class)

    def to_bytes(self) -> bytes:
        return self._host_words().astype("<u4").tobytes()

    @classmethod
    def from_bytes(cls, config: FilterConfig, data: bytes, device=None):
        f = cls(config, device)
        f._set_words(np.frombuffer(data, dtype="<u4").astype(np.uint32))
        return f

    # batch API (the north-star surface)

    def _update_batch(self, keys: Sequence[bytes | str], update) -> int:
        """Pack, stage and run one in-place update kernel over a batch;
        returns the batch's key count."""
        keys_u8, lengths, B = self._pack_padded(keys)
        d_keys, d_lengths = self._stage_batch(keys_u8, lengths)
        with obs.phase("kernel"):
            update(d_keys, d_lengths)
            if obs.current() is not None:
                self._kernel_fence()
        return B

    def insert_batch(self, keys: Sequence[bytes | str]) -> None:
        self.n_inserted += self._update_batch(keys, self._insert)

    def include_batch(self, keys: Sequence[bytes | str]) -> np.ndarray:
        keys_u8, lengths, B = self._pack_padded(keys)
        d_keys, d_lengths = self._stage_batch(keys_u8, lengths)
        with obs.phase("kernel_query"):
            hits = self._query(d_keys, d_lengths)
            if obs.current() is not None:
                self._kernel_fence()
        with obs.phase("d2h"):
            out = hits.cpu().numpy()
        self.n_queried += B
        return out[:B]

    # pre-packed device-array API (bench / server / streaming path)

    def insert_arrays(self, keys_u8, lengths, *, n_valid: int | None = None) -> None:
        """``keys_u8``/``lengths`` are tensors on the filter's device.
        ``n_valid`` = true key count when the batch carries padding
        (lengths = -1 rows set no bits but must not inflate
        ``n_inserted``)."""
        self._insert(keys_u8, lengths)
        self.n_inserted += int(keys_u8.shape[0]) if n_valid is None else n_valid

    def include_arrays(self, keys_u8, lengths) -> torch.Tensor:
        self.n_queried += int(keys_u8.shape[0])
        return self._query(keys_u8, lengths)

    # scalar API (reference parity)

    def insert(self, key: bytes | str) -> None:
        self.insert_batch([key])

    def include(self, key: bytes | str) -> bool:
        return bool(self.include_batch([key])[0])

    __contains__ = include

    # observability: fill ratio & predicted FPR

    def bits_set(self) -> int:
        """Set bits in the state: a byte popcount table over its bytes,
        in slices so the index tensor stays small on a 512 MiB state."""
        total = 0
        for t in self._state_tensors():
            b = t.view(torch.uint8).reshape(-1)
            lut = torch.tensor(_POPCOUNT8, dtype=torch.int64, device=t.device)
            step = 1 << 26
            total += sum(
                int(lut[b[s : s + step].to(torch.int64)].sum())
                for s in range(0, b.numel(), step)
            )
        return total

    def fill_ratio(self) -> float:
        if self.config.counting:
            raise ValueError("fill_ratio is for plain/blocked filters")
        return self.bits_set() / self.config.m

    def estimated_fpr(self) -> float:
        return self.fill_ratio() ** self.config.k

    def predicted_fpr(self) -> float:
        """Analytic FPR from the geometry and ``n_inserted`` alone: the
        blocked layout's own model (:func:`params.blocked_fpr`), or
        ``(1 - e^{-kn/m})^k`` for the flat layout."""
        c = self.config
        if not c.block_bits:
            return (1.0 - math.exp(-c.k * self.n_inserted / c.m)) ** c.k
        return blocked_fpr(
            self.n_inserted, m=c.m, k=c.k,
            block_bits=c.block_bits, block_hash=c.block_hash,
        )

    def _fpr_gauges(self) -> dict:
        bits = self.bits_set()
        fill = bits / self.config.m
        estimated = fill**self.config.k
        predicted = self.predicted_fpr()
        return {
            "fill_ratio": fill,
            "bits_set": bits,
            "estimated_fpr": estimated,
            "predicted_fpr": predicted,
            "fpr_drift": estimated - predicted,
        }


class BloomFilter(_FilterBase):
    """Flat bloom filter on a packed ``uint32[n_words]`` array: the
    reference gem's SETBIT/GETBIT positions, so its words convert to and
    from a Redis string bitmap. On the card an insert is one
    ``flat_insert`` launch (an ``atomicOr`` a position), a query one
    ``flat_query`` (k word gathers a key)."""

    def __init__(self, config: FilterConfig, device=None):
        if config.counting:
            raise ValueError("use CountingBloomFilter for counting configs")
        if config.block_bits:
            raise ValueError("use BlockedBloomFilter for blocked configs")
        super().__init__(config, device)
        self.words = _zero_storage((config.n_words,), self.device)

    def _insert(self, keys, lengths) -> None:
        sweep.flat_insert(self.words, keys, lengths, self.config)

    def _query(self, keys, lengths) -> torch.Tensor:
        return sweep.flat_query(self.words, keys, lengths, self.config)

    def stats(self) -> dict:
        return {
            "m": self.config.m,
            "k": self.config.k,
            "n_inserted": self.n_inserted,
            "n_queried": self.n_queried,
            **self._fpr_gauges(),
        }

    # persistence in the Redis-string-bitmap format (reference-compatible)

    def to_redis_bitmap(self) -> bytes:
        return words_to_redis_bitmap(self._host_words(), self.config.m)

    @classmethod
    def from_redis_bitmap(cls, config: FilterConfig, data: bytes, device=None) -> "BloomFilter":
        f = cls(config, device)
        f._set_words(redis_bitmap_to_words(data, config.m))
        return f


class BlockedBloomFilter(_FilterBase):
    """Blocked (cache-line) bloom filter — the throughput layout.

    All k bits of a key live in one ``config.block_bits``-sized block
    (the spec in :mod:`tpubloom_torch.ops.blocked`), so every insert or
    query touches one contiguous row: one row read per query, one
    ``atomicOr`` per touched word per insert on the card.
    """

    def __init__(self, config: FilterConfig, device=None):
        if config.counting:
            # a counting config reinterprets m as counters (4 bits each)
            raise ValueError(
                "use BlockedCountingBloomFilter for counting configs"
            )
        if not config.block_bits:
            config = config.replace(block_bits=512)
        super().__init__(config, device)
        self.words = _zero_storage(blocked_device_shape(config), self.device)

    def insert_batch(
        self, keys: Sequence[bytes | str], *, return_presence: bool = False
    ):
        """Insert a batch; with ``return_presence`` also report each key's
        membership BEFORE the batch (test-and-insert — the reference Lua
        add script's semantics). Within-batch duplicates all report the
        pre-batch state."""
        if not return_presence:
            return super().insert_batch(keys)
        keys_u8, lengths, B = self._pack_padded(keys)
        d_keys, d_lengths = self._stage_batch(keys_u8, lengths)
        with obs.phase("kernel"):
            present = self._test_insert(d_keys, d_lengths)
            if obs.current() is not None:
                self._kernel_fence()
        self.n_inserted += B
        with obs.phase("d2h"):
            out = present.cpu().numpy()
        return out[:B]

    def _insert(self, keys, lengths) -> None:
        sweep.blocked_insert(self.words, keys, lengths, self.config)

    def _test_insert(self, keys, lengths) -> torch.Tensor:
        return sweep.blocked_test_insert(self.words, keys, lengths, self.config)

    def _query(self, keys, lengths) -> torch.Tensor:
        # tpubloom counts each blocked query launch by the path it took
        # (sweep or gather); the port has one query kernel, so every launch
        # counts as a sweep and query_gather_launches stays 0
        obs_counters.incr("query_sweep_launches")
        return sweep.blocked_query(self.words, keys, lengths, self.config)

    def stats(self) -> dict:
        return {
            "m": self.config.m,
            "k": self.config.k,
            "block_bits": self.config.block_bits,
            "n_inserted": self.n_inserted,
            "n_queried": self.n_queried,
            **self._fpr_gauges(),
        }


class _CountingBase(_FilterBase):
    """Delete and stats of the counting filters; subclasses provide
    ``_delete`` beside ``_insert`` / ``_query``."""

    def delete_batch(self, keys: Sequence[bytes | str]) -> None:
        """Remove one copy of each key: its counters drop by their
        multiplicities, flooring at 0."""
        B = self._update_batch(keys, self._delete)
        self.n_inserted = max(0, self.n_inserted - B)

    def delete(self, key: bytes | str) -> None:
        self.delete_batch([key])

    def stats(self) -> dict:
        out = {"m": self.config.m, "k": self.config.k}
        if self.config.block_bits:
            out["block_bits"] = self.config.block_bits
        return {**out, "n_inserted": self.n_inserted, "n_queried": self.n_queried}


class CountingBloomFilter(_CountingBase):
    """Flat counting bloom filter: 4-bit saturating counters at the flat
    positions, packed in ``uint32[n_counter_words]``; supports delete.
    ``m`` counts COUNTERS (< 2^31). On the card an insert or a delete is
    one ``flat_counting_update`` launch (a saturating ``atomicCAS`` loop a
    position), a query one ``flat_counting_query``. Increments clamp at
    15, decrements floor at 0, with the result of ``tpubloom``'s one clamp
    per batch against the pre-batch value, bit for bit."""

    def __init__(self, config: FilterConfig, device=None):
        if not config.counting:
            config = config.replace(counting=True)
        if config.block_bits:
            raise ValueError("use BlockedCountingBloomFilter for blocked configs")
        if config.m >= (1 << 31):
            raise ValueError("counting filters support m < 2^31 (config 4: m=2^30)")
        super().__init__(config, device)
        self.words = _zero_storage((config.n_counter_words,), self.device)

    def _insert(self, keys, lengths) -> None:
        sweep.flat_counting_update(self.words, keys, lengths, self.config, increment=True)

    def _delete(self, keys, lengths) -> None:
        sweep.flat_counting_update(self.words, keys, lengths, self.config, increment=False)

    def _query(self, keys, lengths) -> torch.Tensor:
        return sweep.flat_counting_query(self.words, keys, lengths, self.config)


class BlockedCountingBloomFilter(_CountingBase):
    """Blocked (cache-line) counting filter — delete support at the
    blocked layout's throughput.

    All k 4-bit counters of a key live in one ``block_bits``-bit block
    (``block_bits/4`` counters), so an update or a query touches one
    contiguous row; on the card an insert or delete is one
    ``blocked_counting_update`` launch (a saturating ``atomicCAS`` per
    touched word), a query one ``blocked_counting_query``. ``m`` counts
    COUNTERS. Increments clamp at 15, decrements floor at 0, one clamp per
    batch against the pre-batch value — the semantics of
    ``tpubloom.BlockedCountingBloomFilter``, bit for bit.
    """

    def __init__(self, config: FilterConfig, device=None):
        if not config.counting:
            config = config.replace(counting=True)
        if not config.block_bits:
            config = config.replace(block_bits=512)
        if config.m >= (1 << 31):
            raise ValueError("counting filters support m < 2^31")
        super().__init__(config, device)
        self.words = _zero_storage(blocked_device_shape(config), self.device)

    def _insert(self, keys, lengths) -> None:
        sweep.blocked_counting_update(self.words, keys, lengths, self.config, increment=True)

    def _delete(self, keys, lengths) -> None:
        sweep.blocked_counting_update(self.words, keys, lengths, self.config, increment=False)

    def _query(self, keys, lengths) -> torch.Tensor:
        return sweep.blocked_counting_query(self.words, keys, lengths, self.config)
