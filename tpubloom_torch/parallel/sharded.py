"""ShardedBloomFilter — the filter array of BASELINE config 5 on PyTorch.

The port of ``tpubloom/parallel/sharded.py`` for all four layouts: blocked
and flat, bit and counting. BASELINE config 5 is "64-shard filter array
over v5e-8, m=2^36 total — pmap hash + all-reduce-OR cross-chip
membership" (``benchmarks/run.py`` runs it flat by default); its counting
twin is configs 4 x 5.

Layout (the same as ``tpubloom``'s, byte for byte):

* The filter is split into ``config.shards`` independent sub-filters of
  ``m_per_shard`` positions (``n_blocks_per_shard`` blocks for a blocked
  layout). A key belongs to shard ``murmur3_32(key, seed ^ 0x517CC1B7)
  mod shards`` (see :mod:`tpubloom_torch.ops.hashing`) and hashes inside
  it with the shard's geometry.
* The shards are dealt to *slots*, ``shards_per_dev`` consecutive shards
  each: slot i holds shards ``[i * spd, (i + 1) * spd)`` as one tensor of
  shape ``[spd, NBL·W/128, 128]`` (blocked: the fat view, where it
  divides; else ``[spd, NBL, W]``), ``[spd, n_words_per_shard]`` (flat
  bits) or ``[spd, m_per_shard / 8]`` (flat counters), the same bytes as
  ``tpubloom``'s per-device block.
  A slot is a device entry of :func:`make_slots`: by default one slot per
  visible CUDA card, and a device may be named more than once, which lays
  several slots on one card (or on the CPU, where the tests mirror
  ``tpubloom``'s 8-device mesh).
* Every slot sees the whole batch. The batch is staged once per distinct
  device (``h2d``) and the slots on that device share it. Each slot runs
  the routed kernels (:mod:`tpubloom_torch.ops.sweep` with a
  :class:`~tpubloom_torch.ops.hashing.ShardRoute`): a key the slot does
  not own sets nothing and answers False, so the slots' verdicts, moved to
  the first slot's device and ORed there, are the answer — the
  counterpart of ``tpubloom``'s ``psum`` over the mesh.

The multi-host join (``parallel/distributed.py``), an NCCL all-reduce
across cards and the ``shard.*`` fault points are not ported yet (ROADMAP
queue 1 items 4 and 6).
"""

from __future__ import annotations

import time
from functools import partial
from typing import Optional, Sequence

import numpy as np
import torch

from tpubloom_torch.config import FilterConfig
from tpubloom_torch.filter import _FilterBase
from tpubloom_torch.obs import context as obs
from tpubloom_torch.ops import sweep
from tpubloom_torch.ops.hashing import M32, ShardRoute
from tpubloom_torch.utils.packing import redis_bitmap_to_words, words_to_redis_bitmap


def _device(d) -> torch.device:
    """A device with its index filled in, so that slots on one card
    compare equal however they were named."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_slots(
    n_shards: int, devices: Optional[Sequence] = None
) -> list[torch.device]:
    """The slots' devices — ``tpubloom.parallel.sharded.make_mesh``'s
    counterpart. ``devices`` defaults to every visible CUDA card; with no
    card and no ``devices`` this raises. A device may appear more than
    once (several slots on one device). ``n_shards`` and the device count
    must divide one another; ``devices[:min(n_shards, len(devices))]``
    are used, each holding ``n_shards // len(slots)`` shards."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass devices=['cpu'] * n to run "
                "the plain PyTorch versions on the CPU"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    n_dev = len(devices)
    if not n_dev:
        raise ValueError("make_slots needs at least one device")
    if n_shards % n_dev != 0 and n_dev % n_shards != 0:
        raise ValueError(f"n_shards={n_shards} incompatible with {n_dev} devices")
    return devices[: min(n_shards, n_dev)]


def local_blocked_storage_fat(config: FilterConfig) -> bool:
    """Whether each shard's rows are kept in the fat [NBL·W/128, 128]
    view (``tpubloom``'s rule, on the per-shard geometry)."""
    if not config.block_bits:
        return False
    w = config.words_per_block
    return 128 % w == 0 and config.n_blocks_per_shard % (128 // w) == 0


def sharded_shape(config: FilterConfig) -> tuple[int, ...]:
    """Shape of the whole array, ``[shards, ...]``: blocked, per-shard fat
    rows when :func:`local_blocked_storage_fat` holds, else logical rows;
    flat, each shard's words. A slot holds ``shards_per_dev`` of its
    leading entries."""
    if not config.block_bits:
        per_word = 8 if config.counting else 32  # counters or bits a word
        return (config.shards, config.m_per_shard // per_word)
    if local_blocked_storage_fat(config):
        return (
            config.shards,
            config.n_blocks_per_shard * config.words_per_block // 128,
            128,
        )
    return (config.shards, config.n_blocks_per_shard, config.words_per_block)


def shard_popcounts(words: torch.Tensor, max_elems: int = 1 << 24) -> torch.Tensor:
    """Set bits of each leading entry of a ``uint32[S, ...]`` tensor:
    int64 ``[S]`` on its device, reduced there (a SWAR popcount over
    column slices of at most ``max_elems`` words, so the int64 temporaries
    stay small on an 8 GiB slot)."""
    w = words.view(torch.int32).reshape(words.shape[0], -1)
    total = torch.zeros(w.shape[0], dtype=torch.int64, device=w.device)
    step = max(1, max_elems // w.shape[0])
    for s in range(0, w.shape[1], step):
        x = w[:, s : s + step].to(torch.int64) & M32
        x = x - ((x >> 1) & 0x55555555)
        x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
        x = (x + (x >> 4)) & 0x0F0F0F0F
        total += (((x * 0x01010101) & M32) >> 24).sum(dim=1)
    return total


class _Fences:
    """Completion handle over several devices (``synchronize()`` waits
    for each)."""

    def __init__(self, events):
        self._events = events

    def synchronize(self) -> None:
        for ev in self._events:
            ev.synchronize()


class ShardedBloomFilter(_FilterBase):
    """Filter array over slots of device memory (config 5, in each of the
    four layouts), with ``tpubloom.ShardedBloomFilter``'s surface: the
    batch, packed, staged, array and scalar APIs, ``delete`` (counting),
    ``clear``, ``stats`` and ``shard_fill_ratios``, ``words_logical``,
    ``to_bytes`` / ``from_bytes`` (shard-major raw little-endian words)
    and, for the flat bit layout, ``to_redis_bitmap`` /
    ``from_redis_bitmap`` (shard-major: bit ``s * m_per_shard + p`` of the
    bitmap is bit p of shard s).

    ``devices`` as for :func:`make_slots`; the first slot's device is
    ``self.device``, where query verdicts are assembled."""

    def __init__(self, config: FilterConfig, devices: Optional[Sequence] = None):
        if config.shards < 2:
            raise ValueError("ShardedBloomFilter needs config.shards >= 2")
        if config.counting and config.m >= (1 << 31):
            raise ValueError("counting filters support m < 2^31")
        self.slots = make_slots(config.shards, devices)
        super().__init__(config, self.slots[0])
        spd = config.shards // len(self.slots)
        self.shards_per_dev = spd
        self.routes = [ShardRoute(config.shards, i * spd, spd) for i in range(len(self.slots))]
        shape = (spd, *sharded_shape(config)[1:])
        self.slot_words = [
            torch.zeros(shape, dtype=torch.int32, device=d).view(torch.uint32)
            for d in self.slots
        ]
        self._devices = list(dict.fromkeys(self.slots))  # distinct, in slot order
        self._slot_fences: list = []
        flat = not config.block_bits
        if config.counting:
            update = sweep.flat_counting_update if flat else sweep.blocked_counting_update
            self._update_kernel = partial(update, increment=True)
            self._delete_kernel = partial(update, increment=False)
            self._query_kernel = sweep.flat_counting_query if flat else sweep.blocked_counting_query
        else:
            self._update_kernel = sweep.flat_insert if flat else sweep.blocked_insert
            self._query_kernel = sweep.flat_query if flat else sweep.blocked_query

    def _state_tensors(self) -> list[torch.Tensor]:
        return self.slot_words

    # -- staging and the per-slot launches -----------------------------------

    def _stage_batch(self, keys_u8: np.ndarray, lengths: np.ndarray):
        """Replicated H2D: one copy of the batch on each distinct device,
        shared by the slots there."""
        with obs.phase("h2d"):
            k = torch.from_numpy(np.ascontiguousarray(keys_u8))
            n = torch.from_numpy(np.ascontiguousarray(lengths))
            return {d: k.to(d) for d in self._devices}, {d: n.to(d) for d in self._devices}

    def _per_device(self, keys, lengths):
        """The staged ``{device: tensor}`` pair, or a pair of tensors
        (``insert_arrays``) copied to each device that lacks them."""
        if isinstance(keys, dict):
            return keys, lengths
        return {d: keys.to(d) for d in self._devices}, {d: lengths.to(d) for d in self._devices}

    def _launch(self, kernel, keys, lengths) -> list:
        """Run ``kernel`` on every slot; returns each slot's result and
        keeps a completion fence per slot for :meth:`_kernel_fence`."""
        keys, lengths = self._per_device(keys, lengths)
        results, fences = [], []
        for words, dev, route in zip(self.slot_words, self.slots, self.routes):
            results.append(kernel(words, keys[dev], lengths[dev], self.config, route=route))
            fences.append(sweep.record_fence(dev))
        self._slot_fences = fences
        return results

    def _insert(self, keys, lengths) -> None:
        self._launch(self._update_kernel, keys, lengths)

    def _delete(self, keys, lengths) -> None:
        self._launch(self._delete_kernel, keys, lengths)

    def _query(self, keys, lengths) -> torch.Tensor:
        """Each slot answers for the keys it owns (False elsewhere); the
        answers meet on the first slot's device and are ORed."""
        hits = None
        for v in self._launch(self._query_kernel, keys, lengths):
            v = v.to(self.device)
            hits = v if hits is None else hits | v
        return hits

    def _completion(self):
        fences = [sweep.record_fence(d) for d in self._devices]
        fences = [f for f in fences if f is not None]
        return _Fences(fences) if fences else None

    def _kernel_fence(self) -> None:
        """Under an active request context, break the kernel span into
        per-slot completion times: ``kernel_shard<i>`` is the time from
        the fence's start by which slots 0..i had all finished (monotone
        in i; the first large jump names the slow slot), as
        ``tpubloom``'s per-device phases."""
        ctx = obs.current()
        if ctx is None or len(self._slot_fences) <= 1:
            super()._kernel_fence()
            return
        t0 = time.perf_counter()
        for i, fence in enumerate(self._slot_fences):
            if fence is not None:
                fence.synchronize()
            ctx.add_phase(f"kernel_shard{i}", time.perf_counter() - t0)
        super()._kernel_fence()

    # -- delete (counting configs only: configs 4 x 5) ------------------------

    def delete_batch(self, keys) -> None:
        """Remove one copy of each key (counting configs only)."""
        if not self.config.counting:
            raise ValueError("delete requires a counting config")
        B = self._update_batch(keys, self._delete)
        self.n_inserted = max(0, self.n_inserted - B)

    def delete(self, key) -> None:
        self.delete_batch([key])

    # -- observability ---------------------------------------------------------

    def shard_fill_ratios(self) -> Optional[list]:
        """Per-shard fraction of set bits (None for counting configs):
        reduced on each slot's device, O(shards) bytes to the host."""
        if self.config.counting:
            return None
        counts = [c for w in self.slot_words for c in shard_popcounts(w).cpu().tolist()]
        return [c / self.config.m_per_shard for c in counts]

    def stats(self) -> dict:
        base = {
            "m": self.config.m,
            "k": self.config.k,
            "shards": self.config.shards,
            "devices": len(self.slots),
            "n_inserted": self.n_inserted,
            "n_queried": self.n_queried,
        }
        if self.config.counting:
            return base
        # shards are equal sized: the global fill is the mean of theirs
        fills = self.shard_fill_ratios()
        fill = float(np.mean(fills))
        estimated = fill**self.config.k
        predicted = self.predicted_fpr()
        return {
            **base,
            "fill_ratio": fill,
            "bits_set": int(round(fill * self.config.m)),
            "estimated_fpr": estimated,
            "predicted_fpr": predicted,
            "fpr_drift": estimated - predicted,
            "fill_ratio_per_shard": fills,
        }

    # -- state on the host: shard-major, then row-major ------------------------

    @property
    def words_logical(self) -> np.ndarray:
        """Host copy as ``[shards, n_blocks_per_shard, words_per_block]``
        (blocked), else in the device shape ``[shards, words a shard]``."""
        c = self.config
        if c.block_bits:
            return self._host_words().reshape(c.shards, c.n_blocks_per_shard, c.words_per_block)
        return self._host_words().reshape(sharded_shape(c))

    def to_redis_bitmap(self) -> bytes:
        if self.config.block_bits or self.config.counting:
            raise ValueError(
                "blocked/counting layouts are not Redis-bitmap exportable "
                "(different position spec); use to_bytes"
            )
        return words_to_redis_bitmap(self._host_words(), self.config.m)

    @classmethod
    def from_redis_bitmap(cls, config: FilterConfig, data: bytes, devices=None):
        if config.block_bits or config.counting:
            raise ValueError("blocked/counting layouts restore via from_bytes")
        f = cls(config, devices)
        f._set_words(redis_bitmap_to_words(data, config.m))
        return f

    @classmethod
    def from_bytes(cls, config: FilterConfig, data: bytes, devices=None):
        f = cls(config, devices)
        f._set_words(np.frombuffer(data, dtype="<u4").astype(np.uint32))
        return f
