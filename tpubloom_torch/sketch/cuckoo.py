"""CuckooFilter — deletable membership without 4-bit counters, on the
port's kernels.

The counterpart of ``tpubloom/sketch/cuckoo.py``, over
:func:`tpubloom_torch.ops.sweep.cuckoo_insert` / ``cuckoo_delete`` /
``cuckoo_query`` (``csrc/cuckoo.cu`` on the card, the plain versions of
:mod:`tpubloom_torch.ops.cuckoo` on the CPU). Storage is the flat
``uint32[m]`` slot array (``m = config.m`` fingerprint slots, a power of
two, read as ``[m / 4, 4]`` buckets), the same words as ``tpubloom``'s, so
its checkpoints cross between the packages.

As in ``tpubloom``:

* an insert can fail per key (FULL: no place after ``MAX_KICKS`` kicks,
  its chain unwound). The per-key verdicts stay on the device until
  :meth:`take_insert_flags` collects them, which also settles the
  ``cuckoo_kicks_total`` and ``cuckoo_full_rejections`` counters;
* inserts are a multiset (a duplicate add stores another copy);
* :meth:`delete_batch` removes one stored copy a key and reports whether
  there was one. Deleting a key never inserted may evict another key's
  fingerprint, as in every cuckoo filter; the flags let a caller see it.

Every insert passes the ``cuckoo.kick`` fault point before its kernel runs.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from tpubloom_torch import faults
from tpubloom_torch.config import FilterConfig
from tpubloom_torch.filter import _FilterBase, _zero_storage
from tpubloom_torch.obs import context as obs
from tpubloom_torch.obs import counters as obs_counters
from tpubloom_torch.ops import cuckoo as ops_cuckoo
from tpubloom_torch.ops import sweep


class CuckooFilter(_FilterBase):
    """Bucketed-fingerprint cuckoo filter on a flat ``uint32`` array, on the
    card unless ``device`` names another."""

    def __init__(self, config: FilterConfig, device=None):
        if config.kind != "cuckoo":
            raise ValueError(f"CuckooFilter needs kind='cuckoo', got {config.kind!r}")
        if config.m < ops_cuckoo.BUCKET_SIZE * 2:
            raise ValueError(
                f"cuckoo needs at least 2 buckets ({2 * ops_cuckoo.BUCKET_SIZE} "
                f"slots), got m={config.m}"
            )
        super().__init__(config, device)
        self.n_buckets = config.m // ops_cuckoo.BUCKET_SIZE
        self.words = _zero_storage((config.m,), self.device)
        #: (ok flags, true batch size, kick count) of the last insert, on the
        #: device, until take_insert_flags() collects them
        self._pending_flags = None

    def _run_insert(self, keys, lengths, B: int) -> None:
        ok, kicks = sweep.cuckoo_insert(self.words, keys, lengths, self.config)
        self._pending_flags = (ok, B, kicks.sum())
        self.n_inserted += B

    def _query(self, keys, lengths):
        return sweep.cuckoo_query(self.words, keys, lengths, self.config)

    # -- insert (every path goes through _run_insert, so that no FULL
    # verdict is lost whichever entry point drove the batch) --------------

    def launch_insert(self, staged):
        d_keys, d_lengths, B = staged
        faults.fire("cuckoo.kick", filter=self.config.key_name, batch=B)
        with obs.phase("kernel"):
            self._run_insert(d_keys, d_lengths, B)
        return self._completion()

    def insert_batch(self, keys: Sequence[bytes | str]) -> None:
        self.launch_insert(self.stage_batch(keys))
        if obs.current() is not None:
            with obs.phase("kernel"):
                self._kernel_fence()

    def insert_arrays(self, keys_u8, lengths, *, n_valid: int | None = None) -> None:
        faults.fire("cuckoo.kick", filter=self.config.key_name)
        self._run_insert(keys_u8, lengths, int(keys_u8.shape[0]) if n_valid is None else n_valid)

    def take_insert_flags(self):
        """Per-key success flags of the LAST insert (``bool[B]``; False is
        FULL), or None once collected. Also settles the kick and rejection
        counters, so that metrics follow the acknowledged batch."""
        pending = self._pending_flags
        self._pending_flags = None
        if pending is None:
            return None
        ok, B, kicks = pending
        flags = ok.cpu().numpy()[:B]
        nk = int(kicks)
        if nk:
            obs_counters.incr("cuckoo_kicks_total", nk)
        rejected = int(B - flags.sum())
        if rejected:
            obs_counters.incr("cuckoo_full_rejections", rejected)
        return flags

    # -- delete --------------------------------------------------------------

    def delete_batch(self, keys: Sequence[bytes | str]) -> np.ndarray:
        """Remove one stored copy a key; ``bool[B]``, whether a copy was
        there."""
        keys_u8, lengths, B = self._pack_padded(keys)
        d_keys, d_lengths = self._stage_batch(keys_u8, lengths)
        with obs.phase("kernel"):
            deleted = sweep.cuckoo_delete(self.words, d_keys, d_lengths, self.config)
            if obs.current() is not None:
                self._kernel_fence()
        with obs.phase("d2h"):
            out = deleted.cpu().numpy()
        return out[:B]

    # -- stats ----------------------------------------------------------------

    def clear(self) -> None:
        super().clear()
        self._pending_flags = None

    def fill_ratio(self) -> float:
        return ops_cuckoo.occupancy(self.words) / self.config.m

    def stats(self) -> dict:
        occupied = ops_cuckoo.occupancy(self.words)
        return {
            "kind": "cuckoo",
            "m": self.config.m,
            "n_buckets": self.n_buckets,
            "bucket_size": ops_cuckoo.BUCKET_SIZE,
            "max_kicks": ops_cuckoo.MAX_KICKS,
            "n_inserted": self.n_inserted,
            "n_queried": self.n_queried,
            "occupied_slots": occupied,
            "fill_ratio": occupied / self.config.m,
        }
