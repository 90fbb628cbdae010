"""CountMinSketch and TopKSketch — frequency workloads, on the port's
kernels.

The counterparts of ``tpubloom/sketch/cms.py``, over
:func:`tpubloom_torch.ops.sweep.cms_update` / ``cms_estimate``
(``csrc/cms.cu`` on the card, the plain versions of
:mod:`tpubloom_torch.ops.cms` on the CPU). Storage is the flat
``uint32[depth * width]`` counter grid (``width = config.m``, ``depth =
config.k``), the same words as ``tpubloom``'s. ``insert_batch`` adds 1 a
key; :meth:`CountMinSketch.increment_batch` adds per-key weights and
returns the estimates after the update; ``include_batch`` answers
"estimate > 0". Every update passes the ``cms.update`` fault point before
its kernel runs, and counts its keys in ``cms_keys_incremented``.

:class:`TopKSketch` adds the heavy-hitter heap: a host ``{key: estimate}``
dict of at most ``config.topk`` entries, refreshed from an estimate pass
after every update batch (the count-min estimate is the score). The heap
rides checkpoints in the header's extra block (:meth:`TopKSketch.
sketch_extra` / :meth:`TopKSketch.load_sketch_extra`, keys hex-encoded).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from tpubloom_torch import faults
from tpubloom_torch.config import FilterConfig
from tpubloom_torch.filter import _FilterBase, _zero_storage
from tpubloom_torch.obs import context as obs
from tpubloom_torch.obs import counters as obs_counters
from tpubloom_torch.ops import sweep


def _u32_host(t: torch.Tensor) -> np.ndarray:
    """A ``uint32`` tensor's values on the host (through its int32 view)."""
    return t.view(torch.int32).cpu().numpy().view(np.uint32)


class CountMinSketch(_FilterBase):
    """``[depth, width]`` count-min grid on a flat ``uint32`` array, on the
    card unless ``device`` names another."""

    KINDS = ("cms",)

    def __init__(self, config: FilterConfig, device=None):
        if config.kind not in self.KINDS:
            raise ValueError(
                f"{type(self).__name__} needs kind in {self.KINDS}, got {config.kind!r}"
            )
        super().__init__(config, device)
        self.width = config.m
        self.depth = config.k
        self.words = _zero_storage((self.width * self.depth,), self.device)

    def _insert(self, keys, lengths) -> None:
        sweep.cms_update(self.words, keys, lengths, self.config)

    def _estimate(self, keys, lengths) -> torch.Tensor:
        return sweep.cms_estimate(self.words, keys, lengths, self.config)

    def _query(self, keys, lengths) -> torch.Tensor:
        return self._estimate(keys, lengths).view(torch.int32) != 0

    # -- updates (every path goes through launch_insert / insert_arrays /
    # increment_batch, so that the fault point and the top-k hook see
    # every batch) ---------------------------------------------------------

    def launch_insert(self, staged):
        d_keys, d_lengths, B = staged
        faults.fire("cms.update", filter=self.config.key_name, batch=B)
        with obs.phase("kernel"):
            self._insert(d_keys, d_lengths)
        self.n_inserted += B
        self._post_update(d_keys, d_lengths, B)
        return self._completion()

    def insert_batch(self, keys: Sequence[bytes | str]) -> None:
        self.launch_insert(self.stage_batch(keys))
        if obs.current() is not None:
            with obs.phase("kernel"):
                self._kernel_fence()

    def insert_arrays(self, keys_u8, lengths, *, n_valid: int | None = None) -> None:
        faults.fire("cms.update", filter=self.config.key_name)
        self._insert(keys_u8, lengths)
        B = int(keys_u8.shape[0]) if n_valid is None else n_valid
        self.n_inserted += B
        self._post_update(keys_u8, lengths, B)

    def increment_batch(
        self, keys: Sequence[bytes | str], increments: Sequence[int]
    ) -> np.ndarray:
        """Weighted increment (``CMS.INCRBY``); returns the estimates
        AFTER the update (``uint32[B]``), the verb's reply."""
        if len(increments) != len(keys):
            raise ValueError(f"{len(increments)} increments for {len(keys)} keys")
        incs = [int(i) for i in increments]
        if any(i < 0 or i >= (1 << 32) for i in incs):
            raise ValueError("increments must be u32 (>= 0)")
        keys_u8, lengths, B = self._pack_padded(keys)
        padded = np.zeros(lengths.shape, np.uint32)
        padded[:B] = np.asarray(incs, np.uint32)
        d_keys, d_lengths = self._stage_batch(keys_u8, lengths)
        with obs.phase("h2d"):
            d_incs = torch.from_numpy(padded.view(np.int32)).to(self.device).view(torch.uint32)
        faults.fire("cms.update", filter=self.config.key_name, batch=B)
        with obs.phase("kernel"):
            sweep.cms_update(self.words, d_keys, d_lengths, self.config, d_incs)
            if obs.current() is not None:
                self._kernel_fence()
        self.n_inserted += B
        self._post_update(d_keys, d_lengths, B)
        with obs.phase("kernel_query"):
            est = self._estimate(d_keys, d_lengths)
        with obs.phase("d2h"):
            out = _u32_host(est)
        return out[:B]

    def _post_update(self, d_keys, d_lengths, B: int) -> None:
        """Hook after every update batch; TopKSketch refreshes its heap."""
        obs_counters.incr("cms_keys_incremented", B)

    # -- reads ----------------------------------------------------------------

    def estimate_batch(self, keys: Sequence[bytes | str]) -> np.ndarray:
        """Point estimates (``CMS.QUERY``): ``uint32[B]``, never below the
        true counts."""
        keys_u8, lengths, B = self._pack_padded(keys)
        d_keys, d_lengths = self._stage_batch(keys_u8, lengths)
        with obs.phase("kernel_query"):
            est = self._estimate(d_keys, d_lengths)
            if obs.current() is not None:
                self._kernel_fence()
        with obs.phase("d2h"):
            out = _u32_host(est)
        self.n_queried += B
        return out[:B]

    # -- stats ----------------------------------------------------------------

    def fill_ratio(self) -> float:
        """Share of NON-ZERO counters (collision pressure; the bloom fill
        model does not apply to a counter grid)."""
        return int((self.words.view(torch.int32) != 0).sum()) / (self.width * self.depth)

    def stats(self) -> dict:
        return {
            "kind": self.config.kind,
            "width": self.width,
            "depth": self.depth,
            "n_inserted": self.n_inserted,
            "n_queried": self.n_queried,
            "fill_ratio": self.fill_ratio(),
        }


class TopKSketch(CountMinSketch):
    """A count-min sketch with a host heap of the ``config.topk`` largest
    estimates seen, refreshed after each update batch from an estimate
    pass on the device, so that :meth:`topk_list` is a host read."""

    KINDS = ("topk",)

    def __init__(self, config: FilterConfig, device=None):
        super().__init__(config, device)
        self._heap: dict[bytes, int] = {}

    def _post_update(self, d_keys, d_lengths, B: int) -> None:
        super()._post_update(d_keys, d_lengths, B)
        if not B:
            return
        with obs.phase("kernel_query"):
            est = self._estimate(d_keys, d_lengths)
        with obs.phase("d2h"):
            est_np = _u32_host(est)
            rows = d_keys.cpu().numpy()
            lens = d_lengths.cpu().numpy()
        heap, cap = self._heap, self.config.topk
        for i in range(B):
            key = rows[i, : lens[i]].tobytes()
            count = int(est_np[i])
            if key in heap:
                heap[key] = max(heap[key], count)
            elif len(heap) < cap:
                heap[key] = count
            else:
                smallest = min(heap, key=heap.get)
                if count > heap[smallest]:
                    del heap[smallest]
                    heap[key] = count
        obs_counters.incr("topk_heap_updates", B)

    def topk_list(self) -> list:
        """``[(key bytes, estimate)]`` by estimate, largest first, then by
        key: deterministic, so that replicas agree."""
        return sorted(self._heap.items(), key=lambda kv: (-kv[1], kv[0]))

    def clear(self) -> None:
        super().clear()
        self._heap = {}

    # -- checkpoint extra block -------------------------------------------------

    def sketch_extra(self) -> dict:
        return {"topk_heap": [[k.hex(), c] for k, c in self.topk_list()]}

    def load_sketch_extra(self, extra: dict) -> None:
        heap = (extra or {}).get("topk_heap") or []
        self._heap = {bytes.fromhex(k): int(c) for k, c in heap}
