"""SLOWLOG parity: a bounded log of the slowest requests.

The reference's operators triage latency with Redis ``SLOWLOG GET`` /
``SLOWLOG RESET`` (SURVEY.md §5); this is the same workflow over the
tpubloom wire protocol. Differences from Redis, on purpose:

* the buffer keeps the N **slowest** requests seen since the last reset
  (a min-heap on duration), not the N most recent over a threshold — on
  a batch server the interesting tail is the slow one, and a burst of
  mildly-slow requests must not evict the genuinely pathological entry;
* every entry carries the client-generated request id and the per-phase
  breakdown, so a slowlog hit correlates directly with profiler spans
  (``tracing.annotate`` folds the same rid into the span name) and
  distinguishes transport-bound from kernel-bound latency on its own.

Entries are plain dicts (msgpack-ready for the ``SlowlogGet`` RPC).
"""

from __future__ import annotations

import heapq
import time
from typing import Optional

from tpubloom_torch.utils import locks


def summarize_request(method: str, req: dict) -> str:
    """Slowlog-safe one-line argument summary: key payloads become a
    count (raw keys may be sensitive and are bulky), everything else is
    shown by name."""
    parts = []
    for field, value in req.items():
        if field == "keys":
            parts.append(f"keys[{len(value)}]")
        elif field == "keys_fixed" and isinstance(value, dict):
            parts.append(
                f"keys_fixed[{value.get('n')}x{value.get('width')}B]"
            )
        elif field in ("rid",):
            continue
        elif isinstance(value, (bytes, bytearray)):
            parts.append(f"{field}=<{len(value)}B>")
        else:
            parts.append(f"{field}={value!r}")
    return f"{method} " + " ".join(parts) if parts else method


class Slowlog:
    """Thread-safe ring of the ``capacity`` slowest requests.

    ``threshold_s`` drops fast requests before they ever touch the heap
    (0.0 records everything, like Redis' slowlog-log-slower-than 0).
    """

    def __init__(self, capacity: int = 128, threshold_s: float = 0.0):
        self.capacity = capacity
        self.threshold_s = threshold_s
        self._lock = locks.named_lock("obs.slowlog")
        self._heap: list[tuple[float, int, dict]] = []
        self._next_id = 0
        self.total_recorded = 0

    def record(
        self,
        *,
        method: str,
        duration_s: float,
        rid: Optional[str] = None,
        batch: int = 0,
        args: str = "",
        phases: Optional[dict] = None,
        ts: Optional[float] = None,
    ) -> None:
        if duration_s < self.threshold_s or self.capacity <= 0:
            return
        entry = {
            "id": 0,  # assigned under the lock
            "time": ts if ts is not None else time.time(),
            "method": method,
            "rid": rid or "",
            "duration_s": duration_s,
            "batch": batch,
            "args": args,
            "phases": dict(phases or {}),
        }
        with self._lock:
            entry["id"] = self._next_id
            self._next_id += 1
            self.total_recorded += 1
            if len(self._heap) >= self.capacity:
                if duration_s <= self._heap[0][0]:
                    return  # faster than the fastest kept entry
                heapq.heapreplace(self._heap, (duration_s, entry["id"], entry))
            else:
                heapq.heappush(self._heap, (duration_s, entry["id"], entry))

    def would_record(self, duration_s: float) -> bool:
        """Whether a request of this duration would enter the ring —
        the tracing layer's "slowlog-worthy" predicate (slow
        requests are ALWAYS captured, sampled or not). Asked BEFORE
        :meth:`record` so the answer is not perturbed by the entry
        itself."""
        if duration_s < self.threshold_s or self.capacity <= 0:
            return False
        with self._lock:
            return (
                len(self._heap) < self.capacity
                or duration_s > self._heap[0][0]
            )

    def entries(self, n: Optional[int] = None) -> list[dict]:
        """Slowest first; at most ``n`` entries (all by default)."""
        with self._lock:
            ordered = sorted(self._heap, key=lambda t: (-t[0], -t[1]))
        out = [dict(e) for _, _, e in ordered]
        return out[:n] if n is not None else out

    def __len__(self) -> int:
        with self._lock:
            return len(self._heap)

    def reset(self) -> int:
        """Drop all entries; returns how many were dropped (ids keep
        counting up so post-reset entries are distinguishable)."""
        with self._lock:
            n = len(self._heap)
            self._heap.clear()
            return n
