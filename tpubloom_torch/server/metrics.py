"""Server observability: counters + latency/phase histograms.

Parity: the reference gem has no metrics; operators lean on Redis
INFO/SLOWLOG (SURVEY.md §5 "Metrics/logging/observability"). The build
equivalent pinned there: keys inserted/queried, batch sizes, kernel/request
latency, checkpoint lag, fill ratio & predicted FPR (the filter classes
provide the last two via ``stats()``).

This module holds the in-process numbers; :mod:`tpubloom_torch.obs.exposition`
renders them as a Prometheus scrape and :mod:`tpubloom_torch.obs.slowlog` keeps
the per-request tail. ``Metrics.observe_rpc`` also files the per-phase
breakdown (decode/host_prep/h2d/kernel/d2h/encode) the request context
collected, keyed ``"<method>/<phase>"``.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Optional
from tpubloom_torch.utils import locks


class LatencyHistogram:
    """Fixed log2 buckets from 1us to ~67s — O(1) observe via bit_length.

    Exemplars: each bucket remembers the NEWEST
    observation's request id — the OpenMetrics exemplar linking a
    latency bucket to the exact request behind it, which is the same
    rid the slowlog entry and the profiler span carry. One slot per
    bucket (last-write-wins): an exemplar is a breadcrumb, not a log.
    """

    BUCKETS = [2**i for i in range(27)]  # microsecond upper bounds

    def __init__(self):
        self.counts = [0] * (len(self.BUCKETS) + 1)
        self.total_us = 0
        self.n = 0
        #: bucket index -> {"rid", "value_s", "ts"} (newest observation)
        self.exemplars: dict = {}

    def observe(self, seconds: float, *, rid: Optional[str] = None) -> None:
        us = seconds * 1e6
        self.total_us += us
        self.n += 1
        # us < 2^i  <=>  int(us).bit_length() <= i, so bit_length IS the
        # bucket index (clamped into the overflow bucket) — no linear scan
        bucket = min(int(us).bit_length(), len(self.BUCKETS))
        self.counts[bucket] += 1
        if rid:
            self.exemplars[bucket] = {
                "rid": rid,
                "value_s": seconds,
                "ts": time.time(),
            }

    def cumulative(self) -> list:
        """Cumulative bucket counts (len(BUCKETS)+1, last = n) — the
        Prometheus ``le`` series."""
        out, cum = [], 0
        for c in self.counts:
            cum += c
            out.append(cum)
        return out

    def export(self) -> dict:
        return {
            "counts": list(self.counts),
            "total_us": self.total_us,
            "n": self.n,
            "exemplars": {k: dict(v) for k, v in self.exemplars.items()},
        }

    def summary(self) -> dict:
        if not self.n:
            return {"n": 0}
        out = {
            "n": self.n,
            "mean_us": self.total_us / self.n,
            "buckets_cum": self.cumulative(),
        }
        for q in (0.5, 0.99):
            target = q * self.n
            cum = 0
            for i, c in enumerate(self.counts):
                cum += c
                if cum >= target:
                    out[f"p{int(q * 100)}_us_lt"] = (
                        self.BUCKETS[i] if i < len(self.BUCKETS) else float("inf")
                    )
                    break
        return out


class Metrics:
    """Process-wide counters + per-RPC latency and phase histograms."""

    def __init__(self):
        self._lock = locks.named_lock("obs.metrics")
        self.counters: dict[str, int] = defaultdict(int)
        self.latency: dict[str, LatencyHistogram] = defaultdict(LatencyHistogram)
        #: "<method>/<phase>" -> histogram (same buckets as latency)
        self.phases: dict[str, LatencyHistogram] = defaultdict(LatencyHistogram)
        #: time spent blocked on the synchronous-replication gate:
        #: both the per-write commit barrier and the Wait RPC
        #: observe here — the latency cost of the durability knob
        self.waits = LatencyHistogram()
        #: tenant hydration latency: how long a paging fault
        #: takes to restore a WARM/COLD filter to device — the cost of
        #: multiplexing more tenants than HBM holds, and the number the
        #: --max-resident-bytes sizing runbook is calibrated against
        self.hydrations = LatencyHistogram()
        self.started_at = time.time()

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def observe_rpc(
        self,
        method: str,
        seconds: float,
        phases: Optional[dict] = None,
        rid: Optional[str] = None,
    ) -> None:
        """File one finished RPC: total latency + its phase breakdown.
        ``rid`` becomes the latency AND phase buckets' exemplar — the
        slowlog / trace correlation handle (phases
        joined in a decode or h2d outlier now names the exact
        request behind it, same as the end-to-end histogram)."""
        with self._lock:
            self.latency[method].observe(seconds, rid=rid)
            for phase_name, phase_s in (phases or {}).items():
                self.phases[f"{method}/{phase_name}"].observe(
                    phase_s, rid=rid
                )

    def observe_wait(self, seconds: float) -> None:
        """File one replica-ack wait (commit barrier or Wait RPC)."""
        with self._lock:
            self.waits.observe(seconds)

    def observe_hydration(self, seconds: float) -> None:
        """File one tenant hydration (storage paging fault)."""
        with self._lock:
            self.hydrations.observe(seconds)

    def snapshot(self) -> dict:
        from tpubloom_torch.obs import counters as global_counters

        with self._lock:
            return {
                "uptime_s": time.time() - self.started_at,
                "counters": dict(self.counters),
                "latency": {k: v.summary() for k, v in self.latency.items()},
                "phases": {k: v.summary() for k, v in self.phases.items()},
                "wait_barrier": self.waits.summary(),
                "hydration": self.hydrations.summary(),
                "process_counters": global_counters.global_counters(),
            }

    def export(self) -> dict:
        """Raw histogram data for the Prometheus renderer."""
        with self._lock:
            return {
                "uptime_s": time.time() - self.started_at,
                "counters": dict(self.counters),
                "bucket_bounds_us": list(LatencyHistogram.BUCKETS),
                "latency": {k: v.export() for k, v in self.latency.items()},
                "phases": {k: v.export() for k, v in self.phases.items()},
                "waits": self.waits.export(),
                "hydrations": self.hydrations.export(),
            }
