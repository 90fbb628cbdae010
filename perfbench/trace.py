"""The traced window: ``torch.profiler`` over a stretch of the loop, and what
the per-layer metrics read from its trace.

The benchmark's own spans (``record_function``) mark each call into the
program (``perfbench.<span>``, the name the configuration gives the op:
the port's wrapper), each wait for a batch (``perfbench.wait``), each
epoch's ``clear`` (``perfbench.clear``) and the stretch itself
(``perfbench.window``). A device operation (kernel, copy, memset) belongs
to the span that encloses its launch (the CUDA runtime call that the
trace links to it by correlation id).

A stretch in which the profiler saw no device operation is tried again, a
bounded number of times, and then the run fails: no idle share or
roofline is ever read from an empty window.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import tempfile
from pathlib import Path

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "perfbench.window"
ATTEMPTS = 3
TOP = 10


class EmptyTrace(RuntimeError):
    """The profiler saw no device operation in any attempt."""


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    op_device_s: dict  # span name -> device seconds of the operations it launched
    op_count: dict  # span name -> device operations it launched
    spans: dict  # span name -> how many of it the stretch holds
    device_ops: list  # [name, seconds], most first
    idle_gaps: list  # [what the host was doing, seconds], longest first


def _short(name: str) -> str:
    return name.split("(")[0].removeprefix("void ").strip()


def _merge(intervals: list) -> list:
    out: list = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


class _Spans:
    """The benchmark's spans of one thread but the window's own; they do
    not overlap."""

    def __init__(self, spans: list):
        self.spans = sorted((e for e in spans if e["name"] != WINDOW), key=lambda e: e["ts"])
        self.starts = [e["ts"] for e in self.spans]

    def at(self, ts: float) -> str | None:
        """The span that holds the time ``ts``, if one does."""
        i = bisect.bisect_right(self.starts, ts) - 1
        if i >= 0 and self.spans[i]["ts"] + self.spans[i]["dur"] >= ts:
            return self.spans[i]["name"]
        return None


def parse(events: list) -> Trace | None:
    """What the metrics read from a Chrome trace's events; None when the
    window holds no device operation."""
    window = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
              and e.get("cat") == "user_annotation"]
    if not window:
        return None
    w0, w1 = window[0]["ts"], window[0]["ts"] + window[0]["dur"]
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
              and w0 <= e["ts"] <= w1]
    if not device:
        return None
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in HOST_LAUNCH_CATS and "correlation" in e.get("args", {})}
    mine = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e.get("name", "").startswith("perfbench.")]
    by_thread: dict = {}
    for e in mine:
        by_thread.setdefault((e["pid"], e["tid"]), []).append(e)
    spans = {key: _Spans(v) for key, v in by_thread.items()}
    main = spans[(window[0]["pid"], window[0]["tid"])]
    op_s: dict = {}
    op_n: dict = {}
    per_name: dict = {}
    for e in device:
        dur = e["dur"] / 1e6
        per_name[_short(e["name"])] = per_name.get(_short(e["name"]), 0.0) + dur
        host = launches.get(e.get("args", {}).get("correlation"))
        owner = None
        if host is not None and (host["pid"], host["tid"]) in spans:
            owner = spans[(host["pid"], host["tid"])].at(host["ts"])
        owner = owner or "unattributed"
        op_s[owner] = op_s.get(owner, 0.0) + dur
        op_n[owner] = op_n.get(owner, 0) + 1
    busy = _merge([(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in device])
    busy_s = sum(hi - lo for lo, hi in busy) / 1e6
    gaps = []
    edge = w0
    for lo, hi in [*busy, (w1, w1)]:
        if lo > edge:
            doing = main.at((edge + lo) / 2) or "perfbench.between_calls"
            gaps.append([doing, (lo - edge) / 1e6])
        edge = max(edge, hi)
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(([k, v] for k, v in per_name.items()), key=lambda kv: -kv[1])
    counts: dict = {}
    for e in main.spans:
        counts[e["name"]] = counts.get(e["name"], 0) + 1
    return Trace(window_s=(w1 - w0) / 1e6, busy_s=busy_s, op_device_s=op_s, op_count=op_n,
                 spans=counts, device_ops=ops[:TOP], idle_gaps=gaps[:TOP])


def traced(loop, seconds: float):
    """Run the loop for ``seconds`` under the profiler, from and to an
    empty queue, up to :data:`ATTEMPTS` times until the trace holds a
    device operation. Returns (trace, the stretches' windows)."""
    stretches = []
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory(prefix="perfbench-trace-") as tmp:
        for attempt in range(ATTEMPTS):
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            with torch.profiler.record_function(WINDOW):
                stretches.append(loop.run(seconds, annotate=True))
            torch.cuda.synchronize()
            prof.stop()
            path = Path(tmp) / f"attempt{attempt}.json"
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text()).get("traceEvents", [])
            path.unlink()
            found = parse(events)
            if found is not None:
                return found, stretches, attempt + 1
    raise EmptyTrace(f"the profiler saw no device operation in {ATTEMPTS} windows")


def warm_profiler() -> None:
    """Start and stop the profiler once, so that its first start (CUPTI's
    set-up) falls in the run's set-up and not in its window."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
