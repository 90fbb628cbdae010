"""The port's own profiler ranges in a traced stretch, and the three
per-layer metrics they give.

While ``torch.profiler`` records, ``tpubloom_torch`` puts ranges named
``tpubloom_torch.<name>`` on the trace (``tpubloom_torch/obs/context.py``;
the names are declared in ``tpubloom_torch/obs/names.py``): a filter
entry point ``filter.<method>``, a kernel wrapper's call
``sweep.<wrapper>`` with its children ``sweep.plan``, ``sweep.alloc`` and
``sweep.enqueue``, and ``phase.<name>``. From the events of one traced
stretch, :func:`parse` reads, on the window's thread:

* per range name, its count, its seconds and its self seconds (less the
  ranges directly inside it), counting only ranges that lie inside one of
  the cell's calls (a ``perfbench.<op>`` span; so an epoch's ``clear`` is
  left out);
* the idle seconds of the card that the port's ranges overlap (interval
  overlap of the device's idle stretches with the union of every
  ``tpubloom_torch.`` range on that thread), beside the window's own idle.

The metrics (:func:`metrics`; None where the trace holds no range of the
port, as a tree without them gives):

* ``sweep.prep_us`` (us): mean host time a cell call spends in its
  ``sweep.<wrapper>`` ranges outside their ``sweep.enqueue`` children:
  the tensor checks, the plan, the allocations;
* ``sweep.enqueue_us`` (us): mean host time a cell call spends in
  ``sweep.enqueue``: the device guard, the stream and the C entry, with
  its runtime calls and launches;
* ``device.idle_in_port_pct`` (%): share of the window in which no
  device operation ran while the window's thread was inside a range of
  the port; ``device.idle_pct`` less this is the idle that the harness,
  the profiler or the collector holds.

``perfbench/trace.py`` hands the metric readers none of this yet. Until it
does, this module runs a cell as ``perfbench.run --trace 1`` does and
reads the split from the same trace:

    python3 -m perfbench.spans --workload <name> --seed <n> --seconds <s>

prints ``perfbench.run``'s result line, then one line of JSON with the
split (:func:`report`). Run it from the root of a checkout on the card.
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import sys

from perfbench import run  # first: a run's set-up is timed from its import
from perfbench import trace as tracing

PORT = "tpubloom_torch."
#: the trace's categories of host ranges: the harness's spans are
#: ``user_annotation`` (``record_function``), the port's ``cpu_op`` (its
#: ranges take torch's fast C++ path to the same ``RecordFunction``)
HOST_CATS = ("user_annotation", "cpu_op")
WRAPPER = PORT + "sweep."
ENQUEUE = WRAPPER + "enqueue"
#: the wrapper ranges' children: every other ``sweep.`` range is a wrapper
CHILDREN = frozenset(WRAPPER + c for c in ("plan", "alloc", "enqueue"))
#: slack (us) of the trace's rounding when one range is held to lie inside another
SLACK_US = 1e-3
TOP = 10


@dataclasses.dataclass
class Spans:
    calls: int  # the cell's calls on the window's thread
    ranges: int  # the port's ranges on that thread, inside the calls or not
    call_s: dict  # call name -> [count, seconds]
    count: dict  # range name -> count, inside the calls
    seconds: dict  # range name -> seconds, inside the calls
    self_seconds: dict  # range name -> seconds less the ranges directly inside it
    window_s: float
    idle_s: float  # no device operation
    idle_in_port_s: float  # no device operation, inside a range of the port
    idle_gaps: list  # [gap seconds, {range: seconds of overlap}], longest first


def _inside(inner: dict, outer: dict) -> bool:
    return (inner["ts"] >= outer["ts"] - SLACK_US
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + SLACK_US)


def _overlap(a: list, b: list) -> float:
    """The length that two sorted lists of disjoint intervals share."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def parse(events: list, calls) -> Spans | None:
    """The port's ranges in a Chrome trace's events; ``calls``: the names
    of the cell's calls (``perfbench.<op>``). None where the trace has no
    window or no device operation, as :func:`perfbench.trace.parse`."""
    window = [e for e in events if e.get("name") == tracing.WINDOW and e.get("ph") == "X"
              and e.get("cat") == "user_annotation"]
    if not window:
        return None
    w = window[0]
    w0, w1, thread = w["ts"], w["ts"] + w["dur"], (w["pid"], w["tid"])
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in tracing.DEVICE_CATS
              and w0 <= e["ts"] <= w1]
    if not device:
        return None
    mine = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS
            and (e["pid"], e["tid"]) == thread and w0 <= e["ts"] <= w1]
    calls = set(calls)
    call_spans = sorted((e for e in mine if e["name"] in calls and e["cat"] == "user_annotation"),
                        key=lambda e: e["ts"])
    starts = [e["ts"] for e in call_spans]
    port = sorted((e for e in mine if e["name"].startswith(PORT)),
                  key=lambda e: (e["ts"], -e["dur"]))

    call_s: dict = {}
    for e in call_spans:
        n_s = call_s.setdefault(e["name"], [0, 0.0])
        n_s[0] += 1
        n_s[1] += e["dur"] / 1e6
    children: dict = {}  # id of a range -> us that the ranges directly inside it cover
    stack: list = []
    for e in port:
        while stack and not _inside(e, stack[-1]):
            stack.pop()
        if stack:
            children[id(stack[-1])] = children.get(id(stack[-1]), 0.0) + e["dur"]
        stack.append(e)
    count: dict = {}
    seconds: dict = {}
    self_seconds: dict = {}
    for e in port:
        i = bisect.bisect_right(starts, e["ts"] + SLACK_US) - 1
        if i < 0 or not _inside(e, call_spans[i]):
            continue
        name = e["name"]
        count[name] = count.get(name, 0) + 1
        seconds[name] = seconds.get(name, 0.0) + e["dur"] / 1e6
        self_seconds[name] = (self_seconds.get(name, 0.0)
                              + (e["dur"] - children.get(id(e), 0.0)) / 1e6)

    busy = tracing._merge([(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in device])
    idle, edge = [], w0
    for lo, hi in [*busy, (w1, w1)]:
        if lo > edge:
            idle.append((edge, lo))
        edge = max(edge, hi)
    inside = tracing._merge([(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in port])
    idle_in_port = _overlap(idle, inside)
    gaps = []
    for lo, hi in sorted(idle, key=lambda g: g[0] - g[1])[:TOP]:
        held = {}
        for e in port:
            ov = max(0.0, min(e["ts"] + e["dur"], hi) - max(e["ts"], lo))
            if ov > 0:
                held[e["name"]] = held.get(e["name"], 0.0) + ov / 1e6
        gaps.append([(hi - lo) / 1e6, held])
    return Spans(calls=len(call_spans), ranges=len(port), call_s=call_s, count=count, seconds=seconds,
                 self_seconds=self_seconds, window_s=(w1 - w0) / 1e6,
                 idle_s=sum(hi - lo for lo, hi in idle) / 1e6, idle_in_port_s=idle_in_port / 1e6,
                 idle_gaps=gaps)


def metrics(sp: Spans | None) -> dict:
    """``{metric: value}`` of the three metrics; each None where the trace
    holds no range of the port (or, for the sweep pair, no cell call)."""
    out = {"sweep.prep_us": None, "sweep.enqueue_us": None, "device.idle_in_port_pct": None}
    if sp is None:
        return out
    wrappers = sum(s for name, s in sp.seconds.items()
                   if name.startswith(WRAPPER) and name not in CHILDREN)
    if sp.calls and wrappers > 0:
        enqueue = sp.seconds.get(ENQUEUE, 0.0)
        out["sweep.prep_us"] = (wrappers - enqueue) / sp.calls * 1e6
        out["sweep.enqueue_us"] = enqueue / sp.calls * 1e6
    if sp.ranges:
        out["device.idle_in_port_pct"] = 100.0 * sp.idle_in_port_s / sp.window_s
    return out


def report(sp: Spans | None) -> dict:
    """The metrics, and what they were read from, for the record."""
    out = {"metrics": metrics(sp)}
    if sp is not None:
        out.update(
            device_idle_pct=100.0 * sp.idle_s / sp.window_s,
            calls={k: {"count": n, "mean_us": s / n * 1e6} for k, (n, s) in sp.call_s.items()},
            ranges={k: {"count": sp.count[k], "us_a_call": sp.seconds[k] / sp.calls * 1e6,
                        "self_us_a_call": sp.self_seconds[k] / sp.calls * 1e6}
                    for k in sorted(sp.count)} if sp.calls else {},
            idle_gaps=sp.idle_gaps)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench.spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    from perfbench import harness

    cell = harness.load_cell(args.workload)
    calls = {f"perfbench.{cell.config['spans'][s['op']]}" for s in cell.traffic["epoch"]}
    kept: list = []
    parse_trace = tracing.parse

    def keep(events):
        kept[:] = [events]
        return parse_trace(events)

    tracing.parse = keep  # the harness reads its trace through this name
    try:
        rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                       "--seconds", str(args.seconds), "--trace", "1"])
    finally:
        tracing.parse = parse_trace
    if rc or not kept:
        return rc or 4
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "spans": report(parse(kept[0], calls))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
