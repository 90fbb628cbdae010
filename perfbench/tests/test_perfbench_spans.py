"""The port's ranges in a traced stretch (``perfbench/spans.py``): on a
hand-built trace, the three metrics read hand-computed values, and the
harness's own reading (``perfbench/trace.py`` and every metric it feeds)
is the same with and without the port's ranges in the events."""

import dataclasses

import pytest

from perfbench import harness, spans
from perfbench import trace as tracing

CALLS = ("perfbench.flat_query",)


def _x(name, ts, dur, cat="user_annotation", pid=1, tid=1, **args):
    e = {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur}
    if args:
        e["args"] = args
    return e


def _events(port=True):
    """A window of 1000 us: a clear at 20-60, two queries at 100-300 and
    500-700 with a wait between; on the card, operations at 0-180,
    200-250 (launched at 200), 320-560 and 600-980 (launched at 600), so
    the card is idle at 180-200, 250-320 (which only partly overlaps the
    first call's enqueue, 160-260), 560-600 and 980-1000."""
    ev = [
        _x("perfbench.window", 0, 1000),
        _x("perfbench.clear", 20, 40),
        _x("perfbench.flat_query", 100, 200),
        _x("cudaLaunchKernel", 200, 2, cat="cuda_runtime", correlation=1),
        _x("perfbench.wait", 300, 200),
        _x("perfbench.flat_query", 500, 200),
        _x("cudaLaunchKernel", 600, 2, cat="cuda_runtime", correlation=2),
        _x("void k0(int)", 0, 180, cat="kernel", pid=0, tid=7, correlation=99),
        _x("void flat_query_kernel<1>(int)", 200, 50, cat="kernel", pid=0, tid=7, correlation=1),
        _x("Memset (Device)", 320, 240, cat="gpu_memset", pid=0, tid=7, correlation=98),
        _x("void flat_query_kernel<1>(int)", 600, 380, cat="kernel", pid=0, tid=7, correlation=2),
    ]
    if port:  # the port's ranges are cpu_op events, as torch files its fast ranges
        p = "tpubloom_torch."
        ev += [_x(p + name, ts, dur, cat="cpu_op") for name, ts, dur in [
            ("filter.clear", 30, 20),
            ("filter.include_arrays", 110, 180),
            ("sweep.flat_query", 120, 160),
            ("sweep.plan", 130, 10),
            ("sweep.alloc", 140, 10),
            ("sweep.enqueue", 160, 100),
            ("filter.include_arrays", 505, 190),
            ("sweep.flat_query", 510, 180),
            ("sweep.plan", 520, 5),
            ("sweep.alloc", 525, 5),
            ("sweep.enqueue", 540, 100),
        ]]
    return ev


def test_the_three_metrics_on_a_hand_built_trace():
    sp = spans.parse(_events(), CALLS)
    m = spans.metrics(sp)
    # wrappers 160 + 180 us, enqueues 100 + 100, over two calls
    assert m["sweep.prep_us"] == pytest.approx(70.0)
    assert m["sweep.enqueue_us"] == pytest.approx(100.0)
    # idle 20 + 70 + 40 + 20 = 150 us; inside the port's ranges 20 + 40 + 40
    # (of the gap at 250-320, the 40 us before the first call's
    # include_arrays ends, 10 of them in its enqueue)
    assert sp.idle_s == pytest.approx(150e-6)
    assert m["device.idle_in_port_pct"] == pytest.approx(10.0)
    # the clear's range lies in no call; self time of the wrappers:
    # 160 - 120 and 180 - 110
    assert "tpubloom_torch.filter.clear" not in sp.count
    assert sp.count["tpubloom_torch.sweep.enqueue"] == 2 and sp.calls == 2
    assert sp.self_seconds["tpubloom_torch.sweep.flat_query"] == pytest.approx(110e-6)
    assert sp.self_seconds["tpubloom_torch.filter.include_arrays"] == pytest.approx(30e-6)
    gap, held = sp.idle_gaps[0]
    assert gap == pytest.approx(70e-6)
    assert held == pytest.approx({"tpubloom_torch.filter.include_arrays": 40e-6,
                                  "tpubloom_torch.sweep.flat_query": 30e-6,
                                  "tpubloom_torch.sweep.enqueue": 10e-6})
    report = spans.report(sp)
    assert report["calls"] == {"perfbench.flat_query": {"count": 2, "mean_us": pytest.approx(200.0)}}
    assert report["device_idle_pct"] == pytest.approx(15.0)


@pytest.mark.parametrize("events", [_events(), _events(port=False),
                                    [e for e in _events() if e["name"] != "perfbench.window"]],
                         ids=["with the port's ranges", "without", "no window"])
def test_idle_in_the_port_is_never_above_the_idle(events):
    sp = spans.parse(events, CALLS)
    t = tracing.parse(events)
    if sp is None:
        assert t is None
        return
    idle_pct = harness.reader("device.idle_pct")(harness.View(None, t, {}, 0.0, CALLS))
    assert sp.idle_s / sp.window_s * 100 == pytest.approx(idle_pct)
    in_port = spans.metrics(sp)["device.idle_in_port_pct"]
    assert in_port is None or 0.0 <= in_port <= idle_pct


def test_a_trace_without_the_ports_ranges_reads_nothing():
    """A tree whose port puts no ranges on the trace: each metric None."""
    assert spans.metrics(spans.parse(_events(port=False), CALLS)) == {
        "sweep.prep_us": None, "sweep.enqueue_us": None, "device.idle_in_port_pct": None}
    assert spans.metrics(None)["sweep.prep_us"] is None


def _existing_per_layer():
    import json

    with open(harness.REPO / "BENCHMARK.json") as f:
        return [m["name"] for m in json.load(f)["per_layer"] if m["source"] == "device_trace"]


def test_the_harness_reads_the_same_trace_fields_with_the_ports_ranges():
    with_port, without = tracing.parse(_events()), tracing.parse(_events(port=False))
    assert dataclasses.asdict(with_port) == dataclasses.asdict(without)


@pytest.mark.parametrize("metric", _existing_per_layer())
def test_each_trace_metric_reads_the_same_with_the_ports_ranges(metric):
    read = harness.reader(metric)
    bound = {"flat_query": 50e-6, "flat_insert": 1e-6, "blocked_query": 1e-6,
             "blocked_test_insert": 1e-6}
    views = [harness.View(None, tracing.parse(ev), bound, 0.0, CALLS)
             for ev in (_events(), _events(port=False))]
    assert read(views[0]) == read(views[1])
