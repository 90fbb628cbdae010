"""Every cell driven end to end on the CPU at a tiny size, through the
port's plain versions: its set-up, the result line, the control and each
fault of the timed path that the cell can have, which have to come out as
not correct; the traced window's reading; what a run may not load."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from perfbench import harness, target
from perfbench import trace as tracing
from perfbench.tests.conftest import REPO, SEED, cell_names, gpu_device, shrink

CELLS = cell_names()


@pytest.fixture(autouse=True)
def short_warm_up(monkeypatch):
    monkeypatch.setattr(harness, "WARM_SECONDS", 0.05)


def run(name, device, **kw):
    cell = shrink(harness.load_cell(name))
    return harness.run_cell(cell, seed=SEED, seconds=0.3, trace=False, device=device,
                            t0=time.perf_counter(), **kw)


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_with_the_contract_line(name, cpu):
    r = run(name, cpu)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "compared"
    assert r["correct"] is True, r["compared"]
    assert r["attempted"] > 0 and r["failed"] == 0
    cell = harness.load_cell(name)
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        assert r["metrics"][m["name"]]["unit"] == m["unit"]
        assert r["metrics"][m["name"]]["value"] > 0
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert r["run"]["sampled_batches"] > 0
    json.dumps(r)


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, cpu):
    r = run(name, cpu, target="control")
    assert r["correct"] is False
    assert r["compared"]["state_bytes_differ"]["value"] > 0


def _unchanged(orig):
    def call(self, op, keys, lengths, n_valid):  # answers, and leaves the state as it was
        return self.filter.include_arrays(keys, lengths) if op.ANSWERS else None
    return call


def _half(orig):
    def call(self, op, keys, lengths, n_valid):  # the second half of the batch left out
        h = keys.shape[0] // 2
        out = orig(self, op, keys[:h], lengths[:h], min(n_valid, h))
        return None if out is None else torch.cat([out, torch.zeros(keys.shape[0] - h, dtype=torch.bool)])
    return call


def _altered(orig):
    def call(self, op, keys, lengths, n_valid):  # one answer, or one key, altered where made
        if op.ANSWERS:
            out = orig(self, op, keys, lengths, n_valid).clone()
            out[0] = ~out[0]
            return out
        keys = keys.clone()
        keys[0, 0] ^= 1
        return orig(self, op, keys, lengths, n_valid)
    return call


FAULTS = {"unchanged": _unchanged, "half": _half, "altered": _altered}


def _faults_a_cell_can_have():
    """Each cell with each fault it can have: a cell that only queries
    changes no state, so it cannot leave a change out."""
    for name in CELLS:
        sets = any(s["op"] != "query" for s in harness.load_cell(name).traffic["epoch"])
        for fault in sorted(FAULTS):
            if sets or fault != "unchanged":
                yield name, fault


@pytest.mark.parametrize("name, fault", list(_faults_a_cell_can_have()))
def test_a_broken_timed_path_is_not_correct(name, fault, cpu, monkeypatch):
    monkeypatch.setattr(target.Program, "call", FAULTS[fault](target.Program.call))
    assert run(name, cpu)["correct"] is False


def _events(device=True):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "perfbench.window", "pid": 1, "tid": 1, "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "perfbench.blocked_query", "pid": 1, "tid": 1, "ts": 5, "dur": 10},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 1, "ts": 8, "dur": 2,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "user_annotation", "name": "perfbench.wait", "pid": 1, "tid": 1, "ts": 16, "dur": 60},
    ]
    if device:
        ev += [
            {"ph": "X", "cat": "kernel", "name": "void blocked_query_kernel<4>(int)", "pid": 0, "tid": 7,
             "ts": 20, "dur": 40, "args": {"correlation": 7}},
            {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "pid": 0, "tid": 7, "ts": 70, "dur": 10,
             "args": {"correlation": 99}},
        ]
    return ev


def test_trace_reading_on_a_hand_built_trace():
    t = tracing.parse(_events())
    assert t.window_s == 100e-6 and t.busy_s == pytest.approx(50e-6)
    assert t.op_device_s == pytest.approx({"perfbench.blocked_query": 40e-6, "unattributed": 10e-6})
    assert t.device_ops[0] == ["blocked_query_kernel<4>", pytest.approx(40e-6)]
    # gaps by what the host did at their middle: 0-20 in the call, 60-70 in
    # the wait, 80-100 after it
    assert sorted((g[0], round(g[1] * 1e6)) for g in t.idle_gaps) == [
        ("perfbench.between_calls", 20), ("perfbench.blocked_query", 20), ("perfbench.wait", 10)]
    assert t.op_count == {"perfbench.blocked_query": 1, "unattributed": 1}
    assert t.spans == {"perfbench.blocked_query": 1, "perfbench.wait": 1}
    view = harness.View(None, t, {"blocked_query": 10e-6}, 0.0, ("perfbench.blocked_query",))
    assert view.roofline("blocked_query") == pytest.approx(25.0)
    assert view.roofline("flat_query") is None
    assert harness.reader("sweep.launches_per_batch")(view) == 1.0
    assert harness.reader("entry.clear_device_us")(view) is None  # no clear in the stretch


def test_launches_and_clear_read_from_the_trace():
    """Three calls that launch two operations each and one clear's memset:
    two launches a call, the clear's device time over the clears."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "perfbench.window", "pid": 1, "tid": 1, "ts": 0,
           "dur": 1000}]
    spans = [("perfbench.clear", 0)] + [("perfbench.flat_insert", 100 * (i + 1)) for i in range(3)]
    for c, (name, ts) in enumerate(spans):
        ev.append({"ph": "X", "cat": "user_annotation", "name": name, "pid": 1, "tid": 1, "ts": ts, "dur": 50})
        for n in range(1 if name == "perfbench.clear" else 2):
            corr = 10 * c + n
            ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 1,
                       "ts": ts + 10 + n, "dur": 1, "args": {"correlation": corr}})
            ev.append({"ph": "X", "cat": "gpu_memset" if name == "perfbench.clear" else "kernel",
                       "name": "k", "pid": 0, "tid": 7, "ts": ts + 20 + 5 * n, "dur": 4,
                       "args": {"correlation": corr}})
    t = tracing.parse(ev)
    view = harness.View(None, t, {}, 0.0, ("perfbench.flat_insert", "perfbench.flat_query"))
    assert harness.reader("sweep.launches_per_batch")(view) == 2.0
    assert harness.reader("entry.clear_device_us")(view) == pytest.approx(4.0)


def test_the_loop_makes_no_tracked_object_a_batch():
    """Python's collector is on in the window, so the loop's own garbage
    would be measured as the program's: it makes none a batch."""
    import gc

    from perfbench import window

    class Nothing:
        ANSWERS = SETS = False

    class Target:
        def call(self, op, keys, lengths, n_valid):
            return None

        def clear(self):
            pass

    class Step:
        op, keys, lengths, n_valid, n_batches = "nothing", [None] * 4, [None] * 4, [3] * 4, 4

    loop = window.Loop(Target(), [Step()], {"nothing": Nothing}, inflight=2, clear_each_epoch=True,
                       spans={"nothing": "nothing"}, device=torch.device("cpu"), sample_seed=1)
    loop.run(0.01)
    gc.collect()
    gc.disable()
    try:
        before = gc.get_count()[0]
        w = loop.run(0.2)
        grown = gc.get_count()[0] - before
    finally:
        gc.enable()
    assert w.batches > 1000 and w.keys == 3 * w.batches
    assert grown < 50, grown


def test_an_empty_profiler_window_is_retried_then_fails(monkeypatch, tmp_path):
    """No device event in any attempt: the run fails, and reads no idle
    share or roofline from the empty window."""
    tries = []

    class Prof:
        def __init__(self, **kw):
            pass

        def start(self):
            tries.append(1)

        def stop(self):
            pass

        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                json.dump({"traceEvents": _events(device=False)}, f)

    class Loop:
        def run(self, seconds, annotate=False):
            return harness.window.Window()

    monkeypatch.setattr(torch.profiler, "profile", Prof)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    assert tracing.parse(_events(device=False)) is None
    with pytest.raises(tracing.EmptyTrace):
        tracing.traced(Loop(), 0.01)
    assert len(tries) == tracing.ATTEMPTS


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, time, torch; sys.path.insert(0, %r)\n"
            "from perfbench import harness\n"
            "from perfbench.tests.conftest import shrink\n"
            "r = harness.run_cell(shrink(harness.load_cell('flat.url-dedup')), seed=3, seconds=0.1,"
            " trace=False, device=torch.device('cpu'), t0=time.perf_counter())\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'tpubloom'}),"
            " r['correct'])\n" % REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=REPO, env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[-2] == "[] True"


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpubloom_torch_lookalike", object())
    assert "tpubloom" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax"]


def test_without_a_card_the_command_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", CELLS[0], "--seed", str(SEED),
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=REPO)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name):
    gpu_device()
    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", name, "--seed", str(SEED),
                          "--seconds", "2", "--trace", "1"], capture_output=True, text=True, timeout=400,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
