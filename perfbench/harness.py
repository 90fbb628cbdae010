"""One run of one cell: set-up, warm-up, the measured window, the
comparison with the reference, and the contract's result.

Everything a cell is made of is found by name from ``BENCHMARK.json``:
its configuration's file (which names the port's filter class, its state,
its reference module ``reference/<name>.py`` and the span each op's calls
go under), its mix (``traffic/<mix>.json``), the op modules its mix names
(``ops/<op>.py``) and a reader for each metric (``metrics/<metric>.py``, a
``read(view)`` that returns a number or None).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from perfbench import gen, judge, window
from perfbench import trace as tracing
from perfbench.reference import bounds, family
from perfbench.target import TARGETS

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
#: Seconds of warm-up at least, and epochs at least, before a window.
WARM_SECONDS, WARM_EPOCHS = 1.0, 2
#: Seconds of a traced stretch (``--trace 1``), at most half the window.
TRACE_SECONDS = 1.0
#: Top-level module names that may not be loaded once the window has
#: closed: JAX and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "tpubloom")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # metric entries of BENCHMARK.json this cell reports
    per_layer: list


def load_cell(name: str) -> Cell:
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"perfbench: no workload {name!r} in BENCHMARK.json")
    config = next(c for c in spec["configs"] if c["name"] == cell["config"])

    def mine(metric: dict) -> bool:
        return name in metric.get("workloads", [name])

    return Cell(
        name=name, chips=int(cell["chips"]),
        config=json.loads((REPO / config["file"]).read_text()),
        traffic=json.loads((ROOT / "traffic" / f"{cell['traffic']}.json").read_text()),
        end_to_end=[m for m in spec["end_to_end"] if mine(m)],
        per_layer=[m for m in spec["per_layer"] if mine(m)],
    )


def reader(metric: str):
    """The ``read`` of ``metrics/<metric>.py``."""
    path = ROOT / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclasses.dataclass
class View:
    """What a metric's reader reads."""

    window: window.Window  # the window outside the profiler (all of it in an untraced run)
    trace: tracing.Trace | None
    bound_s: dict  # span name -> the least seconds of its traced calls
    setup_s: float
    calls: tuple = ()  # the trace's names of the cell's calls into the program

    def roofline(self, kernel: str) -> float | None:
        """The share (%) of the least time in the device time of the
        kernel's traced calls; None where none ran."""
        spent = (self.trace.op_device_s.get(f"perfbench.{kernel}", 0.0)
                 if self.trace is not None else 0.0)
        if spent <= 0 or kernel not in self.bound_s:
            return None
        return 100.0 * self.bound_s[kernel] / spent


def device_info(device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    import subprocess

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "-i", "0"], capture_output=True, text=True, timeout=30, check=True)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        info["power_limit_w"] = None
    return info


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool, device, t0: float,
             target: str = "program") -> dict:
    """One run; returns the contract's result (without printing it)."""
    L = int(cell.config["params"]["key_len"])
    ops = {s["op"]: importlib.import_module(f"perfbench.ops.{s['op']}") for s in cell.traffic["epoch"]}
    spans = {op: cell.config["spans"][op] for op in ops}
    ref = family(cell.config["reference"])
    marks = {"start": time.perf_counter() - t0}
    dev_info = device_info(device, cell.chips)
    marks["device"] = time.perf_counter() - t0
    prog = TARGETS[target](cell.config, device)
    marks["target"] = time.perf_counter() - t0
    fill = gen.make_fill(cell.traffic, L, seed, device)
    steps = gen.make_epoch(cell.traffic, L, seed, device, fill)
    marks["keys"] = time.perf_counter() - t0
    if fill is not None:
        insert = importlib.import_module("perfbench.ops.insert")
        for j in range(fill.n_batches):
            prog.call(insert, fill.keys[j], fill.lengths[j], fill.n_valid[j])
        fill = None  # made again from the seed for the reference
    marks["fill"] = time.perf_counter() - t0
    loop = window.Loop(prog, steps, ops, inflight=int(cell.traffic["inflight"]),
                       clear_each_epoch=bool(cell.traffic.get("clear_each_epoch")),
                       spans=spans, device=device, sample_seed=gen.sub_seed(seed, "sample"))
    warm = window.Window()
    while warm.seconds < WARM_SECONDS or loop.epochs < WARM_EPOCHS:
        warm.add(loop.run(0.05))
    marks["warm"] = time.perf_counter() - t0
    if trace and device.type == "cuda":
        tracing.warm_profiler()
    loop.reset_sample()
    if device.type == "cuda":
        torch.cuda.synchronize()
    # the collector stays on in the window; what set-up made is collected
    # and frozen, so that the window's collections do not walk it again
    gc.collect()
    gc.freeze()
    collections = [g["collections"] for g in gc.get_stats()]
    setup_s = time.perf_counter() - t0
    marks["profiler"] = setup_s

    # the measured window: the stretch that the host-side metrics read, and
    # in a traced run then the profiler's stretch, so that nothing the
    # profiler leaves behind falls in the first
    traced_s = min(TRACE_SECONDS, seconds / 2) if trace else 0.0
    untraced = loop.run(seconds - traced_s)
    total, found, attempts, traced_issues = window.Window(), None, 0, ()
    total.add(untraced)
    if trace:
        found, stretches, attempts = tracing.traced(loop, traced_s)
        for s in stretches:
            total.add(s)
        traced_issues = stretches[-1].issued  # the stretch whose trace was read
    in_window = [g["collections"] - c for g, c in zip(gc.get_stats(), collections)]
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    bad = forbidden_modules()

    # the comparison, once the window has closed
    t_ref = time.perf_counter()
    count = {int(p) for p in traced_issues}
    compared, done = judge.replay(
        ref, cell.config["params"], ops, gen.make_fill(cell.traffic, L, seed, device), steps,
        device=device, sample=loop.sample, state_at=loop.done_in_epoch,
        program_state=prog.state_bytes(), count_work=count)
    ref_s = time.perf_counter() - t_ref

    bound_s: dict = {}
    peak_table = bounds.peaks(dev_info["kind"])
    schedule = loop.schedule
    for p in traced_issues if peak_table is not None else ():
        name = spans[steps[schedule[p][0]].op]
        bound_s[name] = bound_s.get(name, 0.0) + bounds.least_seconds(*done[int(p)], peak_table)
    view = View(untraced if trace else total, found, bound_s, setup_s, tuple(loop.labels.values()))
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = reader(m["name"])(view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = dict(dev_info, memory_peak_bytes=int(peak))
    if found is not None:
        dev.update(busy_s=found.busy_s, window_s=found.window_s)
    correct = not bad and all(compared[k] is not None and compared[k] <= lim
                              for k, lim in judge.LIMITS.items())
    result = {"correct": correct, "attempted": total.batches, "failed": 0, "metrics": metrics,
              "device": dev}
    if found is not None:
        result["breakdown"] = {"device_ops": found.device_ops, "idle_gaps": found.idle_gaps}
    result["run"] = {"setup_s": setup_s, "setup_marks_s": marks, "reference_s": ref_s,
                     "window_s": total.seconds, "batches": total.batches, "keys": total.keys, "epochs": loop.epochs,
                     "trace_attempts": attempts, "forbidden_modules": bad,
                     "sampled_batches": len(loop.sample), "state_at": loop.done_in_epoch,
                     "gc_collections": in_window,  # in the window, by generation
                     "latency_ms": _quantiles(total.latencies)}
    result["compared"] = {k: {"value": compared[k], "limit": lim} for k, lim in judge.LIMITS.items()}
    return result


def _quantiles(latencies: np.ndarray) -> dict:
    """A few quantiles of the batches' latencies (ms), for the record."""
    if not latencies.size:
        return {}
    ms = np.asarray(latencies) * 1e3
    qs = (50, 90, 94, 95, 96, 99, 100)
    return {f"p{q}": float(v) for q, v in zip(qs, np.percentile(ms, qs))}
