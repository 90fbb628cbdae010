"""The port's profiler ranges (``tpubloom_torch.obs.context``): the one
span primitive, ``Range``, behind ``phase``, ``utils.tracing.annotate``,
the filters' entry points (``tpubloom_torch.filter.<method>``) and the
kernel wrappers (``tpubloom_torch.sweep.<wrapper>`` with ``sweep.plan``,
``sweep.alloc`` and ``sweep.enqueue`` inside).

* ``recording()`` follows ``torch.profiler``'s start and stop;
* with the profiler off, a range, a phase, an annotation and a wrapper's
  call open no ``RecordFunction`` (``record_function`` and the fast range
  are patched to raise; a wrapper makes no ``Range`` either) and leave the collector's count where the
  path without ranges leaves it;
* under a CPU-only profiler the ranges nest as the calls do, a phase opens
  its range with no request active, and a request's phase accounting is
  the same with the profiler on as off;
* on the card (marked ``gpu``; skips without one), every device operation
  of a fused ``blocked_test_insert`` and of a partitioned ``flat_insert``
  is launched inside that call's ``sweep.enqueue``, by correlation id.
  This file imports no JAX, so that it runs on the card's machine:

    python -m pytest tests/test_torch_spans.py -m gpu -q --noconftest
"""

import gc
import json

import numpy as np
import pytest
import torch

from tpubloom_torch import BlockedBloomFilter, BloomFilter, FilterConfig
from tpubloom_torch.obs import context as obs
from tpubloom_torch.ops import bitops, blocked, sweep
from tpubloom_torch.utils import tracing

L = 16
FLAT = FilterConfig(m=1 << 15, k=4, key_len=L)
BLOCKED = FilterConfig(m=1 << 16, k=7, key_len=L, block_bits=512)
CPU_ONLY = [torch.profiler.ProfilerActivity.CPU]


def _keys(n, device="cpu", seed=0):
    rng = np.random.default_rng(seed)
    keys = torch.from_numpy(rng.integers(0, 256, (n, L), dtype=np.uint8)).to(device)
    return keys, torch.full((n,), L, dtype=torch.int32, device=device)


def _trace(fn, tmp_path, activities=CPU_ONLY) -> list:
    with torch.profiler.profile(activities=activities) as prof:
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def _ranges(events, name):
    """The host's ranges of that name: the port's are ``cpu_op`` events (a
    ``record_function``'s are ``user_annotation``, and on the card also
    copied onto the device's timeline as ``gpu_user_annotation``)."""
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "user_annotation")
            and e.get("name") == name]


def _inside(inner, outer) -> bool:
    return ((inner["pid"], inner["tid"]) == (outer["pid"], outer["tid"])
            and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_recording_follows_the_profiler():
    assert not obs.recording()
    with torch.profiler.profile(activities=CPU_ONLY):
        assert obs.recording()
    assert not obs.recording()
    prof = torch.profiler.profile(activities=CPU_ONLY)
    prof.start()
    try:
        assert obs.recording()
    finally:
        prof.stop()
    assert not obs.recording()


# -- the profiler off: a flag read, no record_function, nothing left behind -------


def _flat_state():
    return torch.zeros(FLAT.n_words, dtype=torch.int32).view(torch.uint32)


def _blocked_state():
    words = BLOCKED.n_blocks * BLOCKED.words_per_block
    return torch.zeros(words, dtype=torch.int32).view(torch.uint32)


def _off_cases():
    """(name, the call with ranges, the same work without them)."""
    keys, lengths = _keys(64)
    flat, blk = _flat_state(), _blocked_state()

    def range_():
        with obs.Range("tpubloom_torch.sweep.plan") as r:
            r.child("tpubloom_torch.sweep.enqueue")

    def phase():
        with obs.phase("host_prep"):
            pass

    def annotate():
        with tracing.annotate("batch", batch=64):
            pass

    def nothing():
        pass

    def flat_query_plain():
        sweep._check(flat, keys, lengths, FLAT, flat=True)
        return bitops.flat_query_plain(flat, keys, lengths, FLAT, None)

    def test_insert_plain():
        sweep._check(blk, keys, lengths, BLOCKED)
        return blocked.blocked_test_insert_plain(blk, keys, lengths, BLOCKED)

    return {
        "range": (range_, nothing),
        "phase": (phase, nothing),
        "annotate": (annotate, nothing),
        "flat_query": (lambda: sweep.flat_query(flat, keys, lengths, FLAT), flat_query_plain),
        "blocked_test_insert": (lambda: sweep.blocked_test_insert(blk, keys, lengths, BLOCKED),
                                test_insert_plain),
    }


def _gc_growth(fn, n=300) -> int:
    """How far ``n`` more calls move the collector's youngest count (a
    run of ``2 n`` against one of ``n``, so that what a run leaves once,
    whatever its length, cancels)."""
    fn()

    def run(calls):
        gc.collect()
        gc.disable()
        try:
            before = gc.get_count()[0]
            for _ in range(calls):
                fn()
            return gc.get_count()[0] - before
        finally:
            gc.enable()

    return run(2 * n) - run(n)


@pytest.mark.parametrize("name", ["range", "phase", "annotate", "flat_query", "blocked_test_insert"])
def test_off_the_profiler_no_record_function_and_no_garbage(name, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range opened with the profiler off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    with_ranges, without = _off_cases()[name]
    if name in ("flat_query", "blocked_test_insert"):  # a wrapper makes no range at all
        monkeypatch.setattr(obs, "Range", refuse)
    assert not obs.recording()
    assert _gc_growth(with_ranges) == _gc_growth(without)


# -- the profiler on (CPU): the ranges nest as the calls do -------------------------


def _nesting_cases():
    """(outer range, inner range, the calls)."""
    def flat():
        return BloomFilter(FLAT, device="cpu")

    def blk():
        return BlockedBloomFilter(BLOCKED, device="cpu")

    keys, lengths = _keys(64)
    rows = keys.numpy()
    return {
        "include_arrays": ("filter.include_arrays", "sweep.flat_query",
                           lambda: flat().include_arrays(keys, lengths)),
        "insert_arrays": ("filter.insert_arrays", "sweep.flat_insert",
                          lambda: flat().insert_arrays(keys, lengths, n_valid=60)),
        "host_prep": ("filter.insert_batch", "phase.host_prep",
                      lambda: flat().insert_batch([b"a", b"b"])),
        "test_insert": ("phase.kernel", "sweep.blocked_test_insert",
                        lambda: blk().insert_batch([b"a"], return_presence=True)),
        "insert_packed": ("filter.insert_packed", "filter.launch_insert",
                          lambda: blk().insert_packed(rows)),
        "include_packed": ("filter.include_packed", "filter.stage_batch",
                           lambda: blk().include_packed(rows)),
        "clear": ("filter.clear", None, lambda: blk().clear()),
    }


@pytest.mark.parametrize("case", ["include_arrays", "insert_arrays", "host_prep", "test_insert",
                                  "insert_packed", "include_packed", "clear"])
def test_ranges_nest_in_a_cpu_trace(case, tmp_path):
    outer, inner, call = _nesting_cases()[case]
    assert obs.current() is None  # the phases' ranges need no request
    events = _trace(call, tmp_path)
    (o,) = _ranges(events, "tpubloom_torch." + outer)  # once: no range doubles
    if inner is not None:
        (i,) = _ranges(events, "tpubloom_torch." + inner)
        assert _inside(i, o)


@pytest.mark.parametrize("profiled", [False, True], ids=["profiler off", "profiler on"])
def test_a_requests_phases_are_the_same_under_the_profiler(profiled, tmp_path):
    f = BlockedBloomFilter(BLOCKED, device="cpu")
    with obs.request("InsertBatch") as ctx:
        if profiled:
            _trace(lambda: f.insert_batch([b"a", b"b"], return_presence=True), tmp_path)
        else:
            f.insert_batch([b"a", b"b"], return_presence=True)
    assert set(ctx.phases) == {"host_prep", "h2d", "kernel", "d2h"}
    assert all(v > 0 for v in ctx.phases.values())


def test_a_child_range_switches_and_closes_with_its_parent(tmp_path):
    def call():
        with obs.Range("tpubloom_torch.sweep.flat_query") as r:
            r.child("tpubloom_torch.sweep.plan")
            r.child("tpubloom_torch.sweep.alloc")
            r.child(None)
            r.child("tpubloom_torch.sweep.enqueue")

    events = _trace(call, tmp_path)
    (w,) = _ranges(events, "tpubloom_torch.sweep.flat_query")
    kids = [_ranges(events, "tpubloom_torch.sweep." + c)[0] for c in ("plan", "alloc", "enqueue")]
    assert all(_inside(k, w) for k in kids)
    assert kids[0]["ts"] + kids[0]["dur"] <= kids[1]["ts"] + 1e-3
    assert kids[1]["ts"] + kids[1]["dur"] <= kids[2]["ts"] + 1e-3


# -- on the card: every device operation launched inside sweep.enqueue -------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels have no interpret mode)")
    return torch.device("cuda")


def _fused_test_insert(dev):
    config = FilterConfig(m=1 << 24, k=7, key_len=L, block_bits=512)
    B = 1 << 15  # 1 key a row: the fused kernel (sweep.BLOCKED_TEST_INSERT_CROSSOVER)
    assert sweep._takes_fused(config, B)
    state = torch.zeros(config.n_blocks * config.words_per_block, dtype=torch.int32,
                        device=dev).view(torch.uint32)
    keys, lengths = _keys(B, dev, seed=1)
    return "blocked_test_insert", lambda: sweep.blocked_test_insert(state, keys, lengths, config)


def _tiled_flat_insert(dev):
    config = FilterConfig(m=1 << 24, k=10, key_len=L)
    B = 1 << 17  # 10 x 2^17 positions on 2^16 sectors: the partitioned kernel
    assert sweep._takes_tiles(config, B, None, False)
    state = torch.zeros(config.n_words, dtype=torch.int32, device=dev).view(torch.uint32)
    keys, lengths = _keys(B, dev, seed=2)
    return "flat_insert", lambda: sweep.flat_insert(state, keys, lengths, config)


@pytest.mark.gpu
@pytest.mark.parametrize("make", [_fused_test_insert, _tiled_flat_insert],
                         ids=["fused blocked_test_insert", "partitioned flat_insert"])
def test_every_device_operation_is_launched_inside_enqueue(make, cuda, tmp_path):
    wrapper, call = make(cuda)
    call()  # builds and loads the library outside the trace
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    events = _trace(call, tmp_path, acts)
    (w,) = _ranges(events, "tpubloom_torch.sweep." + wrapper)
    enqueues = _ranges(events, "tpubloom_torch.sweep.enqueue")
    assert enqueues and all(_inside(e, w) for e in enqueues)
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    assert len([e for e in device if e["cat"] == "kernel"]) >= 3  # the partition and the sweep
    for op in device:
        host = launches[op["args"]["correlation"]]
        assert any(_inside(host, e) for e in enqueues), (op["name"], host["name"])
    for e in events:  # the C entry's own runtime calls too
        if e.get("ph") == "X" and e.get("name") == "cudaFuncSetAttribute" and _inside(e, w):
            assert any(_inside(e, q) for q in enqueues)
