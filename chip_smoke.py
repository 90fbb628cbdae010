#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpubloom_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root, one card

It builds the CUDA kernels from ``tpubloom_torch/csrc`` and drives the
port's three paths through the entry points a user calls: the main path, a
BlockedBloomFilter at m=2^32, k=7, block_bits=512 (512 MiB of state),
16-byte keys, batches of 2^23; the counting path, a
BlockedCountingBloomFilter at BASELINE config 4 (m=2^30 counters, k=7,
block_bits=512, 512 MiB of state, batches of 2^22, the parameters of
benchmarks/counting_rate.py); and the sharded path, a ShardedBloomFilter
at BASELINE config 5 (m=2^36, k=7, block_bits=512, 64 shards, 8 GiB of
state on one card, batches of 2^23, the parameters of
benchmarks/run.py:269-305) and its counting twin, configs 4 x 5 (m=2^30
counters over 64 shards, batches of 2^22). Phases, one JSON line each:

1. device: the card's name and count, and ``nvidia-smi``'s name and
   power limit;
2. build: ``nvcc`` seconds per kernel source;
3. kernel vs plain: test-and-insert, insert and query at full width,
   through each CUDA kernel and through its plain PyTorch version on the
   same inputs; state and verdicts must be equal (tolerance 0); then
   again with ``block_hash="ap"`` at a smaller m;
4. main path: test-and-insert of Python ``bytes`` keys, within-batch
   duplicates, tail padding, ``insert_packed``/``include_packed`` at
   B=2^23, a replay that must report every key present, the FPR of fresh
   keys against ``params.blocked_fpr`` (the tolerance of
   tests/test_fpr_model.py), and the staged API with ``InFlight`` over
   4 batches — with every kernel's launch count read after it;
5. times: CUDA events over warmed launches at B=2^23 for each kernel,
   its plain version and the nearest single PyTorch call, beside the
   least time the card could take for the same work (``bound_ms``: bytes
   over the memory rate, or 32-bit integer operations over the INT32
   rate, whichever is larger). The query's ``ms`` is on keys the filter
   does not hold, ``present_ms`` on keys it holds; its phase record (not
   the ``kernels`` line) adds ``floor_ms``, a second bound: the bytes of
   a query that reads every key's row once (no row shared).
   The insert's ``ms`` is a fresh insert: each launch has its own event
   pair, and before it, outside the pair, the state is restored from a
   snapshot and the L2 cache flushed, so every timed launch sets the
   bits of keys the filter does not hold yet, at the same fill;
   ``replay_ms`` re-inserts batches the filter already holds (no bit
   changes). Beside them, the distinct words and 32-byte sectors the
   launch's keys touch (summed a key) and their rates;
6. end to end: host-clock time of whole ``insert_packed`` /
   ``include_packed`` calls at B=2^23 and of a test-and-insert of 2^16
   Python ``bytes`` keys, split by the port's phase spans;
7. counting kernel vs plain: at config 4, an insert, a delete and a
   query of a batch of old keys, fresh keys, a quarter of the batch one
   repeated key and tail padding, through each counting kernel and its
   plain version from the same state (tolerance 0); again with the state
   as its logical ``[NB, W]`` view, and with ``block_hash="ap"`` at
   m=2^26 counters;
8. counting path: ``insert_packed`` / ``include_packed`` of 2^22 keys,
   ``delete_batch`` of 2^16 of them as ``bytes`` and ``include_batch``,
   and a fresh filter that returns to all-zero words after inserting and
   deleting the same 2^22 keys, with the launch counts after each step;
9. counting times: CUDA events around each of ≥ 40 warmed launches of
   the insert, the delete (alternating, on the same batches, as
   benchmarks/counting_rate.py does), the query, and the insert and
   delete of a skewed batch, beside the bound, the plain versions and
   the update's touched words and sectors;
10. counting end to end: as phase 6, for the counting path's
   ``insert_packed`` / ``include_packed`` at B=2^22 and a
   ``delete_batch`` of 2^16 Python ``bytes`` keys;
11. checkpoint round trip: ``snapshot_blob`` -> ``restore_blob`` of a
   counting filter at m=2^24 counters (cut from 2^30: the numpy CRC32C's
   carry chain is a Python loop over 8-byte blocks);
12. sharded kernel vs plain: at config 5, on one slot of all 64 shards and
   on a slot of shards 16-31, an insert and a query of old keys, fresh
   keys, within-batch duplicates and tail padding through each routed
   kernel and its routed plain version from the same state (tolerance 0,
   ``torch.equal`` on the card); then the routed counting kernels at
   configs 4 x 5 for an insert, a delete and a query;
13. sharded path: ``insert_packed`` / ``include_packed`` of 2^23 keys,
   ``insert_batch`` / ``include_batch`` of Python ``bytes`` keys, a
   replay that must report every key present, the FPR of fresh keys at
   m=2^26 over 64 shards, the same batches through a 4-slot layout on the
   same card (16 shards a slot) whose words must equal the 1-slot run's
   shard for shard, and the counting twin with ``delete_batch`` — with the
   launch counts after each step;
14. sharded times: as phases 5 and 9 for the four routed kernels on the
   1-slot state, and the routed query on the 4-slot layout's slot of
   shards 16-31 (bound over the keys that slot owns);
15. sharded end to end: as phase 6 for the 1-slot and the 4-slot filters
   (the latter split into ``kernel_shard<i>`` phases).

Then the ``nvidia-smi`` line, the ``kernels`` line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check raises, and the run
exits non-zero without that line; it also fails when no CUDA device is
present. The full record is written to ``chiprun_out/chip_smoke.json``.

Two other modes compare kernel builds on one card:

    python3 chip_smoke.py --times         # device, build, phases 5, 9, 14
    python3 chip_smoke.py --ab DIR        # --times in DIR, here, here, DIR

``--times`` fills the filters as the full run does before its timing
phases and ends with one JSON line of the kernels' times. ``--ab`` copies
this script into DIR (another checkout of the repository, for example a
parent commit unpacked with ``git archive``), runs ``--times`` in DIR,
here, here and DIR in turn, and writes the four runs to
``chiprun_out/ab_times.json``.
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from tpubloom_torch import BlockedBloomFilter, BlockedCountingBloomFilter, FilterConfig
from tpubloom_torch import ShardedBloomFilter, checkpoint
from tpubloom_torch.obs import context as obs
from tpubloom_torch.ops import _build, blocked, counting, sweep
from tpubloom_torch.ops.hashing import ShardRoute
from tpubloom_torch.params import blocked_fpr

SEED = 20260
LOG2M, K, BLOCK_BITS, KEY_LEN = 32, 7, 512, 16
B = 1 << 23
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (HBM3) bandwidth
# H100 SXM 32-bit integer rate: 132 SMs x 64 INT32 lanes x 1.98 GHz boost
# clock (NVIDIA Hopper architecture white paper), an instruction an op
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# 32-bit integer operations per key that each function needs (the same
# count whatever the kernel's design), at L=16, k=7: murmur3_32 over four
# words is 4 x 11 (mul, rotate as 3, mul, xor, rotate, mul-add as 2) plus
# 10 of finalisation, 54, three passes (h_a, h_b, g_b) 162; fnv1a over 16
# bytes, 4 a byte, 64; k chunk slices, 4 each, 28: hashing 254. Then a
# query's k bit tests (word index, shift, and, compare), 28; an insert's k
# bit sets into the row's mask (word index, shift, or), 21; a counting
# update's k saturating nibble adds (extract as 2, add, min, insert as 3),
# 49; a counting query's k nibble tests, 28. A routed kernel adds the
# routing pass, one murmur3 (54), for every valid key, and the rest only
# for the keys its slot owns.
OPS_HASH, OPS_ROUTE = 162 + 64 + 28, 54
OPS_QUERY, OPS_INSERT = OPS_HASH + 28, OPS_HASH + 21
OPS_COUNT_UPDATE, OPS_COUNT_QUERY = OPS_HASH + 49, OPS_HASH + 28
# BASELINE config 4, as benchmarks/counting_rate.py:31-42 sets it; the
# `ap` comparison and the checkpoint round trip are cut (see their phases)
LOG2M_COUNTING, B_COUNTING = 30, 1 << 22
LOG2M_COUNTING_AP, B_COUNTING_AP = 26, 1 << 20
LOG2M_CHECKPOINT, B_CHECKPOINT = 24, 1 << 20
# BASELINE config 5, as benchmarks/run.py:269-305 sets it (--layout
# blocked), and its counting twin, configs 4 x 5; nothing cut. The FPR
# check runs at m=2^26 (λ=64 keys a block), where the model predicts
# enough hits; the 4-slot layout lays 16 shards a slot on the same card.
LOG2M_SHARDED, SHARDS, B_SHARDED = 36, 64, 1 << 23
LOG2M_SHARDED_COUNTING, B_SHARDED_COUNTING = 30, 1 << 22
LOG2M_SHARDED_FPR, N_SLOTS = 26, 4
M32 = 0xFFFFFFFF
L2_FLUSH_BYTES = 128 << 20  # read between fresh launches: 2.5 x the H100's 50 MB L2
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"
RECORD: dict = {}


def emit(phase: str, **kw) -> None:
    RECORD[phase] = kw
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def rows(rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.integers(0, 256, (n, KEY_LEN), dtype=np.uint8)


def max_abs_err(a: torch.Tensor, b: torch.Tensor, step: int = 1 << 26) -> int:
    """Largest |a - b| over two tensors of the same integer values
    (state words read as u32, verdicts as 0/1), in slices so that the
    int64 copies stay small on an 8 GiB state."""
    if a.dtype == torch.uint32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    a, b = a.reshape(-1), b.reshape(-1)
    worst = 0
    for s in range(0, a.numel(), step):
        x, y = a[s : s + step].to(torch.int64), b[s : s + step].to(torch.int64)
        if a.dtype == torch.int32:
            x, y = x & M32, y & M32
        worst = max(worst, int((x - y).abs().max()))
    return worst


def clone_u32(t: torch.Tensor) -> torch.Tensor:
    """A copy of a uint32 tensor, made through its int32 view (uint32 has
    few kernels of its own in torch)."""
    return t.view(torch.int32).clone().view(torch.uint32)


def cuda_ms(fn, n: int, warm: int = 2) -> float:
    """Mean ms per call over ``n`` calls, by CUDA events, after ``warm``."""
    for i in range(warm):
        fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def fresh_ms(state: torch.Tensor, launch, n: int, warm: int = 2) -> float:
    """Mean ms of ``launch(i)`` over ``n`` launches (after ``warm``), each
    timed by its own CUDA event pair on the state as it is when called:
    before each launch, outside its pair, the state is restored from a
    snapshot and the L2 cache is flushed by a read, so every launch
    updates the same filter with keys it does not hold yet. The state is
    left as it was."""
    dst = state.view(torch.int32)
    snap = dst.clone()
    flush = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=state.device)
    pairs = []
    for i in range(warm + n):
        dst.copy_(snap)
        flush.sum()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        launch(i)
        end.record()
        if i >= warm:
            pairs.append((start, end))
    dst.copy_(snap)
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / n


def touched(rows: torch.Tensor, words: torch.Tensor, words_per_row: int,
            valid: torch.Tensor) -> dict:
    """Distinct words and distinct 32-byte sectors of each valid key's row
    update, summed over the keys: the atomics an update launch issues
    (one a word a key) and the L2 sector requests it needs when a key's
    atomics to one sector go out together. ``rows`` int64[B], each key's
    row in the state; ``words`` int64[B, k], the word of each of its k
    positions within that row; ``valid`` bool[B]."""
    g = (rows[:, None] * words_per_row + words)[valid]

    def distinct(x: torch.Tensor) -> int:
        x = x.sort(dim=1).values
        return x.shape[0] + int((x[:, 1:] != x[:, :-1]).sum())

    n = int(valid.sum())
    w, s = distinct(g), distinct(g >> 3)  # 8 u32 words a sector
    return {"keys": n, "words": w, "sectors": s,
            "words_per_key": w / max(n, 1), "sectors_per_key": s / max(n, 1)}


def rates(t: dict, ms: float) -> dict:
    return {"words_per_s": t["words"] / ms * 1e3, "sectors_per_s": t["sectors"] / ms * 1e3}


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least ms the card could take: the larger of bytes over the
    memory rate and 32-bit integer operations over the INT32 rate."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def floor_ms(nbytes: float) -> float:
    """Bytes over the memory rate, in ms: with a query's bytes counting
    every valid key's row once (no two keys sharing a row read), the
    floor of a kernel that gets no reuse out of the L2."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    dev = {
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi[0],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
    }
    emit("device", **dev)
    return dev


def phase_build() -> None:
    t0 = time.perf_counter()
    built = _build.build_all()
    logs = {n: (_build.BUILD_DIR / f"{n}.log").read_text() for n in built}
    emit("build", seconds=time.perf_counter() - t0, per_source=built,
         ptxas={n: ptxas_summary(log) for n, log in logs.items()})


def ptxas_summary(log: str) -> dict:
    """Each kernel's registers, shared memory and spills, from the
    ``-Xptxas -v`` lines of a build log, under its demangled name."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif name and ("registers" in ln or "spill" in ln):
            out[name] = f"{out.get(name, '')} {ln.split(':', 1)[-1].strip()}".strip()
    return dict(zip(demangle(list(out)), out.values()))


def demangle(names: list[str]) -> list[str]:
    """``tpubloom::blocked_query_row_kernel<16>`` for each mangled kernel
    name (the argument list dropped), by ``c++filt`` or the toolkit's
    ``cu++filt``; the names as they are where neither runs."""
    tool = shutil.which("c++filt") or shutil.which("cu++filt")
    if not names or tool is None:
        return names
    try:
        got = subprocess.run([tool, *names], capture_output=True, text=True, timeout=60,
                             check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return names
    if len(got) != len(names):
        return names
    return [g.removeprefix("void ").split("(")[0] for g in got]


def kernel_vs_plain(cfg: FilterConfig, batch: int, rng: np.random.Generator) -> dict:
    """Populate with kernel batches, then run the same test-and-insert,
    insert and query through the kernels and the plain versions."""
    dev = torch.device("cuda")
    f = BlockedBloomFilter(cfg, dev)
    full = torch.full((batch,), KEY_LEN, dtype=torch.int32, device=dev)
    prev = None
    for _ in range(3):
        prev = torch.from_numpy(rows(rng, batch)).to(dev)
        sweep.blocked_insert(f.words, prev, full, cfg)
    fresh = torch.from_numpy(rows(rng, batch // 2)).to(dev)
    # keys already in, fresh keys, a repeat of a quarter of the fresh
    # keys inside the batch, and tail padding
    keys = torch.cat([prev[: batch // 4], fresh, fresh[: batch // 4]]).contiguous()
    lengths = full.clone()
    n_pad = batch // 1024
    lengths[-n_pad:] = -1
    keys[-n_pad:] = 0
    s_kernel, s_plain, s_insert = (clone_u32(f.words) for _ in range(3))
    p_kernel = sweep.blocked_test_insert(s_kernel, keys, lengths, cfg)
    p_plain = blocked.blocked_test_insert_plain(s_plain, keys, lengths, cfg)
    sweep.blocked_insert(s_insert, keys, lengths, cfg)
    probe = torch.cat([keys[: batch // 2], torch.from_numpy(rows(rng, batch // 2)).to(dev)])
    q_kernel = sweep.blocked_query(s_kernel, probe, lengths, cfg)
    q_plain = blocked.blocked_query_plain(s_kernel, probe, lengths, cfg)
    torch.cuda.synchronize()
    out = {
        "block_hash": cfg.block_hash, "log2m": cfg.m.bit_length() - 1, "batch": batch,
        "test_insert_state_err": max_abs_err(s_kernel, s_plain),
        "insert_state_err": max_abs_err(s_insert, s_plain),
        "presence_err": max_abs_err(p_kernel, p_plain),
        "query_err": max_abs_err(q_kernel, q_plain),
        "present_old": int(p_kernel[: batch // 4].sum()),
        "present_padding": int(p_kernel[-n_pad:].sum()),
        "query_hits": int(q_kernel.sum()),
    }
    check(torch.equal(s_kernel.view(torch.int32), s_plain.view(torch.int32)), "test-insert state")
    check(torch.equal(s_insert.view(torch.int32), s_plain.view(torch.int32)), "insert state")
    check(torch.equal(p_kernel, p_plain), "presence verdicts")
    check(torch.equal(q_kernel, q_plain), "query verdicts")
    check(out["present_old"] == batch // 4 and out["present_padding"] == 0, "presence contract")
    return out


def phase_kernel_vs_plain(rng) -> dict:
    main = kernel_vs_plain(FilterConfig(m=1 << LOG2M, k=K, key_len=KEY_LEN, block_bits=BLOCK_BITS), B, rng)
    ap = kernel_vs_plain(
        FilterConfig(m=1 << 28, k=K, key_len=KEY_LEN, block_bits=BLOCK_BITS, block_hash="ap"),
        1 << 20, rng,
    )
    errs = {"blocked_insert": max(main["test_insert_state_err"], main["insert_state_err"],
                                  ap["test_insert_state_err"], ap["insert_state_err"]),
            "blocked_query": max(main["presence_err"], main["query_err"],
                                 ap["presence_err"], ap["query_err"])}
    emit("kernel_vs_plain", chunk=main, ap=ap, max_abs_err=errs, tolerance=0)
    torch.cuda.empty_cache()
    return errs


def fpr_check(f: BlockedBloomFilter, rng, n_probe: int) -> dict:
    """Fresh keys' hits against the blocked FPR model, with the acceptance
    of tests/test_fpr_model.py: 6 sigma, 35% model tolerance, floor 8."""
    hits = int(f.include_packed(rows(rng, n_probe)).sum())
    c = f.config
    expect = n_probe * blocked_fpr(f.n_inserted, m=c.m, k=c.k, block_bits=c.block_bits,
                                   block_hash=c.block_hash)
    tol = max(6.0 * math.sqrt(max(expect, 1.0)), 0.35 * expect, 8.0)
    check(abs(hits - expect) <= tol, f"FPR {hits} hits vs model {expect:.1f} ± {tol:.1f}")
    return {"log2m": c.m.bit_length() - 1, "n_inserted": f.n_inserted, "probes": n_probe,
            "hits": hits, "model_hits": expect, "tolerance": tol}


def phase_main_path(rng) -> tuple[dict, BlockedBloomFilter]:
    cfg = FilterConfig(m=1 << LOG2M, k=K, key_len=KEY_LEN, block_bits=BLOCK_BITS)
    torch.cuda.reset_peak_memory_stats()
    sweep.reset_launch_counts()
    t0 = time.perf_counter()
    f = BlockedBloomFilter(cfg)  # no device: the card
    check(f.words.is_cuda, "default device is the card")
    lens = rng.integers(1, KEY_LEN + 1, 10_000)
    keys = [rng.bytes(int(n)) for n in lens]
    first = f.insert_batch(keys, return_presence=True)
    replay = f.insert_batch(keys, return_presence=True)
    check(not first.any(), "fresh keys absent from an empty filter")
    check(replay.all(), "replayed keys all present")
    new = [rng.bytes(KEY_LEN) for _ in range(1000)]
    dup = f.insert_batch(new + new + keys[:1000], return_presence=True)
    check((dup[:1000] == dup[1000:2000]).all() and not dup[:2000].any(),
          "within-batch duplicates report the pre-batch state")
    check(dup[2000:].all(), "old keys present")
    hits, n = f.launch_query(f.stage_batch(new + keys[:2000]))
    hits = hits.cpu().numpy()
    check(n == 3000 and hits.shape == (4096,) and hits[:n].all() and not hits[n:].any(),
          "padding reports False")
    big = rows(rng, B)
    check(f.insert_packed(big) == B, "insert_packed count")
    check(f.include_packed(big).all(), "packed replay all present")
    fpr_full = fpr_check(f, rng, B)
    inflight = sweep.InFlight()
    staged_rows = [rows(rng, B) for _ in range(4)]
    acked = []
    for i, r in enumerate(staged_rows):
        payload, err = inflight.put(f.launch_insert(f.stage_batch(rows=r)), i)
        check(err is None, f"fence error {err}")
        if payload is not None:
            acked.append(payload)
    payload, err = inflight.take()
    check(err is None, f"fence error {err}")
    acked.append(payload)
    check(acked == [0, 1, 2, 3], "staged batches acked in order")
    for r in staged_rows:
        check(f.include_packed(r).all(), "staged batch present")
    torch.cuda.synchronize()
    launches = sweep.launch_counts()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    for name in ("blocked_insert", "blocked_query"):
        check(launches[name] > 0, f"{name} launched on the main path")
    # an FPR the model can be held to needs a fuller filter: m=2^26 at 2^23 keys
    small = BlockedBloomFilter(FilterConfig(m=1 << 26, k=K, key_len=KEY_LEN, block_bits=BLOCK_BITS))
    small.insert_packed(rows(rng, B))
    fpr_small = fpr_check(small, rng, B)
    del small
    per_op = {}
    for op, fn in (
        ("test_and_insert", lambda: f.insert_batch(keys, return_presence=True)),
        ("insert", lambda: f.insert_packed(big)),
        ("query", lambda: f.include_packed(big)),
    ):
        sweep.reset_launch_counts()
        fn()
        per_op[op] = sweep.launch_counts()
    stats = f.stats()
    emit("main_path", launches=launches, launches_per_op=per_op, seconds=seconds,
         peak_bytes=peak, fpr=fpr_full, fpr_fuller=fpr_small,
         n_inserted=f.n_inserted, fill_ratio=stats["fill_ratio"])
    return launches, f


def touched_rows(f: BlockedBloomFilter, keys: torch.Tensor, lengths: torch.Tensor):
    c = f.config
    blk, pos = blocked.block_positions(keys, lengths, n_blocks=c.n_blocks, block_bits=c.block_bits,
                                       k=c.k, seed=c.seed, block_hash=c.block_hash)
    return int(torch.unique(blk).numel()), blk, pos


def phase_times(f: BlockedBloomFilter, rng) -> dict:
    cfg, dev = f.config, f.device
    batches = [torch.from_numpy(rows(rng, B)).to(dev) for _ in range(8)]
    old, fresh = batches[:4], batches[4:]
    lengths = torch.full((B,), KEY_LEN, dtype=torch.int32, device=dev)
    state = f.words
    # `ms` queries keys the filter does not hold (the `old` batches before
    # they are inserted), `present_ms` the same batches once it holds them
    q_ms = cuda_ms(lambda i: sweep.blocked_query(state, old[i % 4], lengths, cfg), 40, warm=4)
    # re-inserts the four batches its warm-up launches inserted
    replay_ms = cuda_ms(lambda i: sweep.blocked_insert(state, old[i % 4], lengths, cfg), 40, warm=4)
    qpres_ms = cuda_ms(lambda i: sweep.blocked_query(state, old[i % 4], lengths, cfg), 40, warm=4)
    i_ms = fresh_ms(state, lambda i: sweep.blocked_insert(state, fresh[i % 4], lengths, cfg), 40)
    qp_ms = cuda_ms(lambda i: blocked.blocked_query_plain(state, old[i % 4], lengths, cfg), 5, warm=1)
    ip_ms = cuda_ms(lambda i: blocked.blocked_insert_plain(state, old[i % 4], lengths, cfg), 5, warm=1)
    rows_touched, blk, _ = touched_rows(f, old[0], lengths)
    _, fresh_blk, fresh_pos = touched_rows(f, fresh[0], lengths)
    t = touched(fresh_blk, fresh_pos >> 5, cfg.words_per_block, lengths >= 0)
    table = state.view(torch.int32).reshape(cfg.n_blocks, cfg.words_per_block)
    lib_ms = cuda_ms(lambda i: torch.index_select(table, 0, blk), 40, warm=4)
    row_bytes = cfg.words_per_block * 4
    in_bytes = B * KEY_LEN + B * 4
    q_bytes = in_bytes + B + rows_touched * row_bytes
    i_bytes = in_bytes + 2 * rows_touched * row_bytes
    qb, qby = bound(q_bytes, OPS_QUERY * B)
    ib, iby = bound(i_bytes, OPS_INSERT * B)
    q_floor = floor_ms(in_bytes + B + B * row_bytes)
    out = {
        "batch": B, "rows_touched": rows_touched, "touched": t,
        "blocked_query": {"ms": q_ms, "present_ms": qpres_ms, "keys_per_s": B / q_ms * 1e3,
                          "plain_ms": qp_ms, "library_ms": lib_ms, "bound_ms": qb, "bound_by": qby,
                          "bytes": q_bytes, "share_of_bound": qb / q_ms,
                          "floor_ms": q_floor, "share_of_floor": q_floor / q_ms},
        "blocked_insert": {"ms": i_ms, "replay_ms": replay_ms, "keys_per_s": B / i_ms * 1e3,
                           "plain_ms": ip_ms, "library_ms": None, "bound_ms": ib, "bound_by": iby,
                           "bytes": i_bytes, "share_of_bound": ib / i_ms, **rates(t, i_ms)},
        "test_and_insert_ms": q_ms + i_ms,
    }
    emit("times", **out)
    return out


def time_calls(calls) -> dict:
    """Host-clock time of whole entry-point calls, split by the port's
    own phase spans (host_prep / h2d / kernel / kernel_query / d2h, each
    fenced inside an active request context), and the share of it the
    kernels keep the card busy (kernel ms from the CUDA-event times).
    ``calls``: (name, keys, fn, kernel ms or None)."""
    out = {}
    for name, n, fn, kernel_ms in calls:
        fn()  # warm
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            with obs.request(name) as ctx:
                fn()
            total_ms = (time.perf_counter() - t0) * 1e3
            runs.append({"total_ms": total_ms, "keys_per_s": n / total_ms * 1e3,
                         **{f"{k}_ms": v * 1e3 for k, v in ctx.phases.items()}})
        best = min(r["total_ms"] for r in runs)
        out[name] = {"keys": n, "runs": runs,
                     "device_busy_share": None if kernel_ms is None else kernel_ms / best}
    return out


def phase_end_to_end(f: BlockedBloomFilter, rng, times: dict) -> None:
    big = rows(rng, B)
    small = [bytes(r) for r in rows(rng, 1 << 16)]
    emit("end_to_end", **time_calls((
        ("insert_packed", B, lambda: f.insert_packed(big), times["blocked_insert"]["ms"]),
        ("include_packed", B, lambda: f.include_packed(big), times["blocked_query"]["ms"]),
        ("test_and_insert_bytes_keys", len(small),
         lambda: f.insert_batch(small, return_presence=True), None),
    )))


def phase_counting_end_to_end(f: BlockedCountingBloomFilter, rng, times: dict) -> None:
    """The counting path's whole calls: packed insert and query at
    B=2^22, and a delete of 2^16 Python ``bytes`` keys (the counting
    filter deletes only through ``delete_batch``)."""
    big = rows(rng, B_COUNTING)
    small = [bytes(r) for r in rows(rng, 1 << 16)]
    emit("counting_end_to_end", **time_calls((
        ("insert_packed", B_COUNTING, lambda: f.insert_packed(big),
         times["blocked_counting_update"]["ms"]),
        ("include_packed", B_COUNTING, lambda: f.include_packed(big),
         times["blocked_counting_query"]["ms"]),
        ("delete_bytes_keys", len(small), lambda: f.delete_batch(small), None),
    )))


def counting_config(log2m: int, **kw) -> FilterConfig:
    return FilterConfig(m=1 << log2m, k=K, key_len=KEY_LEN, counting=True,
                        block_bits=BLOCK_BITS, **kw)


def equal_words(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def skewed_batch(rng, old: torch.Tensor, batch: int) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Keys already counted (the first quarter), one key repeated over
    the second quarter, fresh keys, and tail padding; returns (keys,
    lengths, padded entries)."""
    dev = old.device
    keys = torch.from_numpy(rows(rng, batch)).to(dev)
    keys[: batch // 4] = old[: batch // 4]
    keys[batch // 4 : batch // 2] = keys[batch // 4].clone()
    lengths = torch.full((batch,), KEY_LEN, dtype=torch.int32, device=dev)
    n_pad = max(1, batch // 1024)
    lengths[-n_pad:] = -1
    keys[-n_pad:] = 0
    return keys, lengths, n_pad


def counting_vs_plain(cfg: FilterConfig, batch: int, rng, view: str) -> dict:
    """Populate with kernel batches, then insert, delete and query the
    same skewed batch through the counting kernels and their plain
    versions, from the same state; ``view`` "storage" passes the filter's
    own (fat) storage, "logical" its [NB, W] view of the same words."""
    dev = torch.device("cuda")
    f = BlockedCountingBloomFilter(cfg, dev)
    state = f.words if view == "storage" else f.words.view(cfg.n_blocks, cfg.words_per_block)
    full = torch.full((batch,), KEY_LEN, dtype=torch.int32, device=dev)
    for _ in range(3):
        prev = torch.from_numpy(rows(rng, batch)).to(dev)
        sweep.blocked_counting_update(state, prev, full, cfg, increment=True)
    keys, lengths, n_pad = skewed_batch(rng, prev, batch)
    s_kernel, s_plain = clone_u32(state), clone_u32(state)
    errs = {}
    for op, increment in (("insert", True), ("delete", False)):
        sweep.blocked_counting_update(s_kernel, keys, lengths, cfg, increment=increment)
        counting.blocked_counting_update_plain(s_plain, keys, lengths, cfg, increment=increment)
        torch.cuda.synchronize()
        errs[f"{op}_state_err"] = max_abs_err(s_kernel, s_plain)
        check(equal_words(s_kernel, s_plain), f"counting {op} state ({view}, {cfg.block_hash})")
        if increment:
            hot = sweep.blocked_counting_query(s_kernel, keys[batch // 4 : batch // 4 + 1], full[:1], cfg)
            errs["hot_key_present_after_insert"] = bool(hot[0])
    probe = torch.cat([prev[: batch // 2], torch.from_numpy(rows(rng, batch // 2)).to(dev)])
    q_kernel = sweep.blocked_counting_query(s_kernel, probe, lengths, cfg)
    q_plain = counting.blocked_counting_query_plain(s_kernel, probe, lengths, cfg)
    torch.cuda.synchronize()
    check(torch.equal(q_kernel, q_plain), f"counting query verdicts ({view}, {cfg.block_hash})")
    check(errs["hot_key_present_after_insert"], "the repeated key is present after its insert")
    out = {
        "view": view, "state_shape": list(state.shape), "block_hash": cfg.block_hash,
        "log2m": cfg.m.bit_length() - 1, "batch": batch, "padded": n_pad, **errs,
        "query_err": max_abs_err(q_kernel, q_plain),
        "query_hits_old_half": int(q_kernel[: batch // 2].sum()),
        "query_hits_fresh_half": int(q_kernel[batch // 2 :].sum()),
    }
    del f, state, s_kernel, s_plain
    torch.cuda.empty_cache()
    return out


def phase_counting_kernel_vs_plain(rng) -> dict:
    runs = [
        counting_vs_plain(counting_config(LOG2M_COUNTING), B_COUNTING, rng, "storage"),
        counting_vs_plain(counting_config(LOG2M_COUNTING), B_COUNTING, rng, "logical"),
        counting_vs_plain(counting_config(LOG2M_COUNTING_AP, block_hash="ap"), B_COUNTING_AP,
                          rng, "storage"),
    ]
    errs = {"blocked_counting_update": max(max(r["insert_state_err"], r["delete_state_err"]) for r in runs),
            "blocked_counting_query": max(r["query_err"] for r in runs)}
    emit("counting_kernel_vs_plain", runs=runs, max_abs_err=errs, tolerance=0,
         cut=f"ap run at m=2^{LOG2M_COUNTING_AP} counters, B={B_COUNTING_AP}: "
             "for the plain version's time only")
    return errs


def phase_counting_path(rng) -> tuple[dict, BlockedCountingBloomFilter]:
    cfg = counting_config(LOG2M_COUNTING)
    sweep.reset_launch_counts()
    t0 = time.perf_counter()
    steps = {}
    f = BlockedCountingBloomFilter(cfg)  # no device: the card
    check(f.words.is_cuda, "default device is the card")
    big = rows(rng, B_COUNTING)
    check(f.insert_packed(big) == B_COUNTING, "insert_packed count")
    steps["insert_packed"] = sweep.launch_counts()
    check(f.include_packed(big).all(), "inserted keys all present")
    steps["include_packed"] = sweep.launch_counts()
    n_gone = B_COUNTING // 64  # 2^16 at config 4
    gone = [bytes(r) for r in big[:n_gone]]
    f.delete_batch(gone)
    steps["delete_batch"] = sweep.launch_counts()
    kept = [bytes(r) for r in big[n_gone : 2 * n_gone]]
    after = f.include_batch(gone + kept)
    steps["include_batch"] = sweep.launch_counts()
    check(not after[:n_gone].any(), "deleted keys absent")
    check(after[n_gone:].all() and f.include_packed(big[n_gone:]).all(), "the other keys still present")
    check(f.n_inserted == B_COUNTING - n_gone, "n_inserted after the delete")
    # a fresh filter that inserts and deletes the same keys is empty again
    # (at λ = 0.5 keys a block no counter comes near 15)
    g = BlockedCountingBloomFilter(cfg)
    again = rows(rng, B_COUNTING)
    g.insert_packed(again)
    g.delete_batch([bytes(r) for r in again])
    torch.cuda.synchronize()
    check(not bool(g.words.view(torch.int32).any()), "insert then delete returns to all-zero words")
    check(g.n_inserted == 0, "n_inserted back to 0")
    launches = sweep.launch_counts()
    seconds = time.perf_counter() - t0
    for name in ("blocked_counting_update", "blocked_counting_query"):
        check(launches[name] > 0, f"{name} launched on the counting path")
    del g
    torch.cuda.empty_cache()
    emit("counting_path", launches=launches, launches_after_step=steps, seconds=seconds,
         n_inserted=f.n_inserted, deleted=n_gone, stats=f.stats())
    return launches, f


def event_pairs_ms(ops: list, n: int, warm: int = 4) -> list[float]:
    """Mean ms per launch of each op, timed by its own CUDA event pair,
    over ``n`` rounds that run the ops in turn (after ``warm`` rounds)."""
    for i in range(warm):
        for op in ops:
            op(i)
    torch.cuda.synchronize()
    evs = [[torch.cuda.Event(enable_timing=True) for _ in range(len(ops) + 1)] for _ in range(n)]
    for i in range(n):
        evs[i][0].record()
        for j, op in enumerate(ops):
            op(i)
            evs[i][j + 1].record()
    torch.cuda.synchronize()
    return [sum(evs[i][j].elapsed_time(evs[i][j + 1]) for i in range(n)) / n for j in range(len(ops))]


def phase_counting_times(f: BlockedCountingBloomFilter, rng) -> dict:
    cfg, dev, state = f.config, f.device, f.words
    batches = [torch.from_numpy(rows(rng, B_COUNTING)).to(dev) for _ in range(4)]
    lengths = torch.full((B_COUNTING,), KEY_LEN, dtype=torch.int32, device=dev)
    skew, skew_len, _ = skewed_batch(rng, batches[0], B_COUNTING)

    def upd(keys, lens, increment, st=state):
        return lambda i: sweep.blocked_counting_update(st, keys(i), lens, cfg, increment=increment)

    def plain(keys, lens, increment):
        return lambda i: counting.blocked_counting_update_plain(state, keys(i), lens, cfg, increment=increment)

    def batch(i):
        return batches[i % 4]

    # insert then delete the same batch, as benchmarks/counting_rate.py
    # does: the state stays at its populated level
    i_ms, d_ms = event_pairs_ms([upd(batch, lengths, True), upd(batch, lengths, False)], 40)
    si_ms, sd_ms = event_pairs_ms([upd(lambda i: skew, skew_len, True),
                                   upd(lambda i: skew, skew_len, False)], 40)
    # the same kernel handed the logical [NB, W] view (K2's layout)
    logical = state.view(cfg.n_blocks, cfg.words_per_block)
    li_ms, ld_ms = event_pairs_ms([upd(batch, lengths, True, logical),
                                   upd(batch, lengths, False, logical)], 40)
    q_ms = cuda_ms(lambda i: sweep.blocked_counting_query(state, batches[i % 4], lengths, cfg), 40, warm=4)
    ip_ms, dp_ms = event_pairs_ms([plain(batch, lengths, True), plain(batch, lengths, False)], 3, warm=1)
    qp_ms = cuda_ms(lambda i: counting.blocked_counting_query_plain(state, batches[i % 4], lengths, cfg), 3, warm=1)
    blk, cpos = blocked.block_positions(batches[0], lengths, n_blocks=cfg.n_blocks,
                                        block_bits=cfg.counters_per_block, k=cfg.k, seed=cfg.seed,
                                        block_hash=cfg.block_hash)
    rows_touched = int(torch.unique(blk).numel())
    t = touched(blk, cpos >> 3, cfg.words_per_block, lengths >= 0)
    table = state.view(torch.int32).reshape(cfg.n_blocks, cfg.words_per_block)
    lib_ms = cuda_ms(lambda i: torch.index_select(table, 0, blk), 40, warm=4)
    row_bytes = cfg.words_per_block * 4
    in_bytes = B_COUNTING * (KEY_LEN + 4)
    u_bytes = in_bytes + 2 * rows_touched * row_bytes
    q_bytes = in_bytes + B_COUNTING + rows_touched * row_bytes
    ub, uby = bound(u_bytes, OPS_COUNT_UPDATE * B_COUNTING)
    qb, qby = bound(q_bytes, OPS_COUNT_QUERY * B_COUNTING)
    out = {
        "batch": B_COUNTING, "rows_touched": rows_touched, "touched": t,
        "blocked_counting_update": {
            "ms": i_ms, "delete_ms": d_ms, "skewed_insert_ms": si_ms, "skewed_delete_ms": sd_ms,
            "logical_view_ms": li_ms, "logical_view_delete_ms": ld_ms,
            "keys_per_s": B_COUNTING / i_ms * 1e3, "plain_ms": ip_ms, "plain_delete_ms": dp_ms,
            "library_ms": None, "bound_ms": ub, "bound_by": uby, "bytes": u_bytes,
            "share_of_bound": ub / i_ms, **rates(t, i_ms),
        },
        "blocked_counting_query": {
            "ms": q_ms, "keys_per_s": B_COUNTING / q_ms * 1e3, "plain_ms": qp_ms,
            "library_ms": lib_ms, "bound_ms": qb, "bound_by": qby, "bytes": q_bytes,
            "share_of_bound": qb / q_ms,
        },
    }
    emit("counting_times", **out)
    return out


def phase_checkpoint_roundtrip(rng) -> None:
    cfg = counting_config(LOG2M_CHECKPOINT)
    f = BlockedCountingBloomFilter(cfg)
    keys = rows(rng, B_CHECKPOINT)
    f.insert_packed(keys)
    f.delete_batch([bytes(r) for r in keys[: 1 << 12]])
    t0 = time.perf_counter()
    key_name, seq, blob = checkpoint.snapshot_blob(f)
    t1 = time.perf_counter()
    g = checkpoint.restore_blob(blob)
    t2 = time.perf_counter()
    check(isinstance(g, BlockedCountingBloomFilter) and g.words.is_cuda, "restored on the card")
    check(equal_words(f.words, g.words), "restored words equal")
    probe = np.concatenate([keys[: 1 << 16], rows(rng, 1 << 16)])
    check(np.array_equal(f.include_packed(probe), g.include_packed(probe)), "restored verdicts equal")
    check(g.n_inserted == f.n_inserted and g._restored_seq == seq, "restored usage counters and seq")
    emit("checkpoint_roundtrip", log2m=cfg.m.bit_length() - 1, key_name=key_name,
         blob_bytes=len(blob), snapshot_s=t1 - t0, restore_s=t2 - t1,
         cut=f"m=2^{LOG2M_CHECKPOINT} counters, not 2^{LOG2M_COUNTING}: the numpy CRC32C's "
             "carry chain is a Python loop over 8-byte blocks, ~67 M iterations a checksum "
             "at 512 MiB")


def sharded_config(log2m: int, **kw) -> FilterConfig:
    return FilterConfig(m=1 << log2m, k=K, key_len=KEY_LEN, block_bits=BLOCK_BITS,
                        shards=SHARDS, **kw)


def slot_state(cfg: FilterConfig, route: ShardRoute) -> torch.Tensor:
    n = route.shards_per_dev * cfg.n_blocks_per_shard * cfg.words_per_block
    return torch.zeros(n, dtype=torch.int32, device=torch.device("cuda")).view(torch.uint32)


def sharded_vs_plain(cfg: FilterConfig, route: ShardRoute, batch: int, rng) -> dict:
    """Populate one slot's state with routed kernel inserts, then run the
    same update(s) and query through the routed kernels and their routed
    plain versions from the same state: the bit filter's insert, or the
    counting filter's insert and delete (with a quarter of the batch one
    repeated key)."""
    dev = torch.device("cuda")
    state = slot_state(cfg, route)
    full = torch.full((batch,), KEY_LEN, dtype=torch.int32, device=dev)
    counting_cfg = bool(cfg.counting)
    for _ in range(3):
        prev = torch.from_numpy(rows(rng, batch)).to(dev)
        if counting_cfg:
            sweep.blocked_counting_update(state, prev, full, cfg, increment=True, route=route)
        else:
            sweep.blocked_insert(state, prev, full, cfg, route=route)
    if counting_cfg:
        keys, lengths, n_pad = skewed_batch(rng, prev, batch)
    else:
        fresh = torch.from_numpy(rows(rng, batch // 2)).to(dev)
        keys = torch.cat([prev[: batch // 4], fresh, fresh[: batch // 4]]).contiguous()
        lengths, n_pad = full.clone(), batch // 1024
        lengths[-n_pad:] = -1
        keys[-n_pad:] = 0
    s_plain = clone_u32(state)  # the kernel updates `state` itself
    owned = blocked.routed_blocks(keys, lengths, cfg, route,
                                  block_bits=cfg.counters_per_block if counting_cfg
                                  else cfg.block_bits)[0]
    out = {"route": [route.n_shards, route.shard_lo, route.shards_per_dev],
           "log2m": cfg.m.bit_length() - 1, "batch": batch, "padded": n_pad,
           "owned": int(owned.sum()), "state_bytes": state.numel() * 4}
    ops = (("insert", True), ("delete", False)) if counting_cfg else (("insert", True),)
    for op, increment in ops:
        if counting_cfg:
            sweep.blocked_counting_update(state, keys, lengths, cfg, increment=increment, route=route)
            counting.blocked_counting_update_plain(s_plain, keys, lengths, cfg,
                                                   increment=increment, route=route)
        else:
            sweep.blocked_insert(state, keys, lengths, cfg, route=route)
            blocked.blocked_insert_plain(s_plain, keys, lengths, cfg, route)
        torch.cuda.synchronize()
        out[f"{op}_state_err"] = max_abs_err(state, s_plain)
        check(equal_words(state, s_plain), f"sharded {op} state {out['route']}")
    del s_plain
    probe = torch.cat([prev[: batch // 2], torch.from_numpy(rows(rng, batch // 2)).to(dev)])
    if counting_cfg:
        q_kernel = sweep.blocked_counting_query(state, probe, lengths, cfg, route=route)
        q_plain = counting.blocked_counting_query_plain(state, probe, lengths, cfg, route)
    else:
        q_kernel = sweep.blocked_query(state, probe, lengths, cfg, route=route)
        q_plain = blocked.blocked_query_plain(state, probe, lengths, cfg, route)
    torch.cuda.synchronize()
    check(torch.equal(q_kernel, q_plain), f"sharded query verdicts {out['route']}")
    p_owned = blocked.routed_blocks(probe, lengths, cfg, route,
                                    block_bits=cfg.counters_per_block if counting_cfg
                                    else cfg.block_bits)[0]
    check(not bool(q_kernel[~p_owned].any()), "keys the slot does not own answer False")
    out.update(query_err=max_abs_err(q_kernel, q_plain),
               query_hits_old_half=int(q_kernel[: batch // 2].sum()),
               owned_old_half=int(p_owned[: batch // 2].sum()),
               query_hits_fresh_half=int(q_kernel[batch // 2 :].sum()))
    if not counting_cfg:
        check(out["query_hits_old_half"] == out["owned_old_half"], "owned old keys present")
    del state
    torch.cuda.empty_cache()
    return out


def phase_sharded_kernel_vs_plain(rng) -> dict:
    cfg5 = sharded_config(LOG2M_SHARDED)
    cfg45 = sharded_config(LOG2M_SHARDED_COUNTING, counting=True)
    one, quarter = ShardRoute(SHARDS, 0, SHARDS), ShardRoute(SHARDS, 16, SHARDS // N_SLOTS)
    bits = [sharded_vs_plain(cfg5, r, B_SHARDED, rng) for r in (one, quarter)]
    counts = [sharded_vs_plain(cfg45, r, B_SHARDED_COUNTING, rng)
              for r in (one, ShardRoute(SHARDS, 48, SHARDS // N_SLOTS))]
    errs = {
        "sharded_blocked_insert": max(r["insert_state_err"] for r in bits),
        "sharded_blocked_query": max(r["query_err"] for r in bits),
        "sharded_blocked_counting_update": max(max(r["insert_state_err"], r["delete_state_err"])
                                               for r in counts),
        "sharded_blocked_counting_query": max(r["query_err"] for r in counts),
    }
    emit("sharded_kernel_vs_plain", config5=bits, configs4x5=counts, max_abs_err=errs, tolerance=0)
    return errs


def same_slots(one: ShardedBloomFilter, many: ShardedBloomFilter) -> bool:
    """The many-slot filter's words equal the one-slot filter's, shard for
    shard (compared on the card)."""
    whole, spd = one.slot_words[0], many.shards_per_dev
    return all(equal_words(whole[i * spd : (i + 1) * spd], w) for i, w in enumerate(many.slot_words))


def phase_sharded_path(rng) -> tuple[dict, ShardedBloomFilter, ShardedBloomFilter, ShardedBloomFilter]:
    cfg5 = sharded_config(LOG2M_SHARDED)
    sweep.reset_launch_counts()
    t0 = time.perf_counter()
    steps = {}
    f = ShardedBloomFilter(cfg5)  # no devices: one slot on the one card
    check(len(f.slot_words) == 1 and f.slot_words[0].is_cuda, "default slots are the card")
    big = rows(rng, B_SHARDED)
    check(f.insert_packed(big) == B_SHARDED, "insert_packed count")
    steps["insert_packed"] = sweep.launch_counts()
    check(f.include_packed(big).all(), "packed replay all present")
    steps["include_packed"] = sweep.launch_counts()
    lens = rng.integers(0, KEY_LEN + 1, 10_000)
    keys = [rng.bytes(int(n)) for n in lens] + [b"", b"a"]
    f.insert_batch(keys)
    steps["insert_batch"] = sweep.launch_counts()
    check(f.include_batch(keys).all(), "bytes keys all present")
    steps["include_batch"] = sweep.launch_counts()
    fresh = rows(rng, B_SHARDED // 2)
    probe = np.concatenate([big[: B_SHARDED // 2], fresh])
    verdicts = f.include_packed(probe)
    check(verdicts[: B_SHARDED // 2].all(), "old half of the probe present")
    fpr_full = {"probes": len(fresh), "hits": int(verdicts[B_SHARDED // 2 :].sum())}
    # the same batches through 4 slots on the same card: the same words
    g = ShardedBloomFilter(cfg5, devices=["cuda"] * N_SLOTS)
    g.insert_packed(big)
    g.insert_batch(keys)
    torch.cuda.synchronize()
    check(same_slots(f, g), "4-slot words equal the 1-slot words shard for shard")
    check(np.array_equal(g.include_packed(probe), verdicts), "4-slot verdicts equal")
    check(g.include_batch(keys).all(), "4-slot bytes keys present")
    steps["four_slots"] = sweep.launch_counts()
    check((f.n_inserted, g.n_inserted) == (B_SHARDED + len(keys),) * 2, "n_inserted")
    # an FPR the model can be held to needs a fuller filter
    small = ShardedBloomFilter(sharded_config(LOG2M_SHARDED_FPR))
    small.insert_packed(rows(rng, B_SHARDED))
    fpr_small = fpr_check(small, rng, B_SHARDED)
    del small
    # the counting twin, configs 4 x 5, with a delete
    cfg45 = sharded_config(LOG2M_SHARDED_COUNTING, counting=True)
    fc, gc = ShardedBloomFilter(cfg45), ShardedBloomFilter(cfg45, devices=["cuda"] * N_SLOTS)
    bigc = rows(rng, B_SHARDED_COUNTING)
    n_gone = B_SHARDED_COUNTING // 64
    gone = [bytes(r) for r in bigc[:n_gone]]
    for c in (fc, gc):
        c.insert_packed(bigc)
        c.delete_batch(gone)
    steps["counting"] = sweep.launch_counts()
    torch.cuda.synchronize()
    check(same_slots(fc, gc), "4-slot counters equal the 1-slot counters shard for shard")
    probe_c = np.concatenate([bigc[: 2 * n_gone], rows(rng, n_gone)])
    hits_c = fc.include_packed(probe_c)
    check(np.array_equal(gc.include_packed(probe_c), hits_c), "4-slot counting verdicts equal")
    check(not hits_c[:n_gone].any() and hits_c[n_gone : 2 * n_gone].all(),
          "deleted keys absent, the others present")
    check(fc.n_inserted == gc.n_inserted == B_SHARDED_COUNTING - n_gone, "counting n_inserted")
    del gc
    torch.cuda.synchronize()
    launches = sweep.launch_counts()
    seconds = time.perf_counter() - t0
    for name in ("sharded_blocked_insert", "sharded_blocked_query",
                 "sharded_blocked_counting_update", "sharded_blocked_counting_query"):
        check(launches[name] > 0, f"{name} launched on the sharded path")
    torch.cuda.empty_cache()
    emit("sharded_path", launches=launches, launches_after_step=steps, seconds=seconds,
         n_inserted=f.n_inserted, state_bytes=f.slot_words[0].numel() * 4,
         fresh_hits_at_2_36=fpr_full, fpr_fuller=fpr_small,
         counting={"n_inserted": fc.n_inserted, "deleted": n_gone,
                   "probe_hits_fresh": int(hits_c[2 * n_gone :].sum())})
    return launches, f, g, fc


def sharded_rows(cfg: FilterConfig, route: ShardRoute, keys, lengths, domain: int):
    """(distinct rows of the owned keys, each key's row, positions, owned)."""
    owned, row, pos = blocked.routed_blocks(keys, lengths, cfg, route, block_bits=domain)
    return int(torch.unique(row[owned]).numel()), row, pos, owned


def slot_query_times(g: ShardedBloomFilter, batches: list, lengths: torch.Tensor) -> dict:
    """The routed query on the 4-slot layout's slot of shards 16-31 (a
    quarter of the batch owned), on keys the filter does not hold, with
    its bound over the owned keys' rows: every key is read and routed,
    only the owned keys are hashed and gathered."""
    cfg, state, route = g.config, g.slot_words[1], g.routes[1]
    check((route.shard_lo, route.shards_per_dev) == (16, 16), "slot 1 holds shards 16-31")
    n_rows, _, _, owned = sharded_rows(cfg, route, batches[0], lengths, cfg.block_bits)
    n_owned = int(owned.sum())
    ms = cuda_ms(lambda i: sweep.blocked_query(state, batches[i % 4], lengths, cfg, route=route), 40, warm=4)
    n = lengths.numel()
    row_bytes = cfg.words_per_block * 4
    q_bytes = n * (KEY_LEN + 4) + n + n_rows * row_bytes
    qb, qby = bound(q_bytes, OPS_ROUTE * n + OPS_QUERY * n_owned)
    q_floor = floor_ms(n * (KEY_LEN + 4) + n + n_owned * row_bytes)
    return {"ms": ms, "keys_per_s": n / ms * 1e3, "route": [route.n_shards, route.shard_lo,
            route.shards_per_dev], "owned": n_owned, "rows_touched": n_rows, "bound_ms": qb,
            "bound_by": qby, "bytes": q_bytes, "share_of_bound": qb / ms,
            "floor_ms": q_floor, "share_of_floor": q_floor / ms}


def phase_sharded_times(f: ShardedBloomFilter, g: ShardedBloomFilter, fc: ShardedBloomFilter,
                        rng) -> dict:
    cfg, state, route = f.config, f.slot_words[0], f.routes[0]
    dev = state.device
    batches = [torch.from_numpy(rows(rng, B_SHARDED)).to(dev) for _ in range(4)]
    lengths = torch.full((B_SHARDED,), KEY_LEN, dtype=torch.int32, device=dev)
    fresh = [torch.from_numpy(rows(rng, B_SHARDED)).to(dev) for _ in range(4)]
    rows_touched, row, _, _ = sharded_rows(cfg, route, batches[0], lengths, cfg.block_bits)
    _, fresh_row, fresh_pos, fresh_owned = sharded_rows(cfg, route, fresh[0], lengths, cfg.block_bits)
    t = touched(fresh_row, fresh_pos >> 5, cfg.words_per_block, fresh_owned)
    # absent keys (`ms`: the batches before they are inserted), then present
    q_ms = cuda_ms(lambda i: sweep.blocked_query(state, batches[i % 4], lengths, cfg, route=route), 40, warm=4)
    slot = slot_query_times(g, batches, lengths)
    replay_ms = cuda_ms(lambda i: sweep.blocked_insert(state, batches[i % 4], lengths, cfg, route=route),
                        40, warm=4)
    qpres_ms = cuda_ms(lambda i: sweep.blocked_query(state, batches[i % 4], lengths, cfg, route=route),
                       40, warm=4)
    i_ms = fresh_ms(state, lambda i: sweep.blocked_insert(state, fresh[i % 4], lengths, cfg, route=route), 40)
    qp_ms = cuda_ms(lambda i: blocked.blocked_query_plain(state, batches[i % 4], lengths, cfg, route), 3, warm=1)
    ip_ms = cuda_ms(lambda i: blocked.blocked_insert_plain(state, batches[i % 4], lengths, cfg, route), 3, warm=1)
    table = state.view(torch.int32).reshape(-1, cfg.words_per_block)
    lib_ms = cuda_ms(lambda i: torch.index_select(table, 0, row), 40, warm=4)
    row_bytes = cfg.words_per_block * 4
    in_bytes = B_SHARDED * (KEY_LEN + 4)
    q_bytes = in_bytes + B_SHARDED + rows_touched * row_bytes
    i_bytes = in_bytes + 2 * rows_touched * row_bytes
    # one slot owns every key here: the routing pass, then the rest
    qb, qby = bound(q_bytes, (OPS_ROUTE + OPS_QUERY) * B_SHARDED)
    ib, iby = bound(i_bytes, (OPS_ROUTE + OPS_INSERT) * B_SHARDED)
    q_floor = floor_ms(in_bytes + B_SHARDED + B_SHARDED * row_bytes)
    del batches, fresh
    # configs 4 x 5
    ccfg, cstate, croute = fc.config, fc.slot_words[0], fc.routes[0]
    cb = [torch.from_numpy(rows(rng, B_SHARDED_COUNTING)).to(dev) for _ in range(4)]
    clen = torch.full((B_SHARDED_COUNTING,), KEY_LEN, dtype=torch.int32, device=dev)

    def upd(increment):
        return lambda i: sweep.blocked_counting_update(cstate, cb[i % 4], clen, ccfg,
                                                       increment=increment, route=croute)

    def plain(increment):
        return lambda i: counting.blocked_counting_update_plain(cstate, cb[i % 4], clen, ccfg,
                                                                increment=increment, route=croute)

    ci_ms, cd_ms = event_pairs_ms([upd(True), upd(False)], 40)
    cq_ms = cuda_ms(lambda i: sweep.blocked_counting_query(cstate, cb[i % 4], clen, ccfg, route=croute),
                    40, warm=4)
    cip_ms, cdp_ms = event_pairs_ms([plain(True), plain(False)], 3, warm=1)
    cqp_ms = cuda_ms(lambda i: counting.blocked_counting_query_plain(cstate, cb[i % 4], clen, ccfg, croute),
                     3, warm=1)
    c_rows, c_row, cpos, c_owned = sharded_rows(ccfg, croute, cb[0], clen, ccfg.counters_per_block)
    ct = touched(c_row, cpos >> 3, ccfg.words_per_block, c_owned)
    ctable = cstate.view(torch.int32).reshape(-1, ccfg.words_per_block)
    clib_ms = cuda_ms(lambda i: torch.index_select(ctable, 0, c_row), 40, warm=4)
    c_in = B_SHARDED_COUNTING * (KEY_LEN + 4)
    cu_bytes = c_in + 2 * c_rows * row_bytes
    cq_bytes = c_in + B_SHARDED_COUNTING + c_rows * row_bytes
    cub, cuby = bound(cu_bytes, (OPS_ROUTE + OPS_COUNT_UPDATE) * B_SHARDED_COUNTING)
    cqb, cqby = bound(cq_bytes, (OPS_ROUTE + OPS_COUNT_QUERY) * B_SHARDED_COUNTING)
    out = {
        "batch": B_SHARDED, "rows_touched": rows_touched, "state_bytes": state.numel() * 4,
        "touched": t,
        "sharded_blocked_query": {
            "ms": q_ms, "present_ms": qpres_ms, "keys_per_s": B_SHARDED / q_ms * 1e3,
            "plain_ms": qp_ms, "library_ms": lib_ms, "bound_ms": qb, "bound_by": qby,
            "bytes": q_bytes, "share_of_bound": qb / q_ms,
            "floor_ms": q_floor, "share_of_floor": q_floor / q_ms},
        "sharded_blocked_query_4_slots": slot,
        "sharded_blocked_insert": {
            "ms": i_ms, "replay_ms": replay_ms, "keys_per_s": B_SHARDED / i_ms * 1e3,
            "plain_ms": ip_ms, "library_ms": None, "bound_ms": ib, "bound_by": iby,
            "bytes": i_bytes, "share_of_bound": ib / i_ms, **rates(t, i_ms)},
        "counting_batch": B_SHARDED_COUNTING, "counting_rows_touched": c_rows,
        "counting_touched": ct,
        "sharded_blocked_counting_update": {
            "ms": ci_ms, "delete_ms": cd_ms, "keys_per_s": B_SHARDED_COUNTING / ci_ms * 1e3,
            "plain_ms": cip_ms, "plain_delete_ms": cdp_ms, "library_ms": None,
            "bound_ms": cub, "bound_by": cuby, "bytes": cu_bytes, "share_of_bound": cub / ci_ms,
            **rates(ct, ci_ms)},
        "sharded_blocked_counting_query": {
            "ms": cq_ms, "keys_per_s": B_SHARDED_COUNTING / cq_ms * 1e3, "plain_ms": cqp_ms,
            "library_ms": clib_ms, "bound_ms": cqb, "bound_by": cqby, "bytes": cq_bytes,
            "share_of_bound": cqb / cq_ms},
    }
    emit("sharded_times", **out)
    return out


def phase_sharded_end_to_end(f: ShardedBloomFilter, g: ShardedBloomFilter, rng, times: dict) -> None:
    big = rows(rng, B_SHARDED)
    ins, qry = times["sharded_blocked_insert"]["ms"], times["sharded_blocked_query"]["ms"]
    emit("sharded_end_to_end", **time_calls((
        ("insert_packed_1_slot", B_SHARDED, lambda: f.insert_packed(big), ins),
        ("include_packed_1_slot", B_SHARDED, lambda: f.include_packed(big), qry),
        # four launches a call, each routing the whole batch: not timed alone
        ("insert_packed_4_slots", B_SHARDED, lambda: g.insert_packed(big), None),
        ("include_packed_4_slots", B_SHARDED, lambda: g.include_packed(big), None),
    )))


# The update kernels and the bit filter's query kernels move a key's row
# with a group of lanes; the counting query kernels keep a thread a key.
GROUP_DESIGN = ("blocked_insert", "blocked_counting_update", "blocked_query",
                "sharded_blocked_insert", "sharded_blocked_counting_update",
                "sharded_blocked_query")
EXTRA_TIMES = ("replay_ms", "present_ms")


def kernels_line(launches, errs, times, c_launches, c_errs, c_times,
                 s_launches, s_errs, s_times) -> list[dict]:
    kernels = []
    for name, src, replaces, lau, err, t in (
        ("blocked_insert", "blocked_bloom.cu", "tpubloom/ops/sweep.py:1463", launches, errs, times),
        ("blocked_query", "blocked_bloom.cu", "tpubloom/ops/sweep.py:2437", launches, errs, times),
        # K4 (fat storage) and K2 (sweep.py:582, logical view): one kernel
        ("blocked_counting_update", "blocked_counting.cu", "tpubloom/ops/sweep.py:1976",
         c_launches, c_errs, c_times),
        # no Pallas counterpart: the XLA gather fat_blocked_counting_membership
        ("blocked_counting_query", "blocked_counting.cu", "tpubloom/ops/counting.py:115",
         c_launches, c_errs, c_times),
        # K1, the sharded per-device insert (tpubloom/parallel/sharded.py:282,292)
        ("sharded_blocked_insert", "blocked_bloom.cu", "tpubloom/ops/sweep.py:241",
         s_launches, s_errs, s_times),
        # K5 inside shard_map (sharded.py:348), the row gather otherwise
        ("sharded_blocked_query", "blocked_bloom.cu", "tpubloom/ops/sweep.py:2437",
         s_launches, s_errs, s_times),
        # K2 (sharded.py:507,525) and K4 (:500) in the sharded counting loop
        ("sharded_blocked_counting_update", "blocked_counting.cu", "tpubloom/ops/sweep.py:582",
         s_launches, s_errs, s_times),
        # the gathers fat_blocked_counting_membership / blocked_counting_membership in shard_map
        ("sharded_blocked_counting_query", "blocked_counting.cu", "tpubloom/ops/counting.py:115",
         s_launches, s_errs, s_times),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": f"tpubloom_torch/csrc/{src}",
            "replaces": replaces, "launches": lau[name], "max_abs_err": err[name],
            "ms": t[name]["ms"], "plain_ms": t[name]["plain_ms"], "bound_ms": t[name]["bound_ms"],
            "bound_by": t[name]["bound_by"], "library_ms": t[name]["library_ms"],
            "design": "lane group a key" if name in GROUP_DESIGN else "thread a key",
            **{k: t[name][k] for k in EXTRA_TIMES if k in t[name]},
        })
    kernels[2]["also_replaces"] = "tpubloom/ops/sweep.py:582"
    kernels[4]["also_replaces"] = "tpubloom/ops/sweep.py:1463 (K3 at tpubloom/parallel/sharded.py:274)"
    kernels[6]["also_replaces"] = "tpubloom/ops/sweep.py:1976 (K4 at tpubloom/parallel/sharded.py:500)"
    return kernels


def times_only() -> dict:
    """Phases 5, 9 and 14 alone, on filters filled as the full run fills
    them before those phases: five batches of B in the main filter, one
    batch in each of the others."""
    rng = np.random.default_rng(SEED)
    f = BlockedBloomFilter(FilterConfig(m=1 << LOG2M, k=K, key_len=KEY_LEN, block_bits=BLOCK_BITS))
    for _ in range(5):
        f.insert_packed(rows(rng, B))
    times = phase_times(f, rng)
    del f
    torch.cuda.empty_cache()
    cf = BlockedCountingBloomFilter(counting_config(LOG2M_COUNTING))
    cf.insert_packed(rows(rng, B_COUNTING))
    c_times = phase_counting_times(cf, rng)
    del cf
    torch.cuda.empty_cache()
    sf = ShardedBloomFilter(sharded_config(LOG2M_SHARDED))
    sg = ShardedBloomFilter(sharded_config(LOG2M_SHARDED), devices=["cuda"] * N_SLOTS)
    first = rows(rng, B_SHARDED)
    sf.insert_packed(first)
    sg.insert_packed(first)
    sfc = ShardedBloomFilter(sharded_config(LOG2M_SHARDED_COUNTING, counting=True))
    sfc.insert_packed(rows(rng, B_SHARDED_COUNTING))
    s_times = phase_sharded_times(sf, sg, sfc, rng)
    return {"times": times, "counting_times": c_times, "sharded_times": s_times}


def phase_ab(other: Path) -> None:
    """``--times`` in ``other`` (with this script copied in), here, here
    and ``other``, each in a process of its own on the same card; the
    four runs' kernel times, touched counts and ptxas lines."""
    here = Path(__file__).resolve()
    shutil.copy(here, other / here.name)
    runs = []
    for label, tree in (("other", other), ("this", here.parent), ("this", here.parent), ("other", other)):
        proc = subprocess.run([sys.executable, here.name, "--times"], cwd=tree,
                              capture_output=True, text=True, timeout=1500)
        if proc.returncode:
            raise RuntimeError(f"--times in {tree} failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        run = json.loads(proc.stdout.strip().splitlines()[-1])["times_only"]
        runs.append({"tree": label, "path": str(tree), **run})
        summary = {name: {k: v for k, v in run[phase][name].items()
                          if k in ("ms", "present_ms", "replay_ms", "delete_ms", "share_of_bound")}
                   for phase, name in (("times", "blocked_insert"), ("times", "blocked_query"),
                                       ("counting_times", "blocked_counting_update"),
                                       ("counting_times", "blocked_counting_query"),
                                       ("sharded_times", "sharded_blocked_insert"),
                                       ("sharded_times", "sharded_blocked_query"),
                                       ("sharded_times", "sharded_blocked_query_4_slots"),
                                       ("sharded_times", "sharded_blocked_counting_update"))
                   if name in run[phase]}
        emit("ab_run", tree=label, kernels=summary)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "ab_times.json").write_text(json.dumps(runs, indent=1))


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--times", action="store_true", help="device, build and the timing phases only")
    ap.add_argument("--ab", type=Path, metavar="DIR",
                    help="--times in DIR, here, here and DIR; writes chiprun_out/ab_times.json")
    args = ap.parse_args(argv)
    dev = phase_device()
    if args.ab:
        phase_ab(args.ab.resolve())
        return 0
    phase_build()
    if args.times:
        print(json.dumps({"times_only": {**times_only(), "build": RECORD["build"]}}), flush=True)
        return 0
    rng = np.random.default_rng(SEED)
    errs = phase_kernel_vs_plain(rng)
    launches, f = phase_main_path(rng)
    times = phase_times(f, rng)
    phase_end_to_end(f, rng, times)
    del f
    torch.cuda.empty_cache()
    c_errs = phase_counting_kernel_vs_plain(rng)
    c_launches, cf = phase_counting_path(rng)
    c_times = phase_counting_times(cf, rng)
    phase_counting_end_to_end(cf, rng, c_times)
    del cf
    torch.cuda.empty_cache()
    phase_checkpoint_roundtrip(rng)
    torch.cuda.empty_cache()
    s_errs = phase_sharded_kernel_vs_plain(rng)
    s_launches, sf, sg, sfc = phase_sharded_path(rng)
    s_times = phase_sharded_times(sf, sg, sfc, rng)
    phase_sharded_end_to_end(sf, sg, rng, s_times)
    del sf, sg, sfc
    torch.cuda.empty_cache()
    kernels = kernels_line(launches, errs, times, c_launches, c_errs, c_times,
                           s_launches, s_errs, s_times)
    RECORD["kernels"] = kernels
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(RECORD, indent=1))
    print(dev["nvidia_smi"], flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                              "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
