"""The port's multi-process filter array (``tpubloom_torch.parallel.
distributed`` and the rank-aware ``ShardedBloomFilter``) against tpubloom's
on the CPU:

* the single-process topology has the reference's keys and process
  counts (the device counts differ: tpubloom counts the fake CPU devices,
  the port CUDA cards);
* ``dist.initialize`` armed ``once`` raises before any join;
* one pair of processes joined over gloo on localhost (the counterpart of
  ``tests/test_distributed.py``, whose JAX version skips on this CPU
  backend): 8 shards over 2 ranks, m=2^16, k=5, 128 held and 128 fresh
  16-byte keys, in the flat, blocked (512) and both counting layouts. Each
  rank's shard words and the all-reduced verdicts equal those of
  ``tpubloom.parallel.sharded.ShardedBloomFilter`` on the 8 fake CPU
  devices (tolerance 0). The same ranks check what a rank may not do
  alone: ``to_bytes``, ``from_bytes`` and checkpoint blobs raise there,
  and ``words_logical`` / ``stats`` cover the rank's own shards."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch.distributed as dist

import tpubloom
from tpubloom.parallel.distributed import initialize_multihost as jinitialize
from tpubloom.parallel.sharded import ShardedBloomFilter as JSharded
from tpubloom.parallel.sharded import make_mesh
from tpubloom_torch import faults
from tpubloom_torch.parallel.distributed import initialize_multihost, shutdown, topology

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(m=1 << 16, k=5, key_len=16, shards=8)
LAYOUTS = {
    "flat": {"block_bits": 0},
    "blocked": {"block_bits": 512},
    "counting": {"block_bits": 512, "counting": True},
    "flat_counting": {"block_bits": 0, "counting": True},
}
N_DELETE = 32  # counting layouts delete the first held keys again


@pytest.fixture(autouse=True)
def disarmed():
    faults.reset()
    yield
    faults.reset()


def _keys():
    rng = np.random.default_rng(0)  # the same seed in every process
    held = [rng.bytes(16) for _ in range(128)]
    fresh = [rng.bytes(16) for _ in range(128)]
    return held, fresh


def test_single_process_topology_matches_reference():
    got, want = initialize_multihost(), jinitialize()
    assert set(got) == set(want)
    assert got["process_index"] == want["process_index"] == 0
    assert got["process_count"] == want["process_count"] == 1
    assert got["global_device_count"] == got["local_device_count"]
    assert not dist.is_initialized()
    assert topology() == got
    shutdown()  # a no-op with no group


def test_dist_initialize_fault_fires_before_any_join():
    faults.arm("dist.initialize", "once")
    # the coordinator does not exist: had the join run first, it would
    # have failed on the connection, not on the fault
    with pytest.raises(faults.InjectedFault):
        initialize_multihost("127.0.0.1:1", 2, 0, backend="gloo", timeout_s=5)
    assert not dist.is_initialized()
    assert initialize_multihost()["process_count"] == 1  # spent: a no-op


def test_multi_process_join_needs_its_coordinates():
    with pytest.raises(ValueError, match="coordinator_address"):
        initialize_multihost(None, 2, 0, backend="gloo")
    assert not dist.is_initialized()


_RANK = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist

coord, rank, out, layouts = sys.argv[1], int(sys.argv[2]), sys.argv[3], json.loads(sys.argv[4])
from tpubloom_torch.parallel.distributed import initialize_multihost, shutdown

topo = initialize_multihost(coord, 2, rank, backend="gloo", timeout_s=90)
assert topo["process_index"] == rank and topo["process_count"] == 2, topo
try:
    initialize_multihost(coord, 2, rank, backend="gloo")
    raise AssertionError("a second join did not raise")
except RuntimeError:
    pass

from tpubloom_torch import FilterConfig, ShardedBloomFilter
from tpubloom_torch import checkpoint as ck

rng = np.random.default_rng(0)
held = [rng.bytes(16) for _ in range(128)]
fresh = [rng.bytes(16) for _ in range(128)]
result = {}
arrays = {}
for name, kw in layouts.items():
    cfg = FilterConfig(**kw)
    f = ShardedBloomFilter(cfg, devices=["cpu"] * 2)
    f.insert_batch(held)
    if cfg.counting:
        f.delete_batch(held[:%(n_delete)d])
    arrays[name + "_words"] = f.words_logical
    arrays[name + "_verdicts"] = f.include_batch(held + fresh)
    raised = []
    for what, call in (
        ("to_bytes", f.to_bytes),
        ("from_bytes", lambda: ShardedBloomFilter.from_bytes(cfg, b"", devices=["cpu"])),
        ("snapshot_blob", lambda: ck.snapshot_blob(f, seq=1)),
    ):
        try:
            call()
        except ValueError as e:
            assert "whole filter" in str(e), e
            raised.append(what)
    st = f.stats()
    if not cfg.counting:
        fills = f.shard_fill_ratios()
        assert len(fills) == 4 and abs(f.fill_ratio() - sum(fills) / 4) < 1e-12
        assert abs(st["fill_ratio"] - sum(fills) / 4) < 1e-12
    result[name] = {
        "base": f.shard_base, "local": f.shards_local, "raised": raised,
        "stats": {k: st[k] for k in ("rank", "world_size", "shard_base", "shards_local")},
        "routes": [(r.shard_lo, r.shards_per_dev) for r in f.routes],
    }
np.savez(out + ".npz", **arrays)
with open(out + ".json", "w") as fh:
    json.dump({"topology": topo, "layouts": result}, fh)
shutdown()
assert not dist.is_initialized()
print("RANK%%d OK" %% rank, flush=True)
""" % {"n_delete": N_DELETE}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_ranks_over_gloo_equal_tpubloom(tmp_path):
    script = tmp_path / "rank.py"
    script.write_text(_RANK)
    layouts = {name: {**BASE, **kw} for name, kw in LAYOUTS.items()}
    coord = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), coord, str(rank), str(tmp_path / f"r{rank}"),
             json.dumps(layouts)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        for rank in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("the two-rank group hung: " + " | ".join(outs))
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK{rank} OK" in out, f"rank {rank}:\n{out[-3000:]}"

    held, fresh = _keys()
    for name, kw in LAYOUTS.items():
        j = JSharded(tpubloom.FilterConfig(**BASE, **kw), mesh=make_mesh(8))
        j.insert_batch(held)
        if kw.get("counting"):
            j.delete_batch(held[:N_DELETE])
        want_words = np.asarray(j.words_logical).reshape(BASE["shards"], -1)
        want_hits = np.asarray(j.include_batch(held + fresh))
        assert want_hits[N_DELETE:128].all() and want_hits[128:].mean() < 0.1
        for rank in (0, 1):
            arrays = np.load(tmp_path / f"r{rank}.npz")
            meta = json.loads((tmp_path / f"r{rank}.json").read_text())["layouts"][name]
            first = 4 * rank
            assert meta["base"] == first and meta["local"] == 4
            assert meta["routes"] == [[first, 2], [first + 2, 2]]
            assert meta["stats"] == {"rank": rank, "world_size": 2,
                                     "shard_base": first, "shards_local": 4}
            assert meta["raised"] == ["to_bytes", "from_bytes", "snapshot_blob"]
            words = arrays[f"{name}_words"]
            assert words.shape[0] == 4
            np.testing.assert_array_equal(words.reshape(4, -1), want_words[first : first + 4])
            np.testing.assert_array_equal(arrays[f"{name}_verdicts"], want_hits)
