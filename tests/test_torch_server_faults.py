"""Fault points of the port's sharded filter and checkpoint sink, held
against ``tpubloom``'s on the CPU with the same keys, configs and arming:

* ``shard.insert`` / ``shard.query`` / ``shard.delete`` fire once per
  shard a batch routes to, with ``shard=<index>``, on the list, packed and
  staged entry points, in the same order as the reference's sharded filter
  (port: one CPU slot; tpubloom: its 8-device CPU mesh); an armed
  ``shard=N`` predicate fails exactly the batches that touch shard N, and
  the server answers the same for it;
* ``ckpt.write`` (raise and torn), ``ckpt.fsync`` and ``ckpt.restore_read``
  give the same ``Checkpoint`` / ``CreateFilter`` answers, the same Health
  reasons and the same ``ckpt_*`` counters as the reference server; a
  capped quarantine evicts and counts as the reference's does."""

import os
import re

import msgpack
import numpy as np
import pytest
import torch

import grpc

import tpubloom
from tpubloom import checkpoint as jck
from tpubloom import faults as jfaults
from tpubloom.obs import counters as jcounters
from tpubloom.parallel import sharded as jsharded
from tpubloom.server import service as jservice
from tpubloom_torch import FilterConfig, ShardedBloomFilter
from tpubloom_torch import checkpoint as ck
from tpubloom_torch import faults
from tpubloom_torch.obs import blackbox, counters, flight, trace
from tpubloom_torch.parallel import sharded
from tpubloom_torch.server import protocol, service

L = 16
SHARD_CFG = dict(m=1 << 20, k=5, key_len=L, block_bits=512, shards=8)
POINTS = ("shard.insert", "shard.query", "shard.delete")


@pytest.fixture(autouse=True)
def both_registries():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()
    trace.reset_for_tests()
    flight.reset_for_tests()
    blackbox.reset_for_tests()
    counters.reset_for_tests()


def _record(monkeypatch, module, fault_mod, log):
    """Record every pass through ``module``'s fault hook (the hook still
    runs, so armed predicates still trigger)."""
    real = fault_mod.fire

    def fire(point, **ctx):
        log.append((point, ctx.get("shard")))
        return real(point, **ctx)

    monkeypatch.setattr(module.faults, "fire", fire)


def _arm_unmatched(fault_mod):
    """Arm each shard point with a predicate no shard matches: the hooks
    route and pass through, nothing fires."""
    for p in POINTS:
        fault_mod.arm(p, "always", pred={"shard": -1})


def _drive(f, keys, rows, counting):
    f.insert_batch(keys)
    f.include_batch(keys)
    f.insert_packed(rows)
    f.include_packed(rows)
    f.launch_query(f.stage_batch(keys))
    if counting:
        f.delete_batch(keys)


@pytest.mark.parametrize("counting", [False, True], ids=["bits", "counting"])
def test_shard_points_fire_per_routed_shard_like_tpubloom(counting, monkeypatch):
    rng = np.random.default_rng(7 + counting)
    keys = [rng.bytes(L) for _ in range(5)]  # a few keys: a few shards
    rows = np.frombuffer(b"".join(keys), np.uint8).reshape(len(keys), L)
    cfg = dict(SHARD_CFG, counting=counting)
    port = ShardedBloomFilter(FilterConfig(**cfg), devices=["cpu"])
    ref = jsharded.ShardedBloomFilter(tpubloom.FilterConfig(**cfg))
    got, want = [], []
    _record(monkeypatch, sharded, faults, got)
    _record(monkeypatch, jsharded, jfaults, want)
    _arm_unmatched(faults)
    _arm_unmatched(jfaults)
    _drive(port, keys, rows, counting)
    _drive(ref, keys, rows, counting)
    assert got == want
    assert {p for p, _ in got} == set(POINTS if counting else POINTS[:2])
    assert 1 < len({s for _, s in got}) < 8
    # disarmed, the hooks do not route at all
    faults.reset()
    got.clear()
    _drive(port, keys, rows, counting)
    assert got == []


@pytest.mark.parametrize("point", POINTS)
def test_armed_shard_predicate_fails_only_batches_touching_it(point):
    rng = np.random.default_rng(11)
    cfg = dict(SHARD_CFG, counting=point == "shard.delete")
    port = ShardedBloomFilter(FilterConfig(**cfg), devices=["cpu"])
    keys = [rng.bytes(L) for _ in range(64)]
    keys_u8, lengths, _ = port._pack_padded(keys)
    routes = sharded.route_shards(torch.from_numpy(keys_u8), torch.from_numpy(lengths),
                                  8, port.config.seed).numpy()[:64]
    target = int(routes[0])
    hit = [k for k, r in zip(keys, routes) if r == target]
    miss = [k for k, r in zip(keys, routes) if r != target]
    op = {"shard.insert": port.insert_batch, "shard.query": port.include_batch,
          "shard.delete": port.delete_batch}[point]
    if point == "shard.delete":
        port.insert_batch(keys)
    faults.arm(point, "always", pred={"shard": target})
    with pytest.raises(faults.InjectedFault):
        op(hit)
    op(miss)  # no key routes to the armed shard: the batch proceeds


class _Server:
    def __init__(self, svc):
        self.service = svc
        build = service.build_server if isinstance(svc, service.BloomService) \
            else jservice.build_server
        self.srv, port = build(svc, "127.0.0.1:0")
        self.srv.start()
        self.channel = grpc.insecure_channel(f"127.0.0.1:{port}")

    def call(self, method, req):
        fn = self.channel.unary_unary(
            protocol.method_path(method),
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b,
        )
        return msgpack.unpackb(fn(msgpack.packb(req, use_bin_type=True)), raw=False)

    def close(self):
        self.channel.close()
        self.srv.stop(grace=None)


def _servers(tmp_path, **sink_kw):
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    j = _Server(jservice.BloomService(
        sink_factory=lambda c: jck.FileSink(jdir, **sink_kw)))
    p = _Server(service.BloomService(
        sink_factory=lambda c: ck.FileSink(pdir, **sink_kw), device="cpu"))
    return j, p, jdir, pdir


def _same(j, p, method, req):
    """Send one request to both servers; their answers must be equal but
    for the generation seqs, which each package takes from its own
    millisecond clock."""
    want, got = j.call(method, req), p.call(method, req)
    for k in ("seq", "restored_seq"):
        want.pop(k, None)
        got.pop(k, None)
    if not want.get("ok", True):
        # InjectedFault's message names the point; the class path differs
        want["error"].pop("message"), got["error"].pop("message")
    assert got == want, (method, req.get("name"))
    return got


def _arm_both(point, policy="always", **kw):
    faults.arm(point, policy, **kw)
    jfaults.arm(point, policy, **kw)


def _counter_deltas(names, before):
    return {n: (counters.get(n) - before[0][n], jcounters.get(n) - before[1][n])
            for n in names}


def _listing(directory):
    """A sink directory's file names with the generation seqs blanked."""
    return sorted(re.sub(r"\.\d+\.ckpt", ".<seq>.ckpt", n) for n in os.listdir(directory))


CKPT_COUNTERS = ("ckpt_corrupt_detected", "ckpt_restore_read_errors",
                 "ckpt_quarantine_evicted")


def test_sharded_server_answers_shard_faults_like_tpubloom(tmp_path):
    j, p, _, _ = _servers(tmp_path)
    try:
        create = {"name": "s", "config": dict(SHARD_CFG)}
        _same(j, p, "CreateFilter", create)
        keys = [bytes([i]) * L for i in range(40)]
        _same(j, p, "InsertBatch", {"name": "s", "keys": keys})
        _arm_both("shard.query", pred={"shard": 3})
        r = _same(j, p, "QueryBatch", {"name": "s", "keys": keys})
        assert r["ok"] is False and r["error"]["code"] == "INTERNAL"
        _arm_both("shard.insert", "once")
        r = _same(j, p, "InsertBatch", {"name": "s", "keys_fixed": {
            "data": b"".join(keys), "width": L, "n": len(keys)}})
        assert r["ok"] is False
        faults.reset()
        jfaults.reset()
        _same(j, p, "QueryBatch", {"name": "s", "keys": keys})
    finally:
        j.close()
        p.close()


def test_checkpoint_faults_answer_like_tpubloom(tmp_path):
    j, p, jdir, pdir = _servers(tmp_path)
    names = CKPT_COUNTERS
    before = ({n: counters.get(n) for n in names}, {n: jcounters.get(n) for n in names})
    try:
        create = {"name": "c", "config": {"m": 1 << 16, "k": 5, "key_len": L,
                                          "block_bits": 512}}
        _same(j, p, "CreateFilter", create)
        _same(j, p, "InsertBatch", {"name": "c", "keys": [b"a" * L, b"b" * L]})
        good = _same(j, p, "Checkpoint", {"name": "c"})
        assert good["ok"]

        # a raise before the write or before fsync fails the checkpoint
        # and leaves no partial file; Health reports the error
        for point in ("ckpt.write", "ckpt.fsync"):
            _arm_both(point, "once")
            r = _same(j, p, "Checkpoint", {"name": "c"})
            assert r["ok"] is False and r["error"]["code"] == "CKPT_FAILED"
            hj, hp = j.call("Health", {}), p.call("Health", {})
            assert hp["status"] == hj["status"] == "DEGRADED"
            assert hp["reasons"] == hj["reasons"] == ["checkpoint_error:c"]
            assert _listing(pdir) == _listing(jdir)
            _same(j, p, "Checkpoint", {"name": "c"})  # a success clears it

        # a torn write lands half a blob; the restore walk detects it,
        # quarantines it and restores the previous generation
        _same(j, p, "InsertBatch", {"name": "c", "keys": [b"c" * L]})
        _arm_both("ckpt.write", "once", mode="torn")
        _same(j, p, "Checkpoint", {"name": "c"})
        _same(j, p, "DropFilter", {"name": "c", "final_checkpoint": False})
        r = _same(j, p, "CreateFilter", create)
        assert r["ok"] and not r["existed"]
        hj, hp = j.call("Health", {}), p.call("Health", {})
        assert hp["reasons"] == hj["reasons"] == ["checkpoint_corrupt:c"]
        assert _listing(os.path.join(pdir, "corrupt")) == \
            _listing(os.path.join(jdir, "corrupt")) == ["c.<seq>.ckpt"]
        q = {"name": "c", "keys": [b"a" * L, b"c" * L, b"z" * L]}
        assert _same(j, p, "QueryBatch", q)["ok"]

        # an unreadable newest generation is skipped, not quarantined
        _same(j, p, "InsertBatch", {"name": "c", "keys": [b"d" * L]})
        _same(j, p, "Checkpoint", {"name": "c"})
        _same(j, p, "DropFilter", {"name": "c", "final_checkpoint": False})
        _arm_both("ckpt.restore_read", "once")
        r = _same(j, p, "CreateFilter", create)
        assert r["ok"]
        _same(j, p, "QueryBatch", {"name": "c", "keys": [b"d" * L, b"a" * L]})
        deltas = _counter_deltas(names, before)
        assert deltas["ckpt_corrupt_detected"] == (1, 1)
        assert deltas["ckpt_restore_read_errors"] == (1, 1)
    finally:
        j.close()
        p.close()


def test_quarantine_cap_evicts_and_counts_like_tpubloom(tmp_path):
    """Two corrupt generations under a quarantine cap that holds one: the
    older is evicted and counted, in both packages."""
    results = {}
    for pkg, sink_cls, cnt in (("jax", jck.FileSink, jcounters), ("port", ck.FileSink, counters)):
        d = tmp_path / pkg
        sink = sink_cls(str(d), quarantine_max_bytes=64)
        before = cnt.get("ckpt_quarantine_evicted")
        for seq in (1, 2):
            sink.put("q", seq, b"x" * 48)
            sink.quarantine("q", seq)
        results[pkg] = (cnt.get("ckpt_quarantine_evicted") - before,
                        sorted(os.listdir(d / "corrupt")))
    assert results["port"] == results["jax"] == (1, ["q.000000000002.ckpt"])
