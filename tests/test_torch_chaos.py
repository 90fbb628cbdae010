"""Fault points of the port armed against the port, in process on the CPU.

Each test arms one point of ``tpubloom_torch.faults.KNOWN_POINTS`` by
literal and checks the port's failure answer, as the reference's suites
do for ``tpubloom`` (the test each mirrors is named in its docstring):

* ``shard.insert`` / ``shard.query`` / ``shard.delete`` — a ``shard=N``
  predicate fails only the batches that touch shard N;
* ``ckpt.write`` (torn), ``ckpt.fsync``, ``ckpt.restore_read`` — the
  checkpoint sink's failure paths fall back a generation or leave nothing;
* ``rpc.pre_handle`` / ``rpc.post_handle`` — a request fails before it
  applies, or after, and its same-rid retry applies once;
* ``ingest.coalesce`` / ``ingest.flush`` — a coalesced write fails before
  anything applies, and the retry applies once;
* ``stream.recv`` / ``stream.ack`` — a bidi stream dies before or after
  its frame applied, reconnects, and every frame applies once;
* ``repl.ack_recv`` / ``repl.reappend`` — the primary kills a replica's
  ack stream, which reopens; a chained replica's re-append dies and the
  record still lands once.

``dist.initialize`` is armed in ``tests/test_torch_distributed.py``."""

import numpy as np
import pytest
import torch

from tests.test_torch_repl_stream import Node, _wait
from tpubloom_torch import FilterConfig, ShardedBloomFilter, faults
from tpubloom_torch import checkpoint as ck
from tpubloom_torch.filter import BloomFilter
from tpubloom_torch.obs import blackbox, counters, flight, trace
from tpubloom_torch.ops.hashing import route_shards
from tpubloom_torch.server import protocol
from tpubloom_torch.server.client import BloomClient
from tpubloom_torch.server.ingest import CoalesceConfig
from tpubloom_torch.server.service import BloomService, build_server
from tpubloom_torch.utils.packing import pack_keys

L = 16


@pytest.fixture(autouse=True)
def port_globals():
    faults.reset()
    yield
    faults.reset()
    trace.reset_for_tests()
    flight.reset_for_tests()
    blackbox.reset_for_tests()
    counters.reset_for_tests()


def _rand_keys(n, rng):
    return [rng.bytes(L) for _ in range(n)]


# -- shard.* ------------------------------------------------------------------


def _split_by_shard(cfg, keys):
    """(keys of one shard, keys of the others) for a batch."""
    ks, ls = pack_keys(keys, cfg.key_len)
    routes = route_shards(torch.from_numpy(ks), torch.from_numpy(ls),
                          cfg.shards, cfg.seed).numpy()
    target = int(routes[0])
    hit = [k for k, r in zip(keys, routes) if r == target]
    miss = [k for k, r in zip(keys, routes) if r != target]
    assert hit and miss, "batch did not spread over shards"
    return target, hit, miss


def test_shard_insert_and_query_faults_fail_only_their_shard():
    """``tests/test_faults.py::test_shard_fault_point_predicate_partial_failure``."""
    cfg = FilterConfig(m=1 << 20, k=4, key_len=L, shards=8, block_bits=512)
    f = ShardedBloomFilter(cfg, devices=["cpu"] * 2)
    target, hit, miss = _split_by_shard(cfg, _rand_keys(256, np.random.default_rng(11)))
    miss = miss[:32]

    faults.arm("shard.insert", "always", pred={"shard": target})
    with pytest.raises(faults.InjectedFault):
        f.insert_batch(hit[:4])
    assert not f.include_batch(hit[:4]).any(), "a failed insert applied"
    f.insert_batch(miss)  # routed around the shard: lands
    assert f.include_batch(miss).all()
    faults.disarm("shard.insert")

    faults.arm("shard.query", "once", pred={"shard": target})
    assert f.include_batch(miss).all()  # does not touch the shard
    with pytest.raises(faults.InjectedFault):
        f.include_batch(hit[:2])
    assert not f.include_batch(hit[:2]).any()  # budget spent: it answers again
    assert counters.get("fault_shard_insert") >= 1
    assert counters.get("fault_shard_query") == 1


def test_shard_delete_fault_fails_only_its_shard_and_decrements_nothing():
    """``tests/test_faults.py::test_shard_delete_fault_point_predicate_partial_failure``."""
    cfg = FilterConfig(m=1 << 20, k=4, key_len=L, shards=8, block_bits=512, counting=True)
    f = ShardedBloomFilter(cfg, devices=["cpu"] * 2)
    target, hit, miss = _split_by_shard(cfg, _rand_keys(256, np.random.default_rng(13)))
    hit, miss = hit[:8], miss[:32]
    f.insert_batch(hit + miss)  # every count exactly 1

    faults.arm("shard.delete", "always", pred={"shard": target})
    with pytest.raises(faults.InjectedFault):
        f.delete_batch(hit[:4])
    assert f.include_batch(hit).all(), "a failed delete decremented anyway"
    f.delete_batch(miss)
    assert not f.include_batch(miss).any()
    assert counters.get("fault_shard_delete") >= 1
    faults.disarm("shard.delete")
    f.delete_batch(hit)
    assert not f.include_batch(hit).any()


# -- ckpt.* ---------------------------------------------------------------------


@pytest.fixture
def cfg():
    return FilterConfig(m=1 << 14, k=5, key_len=L, key_name="chaos")


def _filter_with_keys(cfg, n=500, seed=0):
    f = BloomFilter(cfg, device="cpu")
    keys = _rand_keys(n, np.random.default_rng(seed))
    f.insert_batch(keys)
    return f, keys


def test_torn_write_fault_caught_on_restore(cfg, tmp_path):
    """``tests/test_faults.py::test_torn_write_fault_caught_on_restore``:
    a torn write lands half a blob without an error; the CRC walk finds it
    and the previous generation wins."""
    sink = ck.FileSink(str(tmp_path))
    f, keys = _filter_with_keys(cfg)
    ck.save(f, sink, seq=1)
    faults.arm("ckpt.write", "once", mode="torn")
    ck.save(f, sink, seq=2)  # no exception: silent corruption
    before = counters.get("ckpt_corrupt_detected")
    g = ck.restore(cfg, sink, device="cpu")
    assert g._restored_seq == 1 and g.include_batch(keys).all()
    assert counters.get("ckpt_corrupt_detected") == before + 1


def test_fsync_fault_leaves_no_partial_ckpt(cfg, tmp_path):
    """``tests/test_faults.py::test_fsync_fault_leaves_no_partial_ckpt``."""
    import os

    sink = ck.FileSink(str(tmp_path))
    f, _ = _filter_with_keys(cfg)
    ck.save(f, sink, seq=1)
    faults.arm("ckpt.fsync", "always")
    with pytest.raises(faults.InjectedFault):
        ck.save(f, sink, seq=2)
    faults.reset()
    assert set(os.listdir(tmp_path)) == {"chaos.000000000001.ckpt"}
    assert ck.restore(cfg, sink, device="cpu")._restored_seq == 1


def test_restore_read_fault_skips_generation(cfg, tmp_path):
    """``tests/test_faults.py::test_restore_read_fault_skips_generation``."""
    sink = ck.FileSink(str(tmp_path))
    f, _ = _filter_with_keys(cfg)
    ck.save(f, sink, seq=1)
    ck.save(f, sink, seq=2)
    before = counters.get("ckpt_restore_read_errors")
    faults.arm("ckpt.restore_read", "once")
    assert ck.restore(cfg, sink, device="cpu")._restored_seq == 1
    assert counters.get("ckpt_restore_read_errors") == before + 1
    assert not (tmp_path / "corrupt").exists()  # the bytes may be fine
    assert ck.restore(cfg, sink, device="cpu")._restored_seq == 2


# -- rpc.*, ingest.*, stream.* on an in-process port server ----------------------


class _Server:
    def __init__(self, service):
        self.service = service
        self.server, port = build_server(service, "127.0.0.1:0")
        self.server.start()
        self.addr = f"127.0.0.1:{port}"

    def client(self, **kw) -> BloomClient:
        return BloomClient(self.addr, **kw)

    def stop(self):
        self.service.shutdown()
        self.server.stop(grace=None)


@pytest.fixture
def plain_server():
    s = _Server(BloomService(device="cpu"))
    yield s
    s.stop()


@pytest.fixture
def coalesced_server():
    s = _Server(BloomService(coalesce=CoalesceConfig(max_keys=4096, max_wait_us=2000),
                             device="cpu"))
    yield s
    s.stop()


def test_rpc_pre_handle_fault_fails_before_apply(plain_server):
    """``tests/test_faults.py`` (``rpc.pre_handle``): the request dies in
    the RPC wrapper before its handler, so nothing applies."""
    with plain_server.client(max_retries=0) as c:
        c.wait_ready()
        c.create_filter("cnt", capacity=20_000, error_rate=0.01, counting=True)
        keys = [b"pre-%04d" % i for i in range(32)]
        req = c._encode_keys({"name": "cnt"}, keys)
        faults.arm("rpc.pre_handle", "once")
        with pytest.raises(protocol.BloomServiceError, match="INTERNAL"):
            c._rpc("InsertBatch", dict(req), rid="pre-handle-rid-1")
        assert counters.get("fault_rpc_pre_handle") == 1
        assert not c.include_batch("cnt", keys).any()
        # the same rid again: nothing was cached, so it applies now, once
        resp = c._rpc("InsertBatch", dict(req), rid="pre-handle-rid-1")
        assert resp["ok"] and resp["n"] == len(keys)
        c.delete_batch("cnt", keys)  # count 1: one delete empties it
        assert not c.include_batch("cnt", keys).any()


def test_rpc_post_handle_response_loss_absorbed_by_dedup(plain_server):
    """``tests/test_faults.py::test_rpc_post_handle_response_loss_absorbed_by_dedup``."""
    with plain_server.client(max_retries=0) as c:
        c.wait_ready()
        c.create_filter("cnt", capacity=20_000, error_rate=0.01, counting=True)
        keys = [b"pl-%04d" % i for i in range(64)]
        req = c._encode_keys({"name": "cnt"}, keys)
        faults.arm("rpc.post_handle", "once")
        with pytest.raises(protocol.BloomServiceError, match="INTERNAL"):
            c._rpc("InsertBatch", dict(req), rid="post-handle-rid-1")
        assert counters.get("fault_rpc_post_handle") >= 1
        assert c.include_batch("cnt", keys).all()  # the apply landed
        resp = c._rpc("InsertBatch", dict(req), rid="post-handle-rid-1")
        assert resp["ok"] and resp["n"] == len(keys)
        c.delete_batch("cnt", keys)
        assert not c.include_batch("cnt", keys).any(), "the retry applied twice"


def test_ingest_flush_fault_fails_flush_then_heals(coalesced_server):
    """``tests/test_ingest.py::test_ingest_flush_fault_fails_flush_then_heals``."""
    with coalesced_server.client() as c:
        c.create_filter("chaos", capacity=100_000, error_rate=0.01, counting=True)
        keys = [b"cf-%d" % j for j in range(32)]
        faults.arm("ingest.flush", "once")
        with pytest.raises(protocol.BloomServiceError) as ei:
            c.insert_batch("chaos", keys)
        assert ei.value.code == "INTERNAL"
        assert not c.include_batch("chaos", keys).any(), "a failed flush applied"
        assert c.insert_batch("chaos", keys) == 32
        c.delete_batch("chaos", keys)
        assert not c.include_batch("chaos", keys).any(), "double-applied"


def test_ingest_coalesce_fault_fires_pre_park(coalesced_server):
    """``tests/test_ingest.py::test_ingest_coalesce_fault_fires_pre_park``."""
    with coalesced_server.client() as c:
        c.create_filter("chaos2", capacity=100_000, error_rate=0.01)
        faults.arm("ingest.coalesce", "once")
        with pytest.raises(protocol.BloomServiceError):
            c.insert_batch("chaos2", [b"x"])
        assert counters.get("fault_ingest_coalesce") == 1
        assert not c.include_batch("chaos2", [b"x"]).any()
        assert c.insert_batch("chaos2", [b"x"]) == 1


def _exactly_once(client, name, frames):
    """Every key present, and ONE delete clears it: a frame applied twice
    would leave a count of 2."""
    for keys in frames.values():
        assert client.include_batch(name, keys).all()
        client.delete_batch(name, keys)
        assert not client.include_batch(name, keys).any(), "a replayed frame applied twice"


def test_stream_recv_fault_reconnect_replays_unapplied(coalesced_server):
    """``tests/test_streams.py::test_stream_recv_fault_reconnect_replays_unapplied``."""
    c = coalesced_server.client()
    try:
        c.wait_ready()
        c.create_filter("cnt", capacity=50_000, error_rate=0.01, counting=True)
        frames = {i: [b"rv-%02d-%04d" % (i, j) for j in range(16)] for i in range(8)}
        with c.insert_stream("cnt") as s:
            for i in range(4):
                s.send(frames[i])
            s.drain(timeout=60)
            faults.arm("stream.recv", "once")
            for i in range(4, 8):
                s.send(frames[i])
            resps = s.drain(timeout=120)
        assert len(resps) == 8 and all(r.get("ok") for r in resps)
        assert counters.get("fault_stream_recv") >= 1
        _exactly_once(c, "cnt", frames)
    finally:
        c.close()


def test_stream_ack_loss_after_apply_dedups_replay(coalesced_server):
    """``tests/test_streams.py::test_stream_ack_loss_after_apply_dedups_replay``."""
    svc = coalesced_server.service
    c = coalesced_server.client()
    try:
        c.wait_ready()
        c.create_filter("cnt", capacity=50_000, error_rate=0.01, counting=True)
        frames = {0: [b"ak-%04d" % j for j in range(32)]}
        faults.arm("stream.ack", "once")
        with c.insert_stream("cnt") as s:
            seq = s.send(frames[0])
            s.drain(timeout=120)
            r = s.result(seq)
            assert r["ok"] and r["n"] == 32
        assert counters.get("fault_stream_ack") >= 1
        hits = svc.metrics.snapshot()["counters"].get("stream_frame_dedup_hits", 0)
        assert hits >= 1, "the applied-then-lost frame's replay must be a dedup hit"
        _exactly_once(c, "cnt", frames)
    finally:
        c.close()


# -- repl.* -------------------------------------------------------------------------


def test_ack_stream_kill_reopens_on_heartbeat(tmp_path):
    """``tests/test_sync_repl.py::test_ack_stream_kill_reopens_on_heartbeat``:
    the primary kills the ack stream at a frame; the replica reopens it
    at its next heartbeat and quorum writes succeed again."""
    p = Node("torch", tmp_path, "p")
    r = Node("torch", tmp_path, "r", upstream=p)
    c = p.client()
    try:
        c.wait_ready()
        c.create_filter("cnt", capacity=10_000, error_rate=0.01, counting=True)
        c.insert_batch("cnt", [b"warmup"], min_replicas=1, min_replicas_timeout_ms=30_000)
        before = counters.get("repl_ack_stream_reopened")
        faults.arm("repl.ack_recv", "once")
        try:
            c.insert_batch("cnt", [b"boom"], min_replicas=1, min_replicas_timeout_ms=700)
        except protocol.BloomServiceError:
            pass  # the barrier may or may not see the re-sent ack
        _wait(lambda: counters.get("repl_ack_stream_reopened") > before, timeout=15,
              msg="the ack stream's reopen")
        assert counters.get("fault_repl_ack_recv") == 1
        c.insert_batch("cnt", [b"after"], min_replicas=1, min_replicas_timeout_ms=30_000)
        assert c.wait(1, timeout_ms=5000) == 1
    finally:
        c.close()
        r.close()
        p.close()


def test_chained_reappend_fault_heals_exactly_once(tmp_path):
    """``tests/test_ha.py::test_chained_reappend_fault_heals_exactly_once``:
    the chained replica's write-ahead re-append dies, its applier
    reconnects, and the re-delivered record lands in its log and its
    filter once."""
    p = Node("torch", tmp_path, "p")
    pc = p.client()
    keys = [b"r%015d" % i for i in range(150)]
    pc.create_filter("cnt", capacity=20_000, error_rate=0.01, counting=True)
    pc.insert_batch("cnt", keys)
    mid = Node("torch", tmp_path, "mid", upstream=p, chained=True)
    mc = mid.client()
    try:
        mid.sync(p)
        assert mid.service.oplog.last_seq == p.log.last_seq
        before = counters.get("fault_repl_reappend")
        faults.arm("repl.reappend", "once")
        live = [b"live-%07d" % i for i in range(40)]
        pc.insert_batch("cnt", live)
        mid.sync(p)
        assert counters.get("fault_repl_reappend") == before + 1
        assert mid.service.oplog.last_seq == p.log.last_seq  # no gap, no repeat
        assert mc.include_batch("cnt", live).all()
        pc.delete_batch("cnt", keys + live)
        mid.sync(p)
        assert not mc.include_batch("cnt", keys + live).any(), (
            "the re-delivered record applied twice through the chained log"
        )
    finally:
        mc.close()
        pc.close()
        mid.close()
        p.close()
