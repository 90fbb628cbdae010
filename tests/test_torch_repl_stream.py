"""Replication of the port's server (``tpubloom_torch.repl.primary`` /
``repl.replica`` behind ``ReplStream`` and ``ReplAck``) against
``tpubloom.repl`` on the CPU.

Across packages: a ``tpubloom_torch`` replica of a ``tpubloom`` primary,
and a ``tpubloom`` replica of a ``tpubloom_torch`` primary, each through a
full resync and then the log's tail, end with every filter's config and
state bytes equal to the primary's (tolerance 0). On the port alone, the
reference suites' contracts (``tests/test_repl.py``,
``tests/test_sync_repl.py``): a stream killed mid-batch resumes with a
partial resync and applies nothing twice; an injected apply fault applies
its record exactly once; a restored create forces a full resync; a
replica answers READONLY and the client follows it to the primary; the
sync quorum acks, fails fast, blocks on lost acks and heals, and times
out on a dark replica that later catches up. Last, the
``GOLDEN_STREAM`` ReplStream frame of ``tests/test_protocol_golden.py``
replayed raw against a port primary with an op log."""

import time

import msgpack
import numpy as np
import pytest

import grpc

from tests.test_protocol_golden import GOLDEN, GOLDEN_STREAM
from tests.test_torch_repl import assert_same_filters, fixed, keys, payload
from tpubloom import checkpoint as jck
from tpubloom.repl import OpLog as JOpLog
from tpubloom.repl import ReplicaApplier as JReplicaApplier
from tpubloom.server import service as jservice
from tpubloom_torch import checkpoint as ck
from tpubloom_torch import faults
from tpubloom_torch.obs import blackbox, counters, flight, trace
from tpubloom_torch.repl import OpLog, ReplicaApplier
from tpubloom_torch.server import protocol, service
from tpubloom_torch.server.client import BloomClient

L = 16


@pytest.fixture(autouse=True)
def port_globals():
    faults.reset()
    blackbox.reset_for_tests()
    yield
    faults.reset()
    trace.reset_for_tests()
    flight.reset_for_tests()
    blackbox.reset_for_tests()
    counters.reset_for_tests()


class Node:
    """One in-process server of either package: a primary with an op log
    and a checkpoint sink, or a read-only replica with its applier."""

    def __init__(self, pkg, tmp_path, name, *, upstream=None, **kw):
        self.pkg = pkg
        svc_mod = service if pkg == "torch" else jservice
        self.log = None
        sink_dir = str(tmp_path / f"{name}-ckpt")
        args = dict(sink_factory=lambda c: (ck if pkg == "torch" else jck).FileSink(sink_dir))
        if pkg == "torch":
            args["device"] = "cpu"
        if upstream is None:
            self.log = (OpLog if pkg == "torch" else JOpLog)(str(tmp_path / f"{name}-log"))
            args["oplog"] = self.log
        else:
            args["read_only"] = True
        self.service = svc_mod.BloomService(**args, **kw)
        self.server, self.port = svc_mod.build_server(self.service, "127.0.0.1:0")
        self.server.start()
        self.addr = f"127.0.0.1:{self.port}"
        self.service.listen_address = self.addr
        self.applier = None
        if upstream is not None:
            cls = ReplicaApplier if pkg == "torch" else JReplicaApplier
            self.applier = cls(self.service, upstream.addr, reconnect_base=0.05,
                               listen_address=self.addr).start()

    def client(self, **kw) -> BloomClient:
        return BloomClient(self.addr, **kw)

    def close(self):
        if self.applier is not None:
            self.applier.stop()
        self.server.stop(grace=None)
        self.service.shutdown()
        if self.log is not None:
            self.log.close()


def _wait(pred, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def _steps(rng, tag):
    """Creates (first call only), inserts of both encodings, counting
    deletes, sketch verbs."""
    steps = []
    if tag == "create":
        steps += [
            ("CreateFilter", {"name": "blocked", "config": {
                "m": 1 << 16, "k": 7, "key_len": L, "block_bits": 512, "block_hash": "chunk"}}),
            ("CreateFilter", {"name": "cnt", "capacity": 3000, "error_rate": 0.01,
                              "options": {"counting": True, "key_len": L}}),
            ("CreateFilter", {"name": "bcnt", "config": {
                "m": 1 << 15, "k": 4, "key_len": L, "counting": True, "block_bits": 512}}),
            ("CMSInitByDim", {"name": "cms", "width": 2016, "depth": 5, "options": {"key_len": L}}),
            ("CFReserve", {"name": "cf", "capacity": 1000, "options": {"key_len": L}}),
        ]
    for name in ("blocked", "cnt", "bcnt"):
        a, b = keys(rng, 150), keys(rng, 150)
        steps += [("InsertBatch", {"name": name, "keys": a}),
                  ("InsertBatch", {"name": name, "keys_fixed": fixed(b)})]
        if name != "blocked":
            steps.append(("DeleteBatch", {"name": name, "keys": a[:40]}))
    cf = keys(rng, 60)
    steps += [("CMSIncrBy", {"name": "cms", "keys": keys(rng, 80)}),
              ("CFAdd", {"name": "cf", "keys": cf}),
              ("CFDel", {"name": "cf", "keys": cf[:10]})]
    return steps


def _drive(node, steps):
    for method, req in steps:
        getattr(node.service, method)(req)


@pytest.mark.parametrize("primary_pkg,replica_pkg", [("jax", "torch"), ("torch", "jax")])
def test_replication_across_packages(primary_pkg, replica_pkg, tmp_path):
    rng = np.random.default_rng(515)
    p = Node(primary_pkg, tmp_path, "p")
    r = None
    try:
        _drive(p, _steps(rng, "create"))
        r = Node(replica_pkg, tmp_path, "r", upstream=p)
        assert r.applier.wait_for_seq(p.log.last_seq, 60), r.applier.status()
        assert r.applier.full_syncs == 1
        assert_same_filters(p.service, r.service)
        _drive(p, _steps(rng, "tail"))
        p.service.DropFilter({"name": "cf", "final_checkpoint": False})
        assert r.applier.wait_for_seq(p.log.last_seq, 60), r.applier.status()
        assert r.applier.full_syncs == 1 and r.applier.records_applied > 0
        assert_same_filters(p.service, r.service)
        with r.client() as rc:
            assert rc.health()["role"] == "replica"
    finally:
        if r is not None:
            r.close()
        p.close()


def test_mid_stream_kill_resumes_partially_and_applies_once(tmp_path):
    rng = np.random.default_rng(3)
    p = Node("torch", tmp_path, "p")
    r = Node("torch", tmp_path, "r", upstream=p)
    pc, rc = p.client(), r.client()
    try:
        ks = keys(rng, 500)
        pc.create_filter("cnt", capacity=20_000, error_rate=0.01, counting=True)
        pc.insert_batch("cnt", ks)
        assert r.applier.wait_caught_up(30), r.applier.status()
        assert r.applier.full_syncs == 1
        assert rc.include_batch("cnt", ks).all()
        faults.arm("repl.stream_send", "once")
        pc.insert_batch("cnt", keys(rng, 100))
        _wait(lambda: r.applier.partial_syncs >= 1, msg="a partial resync")
        assert r.applier.wait_for_seq(p.log.last_seq, 30), r.applier.status()
        # counts are still 1: one delete round empties the replica too
        pc.delete_batch("cnt", ks)
        assert r.applier.wait_for_seq(p.log.last_seq, 30), r.applier.status()
        assert not rc.include_batch("cnt", ks).any()
        assert r.applier.full_syncs == 1
        assert_same_filters(p.service, r.service)
    finally:
        pc.close()
        rc.close()
        r.close()
        p.close()


def test_injected_apply_fault_applies_exactly_once(tmp_path):
    rng = np.random.default_rng(7)
    p = Node("torch", tmp_path, "p")
    r = Node("torch", tmp_path, "r", upstream=p)
    pc, rc = p.client(), r.client()
    try:
        ks = keys(rng, 300)
        pc.create_filter("cnt", capacity=20_000, error_rate=0.01, counting=True)
        pc.insert_batch("cnt", ks)
        assert r.applier.wait_caught_up(30), r.applier.status()
        before = counters.get("fault_repl_apply")
        faults.arm("repl.apply", "once")
        extra = keys(rng, 100)
        pc.insert_batch("cnt", extra)
        assert r.applier.wait_for_seq(p.log.last_seq, 30), r.applier.status()
        assert counters.get("fault_repl_apply") == before + 1
        assert rc.include_batch("cnt", extra).all()
        pc.delete_batch("cnt", ks + extra)
        assert r.applier.wait_for_seq(p.log.last_seq, 30), r.applier.status()
        assert not rc.include_batch("cnt", ks + extra).any()
        assert_same_filters(p.service, r.service)
    finally:
        pc.close()
        rc.close()
        r.close()
        p.close()


def test_full_resync_on_restored_create(tmp_path):
    """A CreateFilter that restored a checkpoint the replica lacks forces a
    full resync: the record alone cannot carry those bytes."""
    p = Node("torch", tmp_path, "p")
    r = Node("torch", tmp_path, "r", upstream=p)
    pc, rc = p.client(), r.client()
    try:
        ks = [b"r%015d" % i for i in range(128)]
        pc.create_filter("warm", capacity=10_000, error_rate=0.01)
        pc.insert_batch("warm", ks)
        assert r.applier.wait_caught_up(30)
        pc.drop_filter("warm")  # its final checkpoint lands in the sink
        pc.create_filter("warm", capacity=10_000, error_rate=0.01)
        _wait(lambda: r.applier.full_syncs >= 2, msg="a second full resync")
        assert r.applier.wait_for_seq(p.log.last_seq, 30), r.applier.status()
        assert rc.include_batch("warm", ks).all()
        assert_same_filters(p.service, r.service)
    finally:
        pc.close()
        rc.close()
        r.close()
        p.close()


def test_readonly_rejection_and_redirect(tmp_path):
    bare = service.BloomService(read_only=True, device="cpu")
    srv, port = service.build_server(bare, "127.0.0.1:0")
    srv.start()
    try:
        with BloomClient(f"127.0.0.1:{port}") as c:
            c.wait_ready()
            with pytest.raises(protocol.BloomServiceError, match="READONLY"):
                c.insert_batch("any", [b"x"])
            with pytest.raises(protocol.BloomServiceError, match="READONLY"):
                c.create_filter("any", capacity=100, error_rate=0.1)
    finally:
        srv.stop(grace=None)
        bare.shutdown()

    p = Node("torch", tmp_path, "p")
    r = Node("torch", tmp_path, "r", upstream=p)
    c = r.client()  # pointed at the replica: writes follow the redirect
    try:
        c.wait_ready()
        c.create_filter("redir", capacity=1000, error_rate=0.01)
        c.insert_batch("redir", [b"via-redirect"])
        assert c.address == p.addr
        assert counters.get("client_primary_redirects") >= 1
        assert r.applier.wait_for_seq(p.log.last_seq, 30), r.applier.status()
        with r.client() as direct:
            assert direct.include("redir", b"via-redirect")
    finally:
        c.close()
        r.close()
        p.close()


# -- the sync quorum (tests/test_sync_repl.py on the port) -------------------


def _warm(client, node, name="cnt"):
    client.insert_batch(name, [b"warmup"])


def test_quorum_write_acks_and_wait_counts(tmp_path):
    p = Node("torch", tmp_path, "p")
    r = Node("torch", tmp_path, "r", upstream=p)
    c = p.client()
    try:
        c.wait_ready()
        c.create_filter("cnt", capacity=10_000, error_rate=0.01, counting=True)
        _warm(c, p)
        assert r.applier.wait_for_seq(p.log.last_seq, 30), r.applier.status()
        resp = c._rpc("InsertBatch", {"name": "cnt", "keys": [b"q1"], "min_replicas": 1,
                                      "min_replicas_timeout_ms": 30_000})
        assert resp["acked_replicas"] == 1
        seq = resp["repl_seq"]
        assert c.last_write_seq == seq
        with r.client() as rcheck:
            assert rcheck.include("cnt", b"q1")  # acked means applied
        assert c.wait(1, timeout_ms=5000) == 1
        h = p.service.Health({})
        assert h["status"] == "SERVING", h
        assert h["replication"]["replicas"][0]["acked"] >= seq
        assert r.service.Health({})["replication"]["sync_repl"] is True
    finally:
        c.close()
        r.close()
        p.close()


def test_barrier_fast_fails_without_connected_replicas(tmp_path):
    p = Node("torch", tmp_path, "p", min_replicas_to_write=1)
    c = p.client()
    try:
        c.wait_ready(accept_degraded=True)
        t0 = time.monotonic()
        with pytest.raises(protocol.BloomServiceError, match="NOT_ENOUGH_REPLICAS") as ei:
            c.create_filter("f", capacity=1000, error_rate=0.01)
        assert time.monotonic() - t0 < 0.5
        assert ei.value.details["applied"] is True and ei.value.details["connected"] == 0
        assert "f" in c.list_filters()
        h = c.health()
        assert h["status"] == "DEGRADED"
        assert "min_replicas:0/1" in h["reasons"] and "not_enough_replicas" in h["reasons"]
        assert c.create_filter("f", exist_ok=True)["existed"]
        assert not c.drop_filter("missing-filter")["existed"]
    finally:
        c.close()
        p.close()


def test_ack_loss_blocks_write_then_reack_heals(tmp_path):
    p = Node("torch", tmp_path, "p")
    r = Node("torch", tmp_path, "r", upstream=p)
    c = p.client()
    try:
        c.wait_ready()
        c.create_filter("cnt", capacity=10_000, error_rate=0.01, counting=True)
        c.insert_batch("cnt", [b"pre"], min_replicas=1, min_replicas_timeout_ms=30_000)
        faults.arm("repl.ack", "always")
        with pytest.raises(protocol.BloomServiceError, match="NOT_ENOUGH_REPLICAS") as ei:
            c.insert_batch("cnt", [b"lost-ack"], min_replicas=1, min_replicas_timeout_ms=700)
        lost = ei.value.details["seq"]
        assert ei.value.details["applied"] is True
        assert r.applier.wait_for_seq(lost, 30)
        with r.client() as rcheck:
            assert rcheck.include("cnt", b"lost-ack")
        assert c.wait(1, timeout_ms=300, seq=lost) == 0
        assert counters.get("repl_acks_dropped") > 0
        faults.reset()
        _wait(lambda: p.service.repl_sessions.count_acked(lost) == 1, timeout=10,
              msg="the re-ack")
        assert c.wait(1, timeout_ms=5000, seq=lost) == 1
        c.insert_batch("cnt", [b"post-heal"], min_replicas=1, min_replicas_timeout_ms=30_000)
    finally:
        c.close()
        r.close()
        p.close()


def test_slow_replica_times_out_then_catches_up(tmp_path):
    p = Node("torch", tmp_path, "p")
    r = Node("torch", tmp_path, "r", upstream=p)
    c = p.client()
    applier2 = None
    try:
        c.wait_ready()
        c.create_filter("cnt", capacity=10_000, error_rate=0.01, counting=True)
        _warm(c, p)
        assert r.applier.wait_for_seq(p.log.last_seq, 30), r.applier.status()
        r.applier.stop()  # the replica goes dark
        _wait(lambda: p.service.repl_sessions.count() == 0, msg="the session's drop")
        with pytest.raises(protocol.BloomServiceError, match="NOT_ENOUGH_REPLICAS"):
            c.insert_batch("cnt", [b"stuck"], min_replicas=1, min_replicas_timeout_ms=400)
        rid = c.last_rid
        applier2 = ReplicaApplier(r.service, p.addr, reconnect_base=0.05,
                                  initial_cursor=r.applier.cursor,
                                  initial_log_id=r.applier.log_id).start()
        assert applier2.wait_for_seq(p.log.last_seq, 30), applier2.status()
        assert applier2.full_syncs == 0 and applier2.partial_syncs >= 1
        resp = c._call_once("InsertBatch", {"name": "cnt", "keys": [b"stuck"], "rid": rid,
                                            "min_replicas": 1,
                                            "min_replicas_timeout_ms": 30_000})
        assert resp["acked_replicas"] == 1
        c.delete_batch("cnt", [b"stuck"])
        assert not c.include("cnt", b"stuck")
        assert applier2.wait_for_seq(p.log.last_seq, 30)
        assert_same_filters(p.service, r.service)
    finally:
        if applier2 is not None:
            applier2.stop()
        c.close()
        r.close()
        p.close()


# -- the golden ReplStream frame, raw ------------------------------------------


def _frames(channel, hexbytes):
    call = channel.unary_stream(
        protocol.method_path("ReplStream"),
        request_serializer=lambda b: b, response_deserializer=lambda b: b,
    )(bytes.fromhex(hexbytes), timeout=10)
    frames = []
    for raw in call:
        frames.append(msgpack.unpackb(raw, raw=False))
        if frames[-1]["kind"] == "full_sync_end":
            break
    call.cancel()
    return frames


def _call(channel, method, hexbytes):
    fn = channel.unary_unary(protocol.method_path(method),
                             request_serializer=lambda b: b, response_deserializer=lambda b: b)
    return msgpack.unpackb(fn(bytes.fromhex(hexbytes), timeout=10), raw=False)


def test_golden_repl_stream_full_sync_port(tmp_path):
    """The cursor-less ReplStream golden frame against a port primary and a
    reference primary, each with an op log and fed the golden
    CreateFilter and InsertBatch: the same frame kinds and fields, and each
    snapshot blob restores in the other package to the same state bytes."""
    nodes = [Node("torch", tmp_path, "p"), Node("jax", tmp_path, "j")]
    channels = [grpc.insecure_channel(n.addr) for n in nodes]
    try:
        got = []
        for ch in channels:
            assert _call(ch, *GOLDEN["CreateFilter"])["ok"]
            assert _call(ch, *GOLDEN["InsertBatch"])["ok"]
            got.append(_frames(ch, GOLDEN_STREAM["ReplStream"][1]))
        port, ref = got
        assert [f["kind"] for f in port] == [f["kind"] for f in ref]
        assert port[0]["kind"] == "full_sync_begin" and port[0]["filters"] == ["golden"]
        assert port[-1]["kind"] == "full_sync_end"
        assert {"cursor", "log_id", "epoch", "sid"} <= set(port[-1])
        assert set(port[-1]) == set(ref[-1])
        assert (port[-1]["cursor"], port[-1]["epoch"]) == (ref[-1]["cursor"], ref[-1]["epoch"])
        ps = next(f for f in port if f["kind"] == "snapshot")
        rs = next(f for f in ref if f["kind"] == "snapshot")
        assert set(ps) == set(rs) and ps["applied_seq"] == rs["applied_seq"]
        a = jck.restore_blob(ps["blob"])
        b = ck.restore_blob(rs["blob"], device="cpu")
        assert payload(a) == payload(nodes[0].service._filters["golden"].filter)
        assert payload(b) == payload(nodes[1].service._filters["golden"].filter)
        assert payload(a) == payload(b)
    finally:
        for ch in channels:
            ch.close()
        for n in nodes:
            n.close()
