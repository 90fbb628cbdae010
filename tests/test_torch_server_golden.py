"""The port's gRPC server (``tpubloom_torch.server``) against the Ruby wire
contract: every golden frame of ``tests/test_protocol_golden.py`` (the
exact bytes the Ruby driver sends), replayed RAW over gRPC against a port
``BloomService(device="cpu")``, with the field checks the reference's
replay tests make against ``tpubloom.server``.

The op log is a later slice of the port, so ``ReplStream`` answers the
structured UNSUPPORTED frame that ``tpubloom.server`` answers without an op
log (checked against a reference server in the same test); ``Monitor``,
``ReplAck`` and ``Wait`` serve as in the reference."""

import msgpack
import numpy as np
import pytest

import grpc

from tests.test_protocol_golden import (
    GOLDEN,
    GOLDEN_ACK_FRAME,
    GOLDEN_ACK_FRAME_DICT,
    GOLDEN_BIDI,
    GOLDEN_BIDI_DICTS,
    GOLDEN_DICTS,
    GOLDEN_STREAM,
)
from tpubloom_torch import checkpoint as ckpt
from tpubloom_torch import faults
from tpubloom_torch.obs import blackbox, counters, flight, trace
from tpubloom_torch.server import protocol
from tpubloom_torch.server.service import BloomService, build_server


@pytest.fixture(autouse=True)
def port_globals():
    """The port's process-global registries are its own objects; reset
    them after each test so no state leaks into the next."""
    yield
    faults.reset()
    trace.reset_for_tests()
    flight.reset_for_tests()
    blackbox.reset_for_tests()
    counters.reset_for_tests()


@pytest.fixture()
def raw_service_server(tmp_path):
    service = BloomService(
        sink_factory=lambda config: ckpt.FileSink(str(tmp_path)), device="cpu"
    )
    srv, port = build_server(service, "127.0.0.1:0")
    srv.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    yield channel, service
    channel.close()
    srv.stop(grace=None)


@pytest.fixture()
def raw_server(raw_service_server):
    channel, _ = raw_service_server
    return channel


def _call(channel, method, hexbytes):
    fn = channel.unary_unary(
        protocol.method_path(method),
        request_serializer=lambda b: b,
        response_deserializer=lambda b: b,
    )
    return msgpack.unpackb(fn(bytes.fromhex(hexbytes)), raw=False)


def _bits(raw, n):
    return np.unpackbits(np.frombuffer(raw, np.uint8), bitorder="big")[:n]


def test_wire_tables_are_the_reference_tables():
    """The port's protocol module is the reference's wire: same service
    name, method tables, error codes and encodings, and every golden dict
    encodes to its committed bytes through the port's encoder."""
    from tpubloom.server import protocol as ref

    for name in ("SERVICE", "METHODS", "STREAM_METHODS", "CLIENT_STREAM_METHODS",
                 "BIDI_STREAM_METHODS", "MUTATING_METHODS", "ENCODINGS"):
        assert getattr(protocol, name) == getattr(ref, name), name
    for name, (method, hexbytes) in GOLDEN.items():
        assert protocol.encode(GOLDEN_DICTS[name]).hex() == hexbytes, name
        assert protocol.method_path(method) == ref.method_path(method)
    covered = {m for m, _ in GOLDEN.values()}
    assert covered == set(protocol.METHODS)


def test_golden_replay_against_port_server(raw_server):
    ch = raw_server

    r = _call(ch, *GOLDEN["Health"])
    assert r["ok"] and "backend" in r and "devices" in r
    assert r["backend"] == "cpu" and r["devices"] == ["cpu"]

    assert _call(ch, *GOLDEN["CreateFilter"])["ok"]
    assert _call(ch, *GOLDEN["CreateFilter_counting"])["ok"]

    r = _call(ch, *GOLDEN["ListFilters"])
    assert r["ok"] and sorted(r["filters"]) == ["golden", "golden-cnt"]

    r = _call(ch, *GOLDEN["InsertBatch"])
    assert r["ok"] and r["n"] == 2

    # presence bytes: MSB-first packbits, n announces the valid prefix
    r = _call(ch, *GOLDEN["InsertBatch_presence"])
    assert r["ok"] and r["n"] == 2 and isinstance(r["presence"], bytes)
    assert _bits(r["presence"], r["n"]).all()

    r = _call(ch, *GOLDEN["QueryBatch"])
    assert r["ok"] and r["n"] == 3 and isinstance(r["hits"], bytes)
    bits = _bits(r["hits"], 3)
    assert bits[0] and bits[1] and not bits[2]

    # fixed wire encoding: the raw-buffer insert round-trips through the
    # raw-buffer query and through its msgpack twin
    r = _call(ch, *GOLDEN["InsertBatch_fixed"])
    assert r["ok"] and r["n"] == 2
    r = _call(ch, *GOLDEN["QueryBatch_fixed"])
    assert r["ok"] and r["n"] == 3
    bits = _bits(r["hits"], 3)
    assert bits[0] and bits[1] and not bits[2]
    twin = msgpack.packb(
        {"name": "golden",
         "keys": [(1).to_bytes(8, "little"), (2).to_bytes(8, "little")]},
        use_bin_type=True,
    )
    fn = ch.unary_unary(
        protocol.method_path("QueryBatch"),
        request_serializer=lambda b: b,
        response_deserializer=lambda b: b,
    )
    r = msgpack.unpackb(fn(twin), raw=False)
    assert _bits(r["hits"], 2).all()

    assert _call(ch, *GOLDEN["InsertBatch_cnt"])["ok"]
    assert _call(ch, *GOLDEN["DeleteBatch"])["ok"]

    r = _call(ch, *GOLDEN["Stats"])
    assert r["ok"] and "n_inserted" in r["stats"]

    r = _call(ch, *GOLDEN["Checkpoint"])
    assert r["ok"] and isinstance(r["seq"], int)

    assert _call(ch, *GOLDEN["Clear"])["ok"]
    r = _call(ch, *GOLDEN["QueryBatch"])
    assert not _bits(r["hits"], 3).any()

    assert _call(ch, *GOLDEN["DropFilter"])["ok"]
    r = _call(ch, *GOLDEN["ListFilters"])
    assert r["filters"] == ["golden"]

    # HA verbs: on a primary both are idempotent acknowledgements
    r = _call(ch, *GOLDEN["Promote"])
    assert r["ok"] and r["already_primary"] and isinstance(r["epoch"], int)
    r = _call(ch, *GOLDEN["ReplicaOf"])
    assert r["ok"] and r["already_primary"]

    r = _call(ch, *GOLDEN["Wait"])
    assert r["ok"] and r["nreplicas"] == 0 and isinstance(r["seq"], int)

    r = _call(ch, *GOLDEN["ClusterSlots"])
    assert r["ok"] and r["enabled"] is False and r["ranges"] == []
    for fixture in ("ClusterSetSlot", "MigrateSlot", "MigrateInstall"):
        r = _call(ch, *GOLDEN[fixture])
        assert r["ok"] is False, fixture
        assert r["error"]["code"] == "CLUSTER_DISABLED", fixture

    r = _call(ch, *GOLDEN["SlowlogGet"])
    assert r["ok"] and len(r["entries"]) > 0
    e = r["entries"][0]
    assert {"id", "time", "method", "rid", "duration_s", "batch", "args",
            "phases"} <= set(e)
    assert e["method"] in protocol.METHODS and e["rid"]
    r = _call(ch, *GOLDEN["SlowlogReset"])
    assert r["ok"] and r["cleared"] > 0

    r = _call(ch, *GOLDEN["TraceGet"])
    assert r["ok"] and r["rid"] == "golden-rid"
    assert r["enabled"] is False and r["spans"] == []

    bad = msgpack.packb({"name": "missing-filter", "keys": [b"x"]},
                        use_bin_type=True)
    r = msgpack.unpackb(fn(bad), raw=False)
    assert r["ok"] is False and r["error"]["code"] == "NOT_FOUND"
    assert isinstance(r["error"]["message"], str)


def test_golden_sketch_replay_port(raw_service_server):
    ch, service = raw_service_server

    assert _call(ch, *GOLDEN["CFReserve"])["ok"]
    r = _call(ch, *GOLDEN["CFAdd"])
    assert r["ok"] and r["n"] == 2
    assert "full" not in r
    r = _call(ch, *GOLDEN["CFExists"])
    assert r["ok"] and r["n"] == 3 and isinstance(r["hits"], bytes)
    bits = _bits(r["hits"], 3)
    assert bits[0] and bits[1] and not bits[2]
    r = _call(ch, *GOLDEN["CFDel"])
    assert r["ok"] and r["n"] == 1 and isinstance(r["deleted"], bytes)
    assert _bits(r["deleted"], 1)[0]
    r = _call(ch, *GOLDEN["CFExists"])
    bits = _bits(r["hits"], 3)
    assert bits[0] and not bits[1]

    assert _call(ch, *GOLDEN["CMSInitByDim"])["ok"]
    r = _call(ch, *GOLDEN["CMSIncrBy"])
    assert r["ok"] and r["n"] == 2
    assert r["counts"][0] >= 5 and r["counts"][1] >= 2
    r = _call(ch, *GOLDEN["CMSQuery"])
    assert r["ok"] and r["n"] == 3 and len(r["counts"]) == 3
    assert r["counts"][0] >= 5 and r["counts"][1] >= 2

    assert _call(ch, *GOLDEN["TopKReserve"])["ok"]
    r = _call(ch, *GOLDEN["TopKAdd"])
    assert r["ok"] and r["n"] == 3
    r = _call(ch, *GOLDEN["TopKList"])
    assert r["ok"] and len(r["items"]) >= 1
    top = r["items"][0]
    assert top["key"] == b"hot" and top["count"] >= 2

    wrong = msgpack.packb({"name": "golden-cms", "keys": [b"x"]}, use_bin_type=True)
    fn = ch.unary_unary(
        protocol.method_path("CFAdd"),
        request_serializer=lambda b: b,
        response_deserializer=lambda b: b,
    )
    r = msgpack.unpackb(fn(wrong), raw=False)
    assert r["ok"] is False and r["error"]["code"] == "WRONG_TYPE"

    service.read_only = True
    try:
        for fixture in ("CFAdd", "CFDel", "CMSIncrBy", "TopKAdd"):
            r = _call(ch, *GOLDEN[fixture])
            assert r["ok"] is False, fixture
            assert r["error"]["code"] == "READONLY", fixture
        assert _call(ch, *GOLDEN["CFExists"])["ok"]
        assert _call(ch, *GOLDEN["CMSQuery"])["ok"]
        assert _call(ch, *GOLDEN["TopKList"])["ok"]
        # promoting a replica is a later slice: a structured refusal
        r = _call(ch, *GOLDEN["Promote"])
        assert r["ok"] is False and r["error"]["code"] == "UNSUPPORTED"
    finally:
        service.read_only = False


def test_golden_sketch_cluster_disabled_port(raw_server):
    assert _call(raw_server, *GOLDEN["CFReserve"])["ok"]
    r = _call(raw_server, *GOLDEN["CFAdd"])
    assert r["ok"] and r["n"] == 2


def _stream_frames(channel, hexbytes, stop):
    call = channel.unary_stream(
        protocol.method_path("ReplStream"),
        request_serializer=lambda b: b,
        response_deserializer=lambda b: b,
    )(bytes.fromhex(hexbytes), timeout=10)
    frames = []
    for raw in call:
        frames.append(msgpack.unpackb(raw, raw=False))
        if stop(frames[-1]):
            break
    call.cancel()
    return frames


def test_golden_stream_replay_port(raw_server, tmp_path):
    """ReplStream answers the frame ``tpubloom.server`` answers with no op
    log; Monitor's hello and op events carry the fields monitor clients
    read."""
    from tpubloom.server.service import BloomService as RefService
    from tpubloom.server.service import build_server as ref_build

    ch = raw_server
    assert _call(ch, *GOLDEN["CreateFilter"])["ok"]
    assert _call(ch, *GOLDEN["InsertBatch"])["ok"]

    ref = RefService(sink_factory=lambda config: None)
    rsrv, rport = ref_build(ref, "127.0.0.1:0")
    rsrv.start()
    rch = grpc.insecure_channel(f"127.0.0.1:{rport}")
    try:
        method, hexbytes = GOLDEN_STREAM["ReplStream"]
        got = _stream_frames(ch, hexbytes, lambda f: True)
        want = _stream_frames(rch, hexbytes, lambda f: True)
    finally:
        rch.close()
        rsrv.stop(grace=None)
    assert got == want
    assert got[0]["kind"] == "error" and got[0]["code"] == "UNSUPPORTED"

    method, hexbytes = GOLDEN_STREAM["Monitor"]
    call = ch.unary_stream(
        protocol.method_path(method),
        request_serializer=lambda b: b,
        response_deserializer=lambda b: b,
    )(bytes.fromhex(hexbytes), timeout=10)
    it = iter(call)
    hello = msgpack.unpackb(next(it), raw=False)
    assert hello["kind"] == "hello" and hello["filter"] == "golden"
    assert _call(ch, *GOLDEN["QueryBatch"])["ok"]
    event = None
    for raw in it:
        frame = msgpack.unpackb(raw, raw=False)
        if frame["kind"] == "op":
            event = frame
            break
    call.cancel()
    assert event is not None
    assert event["method"] == "QueryBatch" and event["name"] == "golden"
    assert {"ts", "rid", "batch", "duration_s", "ok"} <= set(event)


def test_golden_bidi_replay_port(raw_server):
    ch = raw_server
    assert _call(ch, *GOLDEN["CreateFilter"])["ok"]

    def bidi(method, hexbytes):
        call = ch.stream_stream(
            protocol.method_path(method),
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b,
        )(iter([bytes.fromhex(hexbytes)]), timeout=30)
        return [msgpack.unpackb(raw, raw=False) for raw in call]

    frames = bidi(*GOLDEN_BIDI["InsertStream"])
    assert frames[0]["kind"] == "hello"
    assert isinstance(frames[0]["credit"], int) and frames[0]["credit"] >= 1
    acks = [f for f in frames[1:] if f["kind"] == "ack"]
    assert len(acks) == 1
    assert acks[0]["seq"] == GOLDEN_BIDI_DICTS["InsertStream"]["seq"]
    assert isinstance(acks[0]["credit"], int) and acks[0]["credit"] >= 1
    resp = acks[0]["resp"]
    assert resp["ok"] and resp["n"] == 2

    frames = bidi(*GOLDEN_BIDI["QueryStream"])
    assert frames[0]["kind"] == "hello"
    (ack,) = [f for f in frames[1:] if f["kind"] == "ack"]
    assert ack["seq"] == 1
    resp = ack["resp"]
    assert resp["ok"] and resp["n"] == 2 and isinstance(resp["hits"], bytes)
    bits = _bits(resp["hits"], 2)
    assert bits[0] and not bits[1]


def test_golden_ack_frame_replay_port(raw_service_server):
    channel, service = raw_service_server
    sid = service.repl_sessions.register("golden-peer", listen="127.0.0.1:9")
    assert sid == 0
    fn = channel.stream_unary(
        protocol.method_path("ReplAck"),
        request_serializer=lambda b: b,
        response_deserializer=lambda b: b,
    )
    resp = msgpack.unpackb(fn(iter([bytes.fromhex(GOLDEN_ACK_FRAME)])), raw=False)
    assert resp["ok"] and resp["frames"] == 1
    (sess,) = service.repl_sessions.describe()
    assert sess["acked"] == GOLDEN_ACK_FRAME_DICT["seq"]
    wait_req = msgpack.packb(
        {"numreplicas": 1, "timeout_ms": 500, "seq": GOLDEN_ACK_FRAME_DICT["seq"]},
        use_bin_type=True,
    )
    wfn = channel.unary_unary(
        protocol.method_path("Wait"),
        request_serializer=lambda b: b,
        response_deserializer=lambda b: b,
    )
    r = msgpack.unpackb(wfn(wait_req), raw=False)
    assert r["ok"] and r["nreplicas"] == 1
