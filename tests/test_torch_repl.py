"""The port's op log (``tpubloom_torch.repl.record`` / ``repl.log`` and the
service's log wiring) against ``tpubloom.repl`` on the CPU.

Exact (tolerance 0): the framed bytes of every record a service logs,
each package's torn-tail answer, segment files read by the other
package's ``OpLog``, and the words of every filter after a log written by
one package's service is replayed by the other's. The rest holds the
port's service to the reference suite's contracts (``tests/test_repl.py``):
replay gated by a checkpoint's ``repl_seq``, truncation keyed by
checkpoints, and the fail-stop on an append error. Filters are small
(m <= 2^16, batches <= 400 keys of 16 bytes, made with numpy from a seed)."""

import os
import threading
import time

import numpy as np
import pytest

from tpubloom import checkpoint as jck
from tpubloom.repl import OpLog as JOpLog
from tpubloom.repl import record as jrecord
from tpubloom.server import service as jservice
from tpubloom_torch import checkpoint as ck
from tpubloom_torch import faults
from tpubloom_torch.obs import blackbox, counters, flight, trace
from tpubloom_torch.repl import OpLog, decode_record, encode_record, scan_buffer
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


def keys(rng, n):
    return [bytes(r) for r in rng.integers(0, 256, (n, L), dtype=np.uint8)]


def fixed(ks):
    return {"data": b"".join(ks), "width": L, "n": len(ks)}


def payload(filt) -> bytes:
    """A filter's state bytes, by its own package's checkpoint codec: the
    payload of its snapshot blob (words, counters or the Redis bitmap)."""
    if type(filt).__module__.startswith("tpubloom_torch"):
        _, _, blob = ck.snapshot_blob(filt)
    else:
        _, _, blob = jck.snapshot_blob(filt)
    header, body = ck._parse(bytes(blob))
    return header["config"], bytes(body)


def assert_same_filters(a, b, names=None):
    """Every filter of services ``a`` and ``b`` (either package) has the
    same config and the same state bytes."""
    names = sorted(a._filters) if names is None else names
    assert sorted(a._filters) == sorted(b._filters)
    for name in names:
        ca, pa = payload(a._filters[name].filter)
        cb, pb = payload(b._filters[name].filter)
        assert ca == cb, name
        assert pa == pb, name


# -- record framing ----------------------------------------------------------

#: CreateFilter, InsertBatch (keys and keys_fixed), a counting remove and
#: DropFilter: each request goes to a service of each package, and the
#: record each logs is framed by each package's ``encode_record``
RECORD_CASES = ["CreateFilter", "InsertBatch-keys", "InsertBatch-keys_fixed",
                "DeleteBatch-counting", "DropFilter"]


def _logged(svc_cls, log_cls, directory, steps):
    log = log_cls(str(directory))
    kw = {"device": "cpu"} if svc_cls is service.BloomService else {}
    svc = svc_cls(sink_factory=lambda c: None, oplog=log, **kw)
    try:
        for method, req in steps:
            getattr(svc, method)(dict(req))
        return list(log.read_from(0))
    finally:
        svc.shutdown()
        log.close()


@pytest.mark.parametrize("case", RECORD_CASES)
def test_logged_record_bytes_equal_reference(case, tmp_path):
    rng = np.random.default_rng(15)
    ks = keys(rng, 40)
    setup = [("CreateFilter", {"name": "f", "capacity": 2000, "error_rate": 0.01,
                               "options": {"counting": True, "key_len": L}})]
    step = {
        "CreateFilter": setup[0],
        "InsertBatch-keys": ("InsertBatch", {"name": "f", "keys": ks}),
        "InsertBatch-keys_fixed": ("InsertBatch", {"name": "f", "keys_fixed": fixed(ks)}),
        "DeleteBatch-counting": ("DeleteBatch", {"name": "f", "keys": ks[:10]}),
        "DropFilter": ("DropFilter", {"name": "f", "final_checkpoint": False}),
    }[case]
    steps = setup + ([("InsertBatch", {"name": "f", "keys": ks})]
                     if case == "DeleteBatch-counting" else [])
    if case != "CreateFilter":
        steps.append(step)
    want = _logged(jservice.BloomService, JOpLog, tmp_path / "jax", steps)
    got = _logged(service.BloomService, OpLog, tmp_path / "port", steps)
    assert len(got) == len(want) == len(steps)
    for g, w in zip(got, want):
        assert {**g, "ts": 0.0} == {**w, "ts": 0.0}
        frame = encode_record(g)
        assert frame == jrecord.encode_record(g)
        assert decode_record(frame) == (g, len(frame))


def test_scan_buffer_torn_tail_equals_reference():
    frames = b"".join(
        encode_record({"seq": i, "method": "InsertBatch", "rid": f"r{i}",
                       "req": {"name": "f", "keys": [b"k%d" % i] * i}, "ts": float(i)})
        for i in range(1, 6)
    )
    rotted = bytearray(frames)
    rotted[-3] ^= 0xFF
    cuts = [frames, frames[:-1], frames[:-7], frames[: len(frames) // 2],
            frames[:5], b"", bytes(rotted), b"junk" + frames]
    for buf in cuts:
        got = scan_buffer(buf)
        assert got == jrecord.scan_buffer(buf)
    records, valid, clean = scan_buffer(frames[:-7])
    assert [r["seq"] for r in records] == [1, 2, 3, 4] and not clean


# -- OpLog -------------------------------------------------------------------


def test_oplog_append_read_and_recovery(tmp_path):
    d = str(tmp_path / "log")
    lg = OpLog(d)
    for i in range(10):
        lg.append("InsertBatch", {"name": "f", "keys": [b"k%d" % i]}, rid="r%d" % i)
    assert lg.last_seq == 10 and lg.first_seq == 1
    recs = list(lg.read_from(4))
    assert [r["seq"] for r in recs] == [5, 6, 7, 8, 9, 10]
    assert recs[0]["req"]["keys"] == [b"k4"] and recs[0]["rid"] == "r4"
    lg.close()
    # the reference reads the port's segments, and continues them
    ref = JOpLog(d)
    assert ref.last_seq == 10
    assert [r["seq"] for r in ref.read_from(4)] == [r["seq"] for r in recs]
    assert ref.append("Clear", {"name": "f"}) == 11
    ref.close()
    lg2 = OpLog(d)
    assert lg2.last_seq == 11
    assert lg2.append("Clear", {"name": "f"}) == 12
    lg2.close()


def test_oplog_torn_tail_truncated_on_recovery(tmp_path):
    d = str(tmp_path / "log")
    lg = OpLog(d)
    for _ in range(5):
        lg.append("Clear", {"name": "f"})
    seg = os.path.join(d, next(f for f in sorted(os.listdir(d)) if f.endswith(".seg")))
    lg.close()
    with open(seg, "r+b") as f:
        f.truncate(os.path.getsize(seg) - 7)  # a crash mid-append
    before = counters.get("repl_log_torn_tail_truncated")
    lg2 = OpLog(d)
    assert lg2.last_seq == 4
    assert counters.get("repl_log_torn_tail_truncated") == before + 1
    assert lg2.append("Clear", {"name": "f"}) == 5
    lg2.close()


def test_oplog_segments_roll_and_truncate(tmp_path):
    d = str(tmp_path / "log")
    lg = OpLog(d, segment_bytes=256)
    for i in range(40):
        lg.append("InsertBatch", {"name": "f", "keys": [b"key-%04d" % i]})
    st = lg.stats()
    assert st["segments"] > 2 and st["last_seq"] == 40
    assert lg.truncate_to(20) >= 1 and lg.first_seq > 1
    remaining = [r["seq"] for r in lg.read_from(0)]
    assert remaining == sorted(remaining) and set(range(21, 41)) <= set(remaining)
    assert [r["seq"] for r in lg.read_from(25)] == list(range(26, 41))
    # the reference agrees on the truncated log, segment for segment
    first, last, log_id = lg.first_seq, lg.last_seq, lg.log_id
    lg.close()
    ref = JOpLog(d, segment_bytes=256)
    assert (ref.first_seq, ref.last_seq, ref.log_id) == (first, last, log_id)
    assert [r["seq"] for r in ref.read_from(0)] == remaining
    assert ref.resumable(25, log_id) and not ref.resumable(first - 2, log_id)
    ref.close()
    lg2 = OpLog(d, segment_bytes=256)
    assert lg2.resumable(25, log_id) and not lg2.resumable(first - 2, log_id)
    assert not lg2.resumable(25, "another-log")
    lg2.close()


def test_oplog_wait_for(tmp_path):
    lg = OpLog(str(tmp_path / "log"))
    assert not lg.wait_for(1, timeout=0.05)
    t = threading.Thread(target=lambda: (time.sleep(0.05), lg.append("Clear", {"name": "f"})))
    t.start()
    assert lg.wait_for(1, timeout=5.0)
    t.join()
    lg.close()


# -- logs replayed across packages -------------------------------------------

FILTERS = {
    "blocked": {"config": {"m": 1 << 16, "k": 7, "key_len": L, "block_bits": 512,
                           "block_hash": "chunk"}},
    "counting": {"capacity": 3000, "error_rate": 0.01,
                 "options": {"counting": True, "key_len": L}},
    "blocked-counting": {"config": {"m": 1 << 15, "k": 4, "key_len": L, "counting": True,
                                    "block_bits": 512}},
    "flat": {"config": {"m": 1 << 15, "k": 5, "key_len": L}},
}


def _log_script(rng):
    steps = [("CreateFilter", {"name": n, **req}) for n, req in FILTERS.items()]
    for name in FILTERS:
        a, b = keys(rng, 200), keys(rng, 200)
        steps += [("InsertBatch", {"name": name, "keys": a}),
                  ("InsertBatch", {"name": name, "keys_fixed": fixed(b)})]
        if "counting" in name:
            steps += [("DeleteBatch", {"name": name, "keys": a[:50]}),
                      ("DeleteBatch", {"name": name, "keys_fixed": fixed(b[:30])})]
    steps += [("CMSInitByDim", {"name": "cms", "width": 2016, "depth": 5,
                                "options": {"key_len": L}}),
              ("CMSIncrBy", {"name": "cms", "keys": keys(rng, 100)}),
              ("CFReserve", {"name": "cf", "capacity": 1000, "options": {"key_len": L}})]
    cf = keys(rng, 80)
    steps += [("CFAdd", {"name": "cf", "keys": cf}),
              ("CFDel", {"name": "cf", "keys": cf[:20]}),
              ("CreateFilter", {"name": "gone", "config": {"m": 1 << 12, "k": 3}}),
              ("InsertBatch", {"name": "gone", "keys": keys(rng, 10)}),
              ("DropFilter", {"name": "gone", "final_checkpoint": False}),
              ("Clear", {"name": "flat"}),
              ("InsertBatch", {"name": "flat", "keys": keys(rng, 64)})]
    return steps


def _jax_service(log):
    return jservice.BloomService(sink_factory=lambda c: None, oplog=log)


def _port_service(log):
    return service.BloomService(sink_factory=lambda c: None, oplog=log, device="cpu")


@pytest.mark.parametrize("writer", ["tpubloom", "tpubloom_torch"])
def test_log_replays_across_packages(writer, tmp_path):
    """A log written by one package's service, replayed by a fresh service
    of the other package over the same directory: the same filters with
    the same bytes (tolerance 0), and the replay's counts."""
    d = str(tmp_path / "log")
    make_w, make_r = (_jax_service, _port_service) if writer == "tpubloom" else \
        (_port_service, _jax_service)
    log_w, log_r = (JOpLog, OpLog) if writer == "tpubloom" else (OpLog, JOpLog)
    steps = _log_script(np.random.default_rng(2015))
    wlog = log_w(d)
    wsvc = make_w(wlog)
    for method, req in steps:
        getattr(wsvc, method)(req)
    n = wlog.last_seq
    rlog = log_r(d)
    rsvc = make_r(rlog)
    try:
        stats = rsvc.replay_oplog()
        assert stats["applied"] == n and stats["failed"] == 0, stats
        assert_same_filters(wsvc, rsvc)
        for name in rsvc._filters:
            assert rsvc._filters[name].applied_seq == wsvc._filters[name].applied_seq
    finally:
        wsvc.shutdown()
        rsvc.shutdown()
        wlog.close()
        rlog.close()


# -- the service's log wiring (tests/test_repl.py's contracts on the port) --


def _port(tmp_path, log, **kw):
    sink_dir = str(tmp_path / "ckpt")
    return service.BloomService(
        sink_factory=lambda c: ck.FileSink(sink_dir), oplog=log, device="cpu", **kw)


def _hits(resp) -> np.ndarray:
    return np.unpackbits(np.frombuffer(resp["hits"], np.uint8), count=resp["n"]).astype(bool)


def test_replay_is_gated_by_checkpoint_repl_seq(tmp_path):
    """A checkpoint that landed after some ops makes their replay a no-op,
    or a restart would double-increment a counting filter."""
    log = OpLog(str(tmp_path / "log"))
    svc = _port(tmp_path, log)
    ks = [b"g%015d" % i for i in range(64)]
    svc.CreateFilter({"name": "cnt", "capacity": 10_000, "error_rate": 0.01,
                      "options": {"counting": True}})
    svc.InsertBatch({"name": "cnt", "keys": ks})       # seq 2, counts 1
    svc.Checkpoint({"name": "cnt", "wait": True})      # covers seq 2
    svc.InsertBatch({"name": "cnt", "keys": [b"tail-key"]})  # seq 3
    svc.shutdown()
    log.close()

    log2 = OpLog(str(tmp_path / "log"))
    svc2 = _port(tmp_path, log2)
    try:
        stats = svc2.replay_oplog()
        assert stats["skipped"] >= 1, stats
        assert svc2._filters["cnt"].applied_seq == 3
        svc2.DeleteBatch({"name": "cnt", "keys": ks})
        assert not _hits(svc2.QueryBatch({"name": "cnt", "keys": ks})).any()
        assert _hits(svc2.QueryBatch({"name": "cnt", "keys": [b"tail-key"]})).all()
    finally:
        svc2.shutdown()
        log2.close()


def test_checkpoint_keyed_log_truncation(tmp_path):
    log = OpLog(str(tmp_path / "log"), segment_bytes=512)
    svc = _port(tmp_path, log)
    try:
        svc.CreateFilter({"name": "t", "capacity": 10_000, "error_rate": 0.01})
        for i in range(30):
            svc.InsertBatch({"name": "t", "keys": [b"key-%06d" % i]})
        assert log.stats()["segments"] > 2
        svc.Checkpoint({"name": "t", "wait": True})
        first = log.first_seq
        svc._maybe_truncate_log()
        assert log.first_seq > first
        tail = [r["seq"] for r in log.read_from(0)]
        assert tail == sorted(tail) and tail[-1] == log.last_seq
    finally:
        svc.shutdown()
        log.close()
    # the truncated log and its checkpoint restart the filter whole
    log2 = OpLog(str(tmp_path / "log"), segment_bytes=512)
    svc2 = _port(tmp_path, log2)
    try:
        assert svc2.replay_oplog()["failed"] == 0
        hits = _hits(svc2.QueryBatch({"name": "t", "keys": [b"key-%06d" % i for i in range(30)]}))
        assert hits.all()
    finally:
        svc2.shutdown()
        log2.close()


def test_append_failure_failstops_writes_and_degrades_health(tmp_path):
    """An op applied whose append fails leaves the service ahead of its
    log: further writes fail-stop (Redis MISCONF parity), Health says why,
    reads keep serving."""
    log = OpLog(str(tmp_path / "log"))
    svc = _port(tmp_path, log)
    srv, port = service.build_server(svc, "127.0.0.1:0")
    srv.start()
    client = BloomClient(f"127.0.0.1:{port}", max_retries=0)
    try:
        client.wait_ready()
        client.create_filter("fs", capacity=1000, error_rate=0.01)
        client.insert_batch("fs", [b"before"])
        faults.arm("repl.append", "once")
        with pytest.raises(protocol.BloomServiceError, match="INTERNAL"):
            client.insert_batch("fs", [b"lost"])
        with pytest.raises(protocol.BloomServiceError, match="LOG_WRITE_FAILED"):
            client.insert_batch("fs", [b"after"])
        h = client.health()
        assert h["status"] == "DEGRADED" and "oplog_append_error" in h["reasons"]
        assert client.include("fs", b"before")
    finally:
        client.close()
        srv.stop(grace=None)
        svc.shutdown()
        log.close()


def test_epoch_persists_beside_the_log(tmp_path):
    """With an op log the topology epoch is loaded from and stored in
    ``epoch.json`` beside it (``tpubloom_torch.ha.topology.EpochStore``),
    in the reference's format: each package reads the other's."""
    from tpubloom.ha.topology import EpochStore as JEpochStore

    d = str(tmp_path / "log")
    log = OpLog(d)
    svc = _port(tmp_path, log)
    svc.adopt_epoch(4)
    svc.shutdown()
    log.close()
    assert JEpochStore(d).load() == 4
    JEpochStore(d).store(6)
    log2 = OpLog(d)
    svc2 = _port(tmp_path, log2)
    assert svc2.epoch == 6
    svc2.shutdown()
    log2.close()
