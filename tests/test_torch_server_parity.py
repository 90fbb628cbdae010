"""The port's gRPC server against ``tpubloom.server`` on the CPU: one
scripted request sequence goes, as raw msgpack over gRPC, to a JAX
``BloomService`` and to a port ``BloomService(device="cpu")``, with the
ingest coalescer off and on.

Exact (tolerance 0): every response dict (``backend`` and ``devices`` of
Health excluded), every filter's checkpoint blob byte for byte (words,
header, usage counters; both packages read one fixed clock), the blobs
each server's ``Checkpoint`` RPC wrote into its sink, and a restore of
each server's sink in the other package. The kinds: flat, blocked,
counting, blocked counting, sharded (8 shards; the port on one CPU
slot, tpubloom on its 8-device CPU mesh), scalable, cuckoo, count-min and
top-k, at m = 2^16–2^20, 16-byte keys made with numpy from a seed."""

import os
import threading
import time
import types

import msgpack
import numpy as np
import pytest

import grpc

from tpubloom import checkpoint as jck
from tpubloom.server import ingest as jingest
from tpubloom.server import service as jservice
from tpubloom_torch import checkpoint as ck
from tpubloom_torch import faults
from tpubloom_torch.obs import blackbox, counters, flight, trace
from tpubloom_torch.server import ingest, protocol, service

L = 16
FIXED_CLOCK = 1_700_000_000.0

#: name -> CreateFilter request (or a reserve verb and its request)
FILTERS = {
    "flat": ("CreateFilter", {"config": {"m": 1 << 16, "k": 5, "key_len": L}}),
    "blocked": ("CreateFilter", {"config": {"m": 1 << 18, "k": 7, "key_len": L,
                                            "block_bits": 512}}),
    "counting": ("CreateFilter", {"config": {"m": 1 << 16, "k": 4, "key_len": L,
                                             "counting": True}}),
    "blocked-counting": ("CreateFilter", {"config": {
        "m": 1 << 16, "k": 4, "key_len": L, "counting": True, "block_bits": 512}}),
    "sharded": ("CreateFilter", {"config": {"m": 1 << 20, "k": 5, "key_len": L,
                                            "block_bits": 512, "shards": 8}}),
    "scalable": ("CreateFilter", {"capacity": 300, "error_rate": 0.01,
                                  "options": {"key_len": L},
                                  "scalable": {"growth": 2, "tightening": 0.5}}),
    "cf": ("CFReserve", {"capacity": 1000, "options": {"key_len": L}}),
    "cms": ("CMSInitByDim", {"width": 2000, "depth": 5, "options": {"key_len": L}}),
    "topk": ("TopKReserve", {"topk": 5, "width": 512, "depth": 4,
                             "options": {"key_len": L}}),
}
DELETABLE = ("counting", "blocked-counting", "cf")


@pytest.fixture(autouse=True)
def port_globals():
    yield
    faults.reset()
    trace.reset_for_tests()
    flight.reset_for_tests()
    blackbox.reset_for_tests()
    counters.reset_for_tests()


@pytest.fixture()
def fixed_clock(monkeypatch):
    """One wall clock for both packages' checkpoint code: blob headers
    carry the time and generation seqs come from the millisecond clock."""
    fake = types.SimpleNamespace(
        time=lambda: FIXED_CLOCK, perf_counter=time.perf_counter,
        monotonic=time.monotonic, sleep=time.sleep,
    )
    monkeypatch.setattr(jck, "time", fake)
    monkeypatch.setattr(ck, "time", fake)


class _Server:
    def __init__(self, svc, sink_dir):
        self.service = svc
        self.sink_dir = sink_dir
        self.srv, port = svc_build(svc)
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
        self.service.shutdown()


def svc_build(svc):
    build = service.build_server if isinstance(svc, service.BloomService) \
        else jservice.build_server
    return build(svc, "127.0.0.1:0")


def _pair(tmp_path):
    """A JAX and a port server, each with its ingest coalescer running
    (:func:`_coalescing` detaches and re-attaches it)."""
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jsvc = jservice.BloomService(
        sink_factory=lambda config: jck.FileSink(jdir),
        coalesce=jingest.CoalesceConfig(max_keys=4096),
    )
    psvc = service.BloomService(
        sink_factory=lambda config: ck.FileSink(pdir),
        coalesce=ingest.CoalesceConfig(max_keys=4096),
        device="cpu",
    )
    return _Server(jsvc, jdir), _Server(psvc, pdir)


def _coalescing(servers, on: bool):
    """Route requests through the coalescer (``on``) or the direct
    per-request path: one pair of servers serves both passes, so the
    reference's jitted functions compile once."""
    for srv in servers:
        if not hasattr(srv, "coalescer"):
            srv.coalescer = srv.service._coalescer
        srv.service._coalescer = srv.coalescer if on else None


def _fixed(keys):
    return {"data": b"".join(keys), "width": L, "n": len(keys)}


def _script(rng):
    """The request sequence: (method, request) pairs."""
    keys = lambda n: [rng.bytes(L) for _ in range(n)]  # noqa: E731
    steps = [("Health", {})]
    for name, (verb, req) in FILTERS.items():
        steps.append((verb, {"name": name, **req}))
    steps.append(("ListFilters", {}))
    held = {}
    for name in FILTERS:
        a, b, c = keys(100), keys(100), keys(60)
        held[name] = a + b
        if name == "cf":
            steps += [("CFAdd", {"name": name, "keys": a}),
                      ("CFAdd", {"name": name, "keys_fixed": _fixed(b)})]
        elif name in ("cms", "topk"):
            steps += [("CMSIncrBy", {"name": name, "keys": a}),
                      ("CMSIncrBy", {"name": name, "keys": b[:20],
                                     "increments": [3] * 20})]
            if name == "topk":
                steps.append(("TopKAdd", {"name": name, "keys": a[:30] * 3}))
        else:
            steps += [("InsertBatch", {"name": name, "keys": a}),
                      ("InsertBatch", {"name": name, "keys_fixed": _fixed(b)}),
                      ("InsertBatch", {"name": name, "keys": a[:30] + c,
                                       "return_presence": True})]
        probe = held[name][::3] + keys(60)
        if name == "cms" or name == "topk":
            steps.append(("CMSQuery", {"name": name, "keys": probe}))
        elif name == "cf":
            steps.append(("CFExists", {"name": name, "keys": probe}))
        else:
            steps += [("QueryBatch", {"name": name, "keys": probe}),
                      ("QueryBatch", {"name": name, "keys_fixed": _fixed(probe)})]
        if name in DELETABLE:
            verb = "CFDel" if name == "cf" else "DeleteBatch"
            steps += [(verb, {"name": name, "keys": a[:40]}),
                      (verb, {"name": name, "keys_fixed": _fixed(b[:20])})]
            steps.append(("CFExists" if name == "cf" else "QueryBatch",
                          {"name": name, "keys": a[:50]}))
        if name == "topk":
            steps.append(("TopKList", {"name": name}))
    steps += [
        ("DeleteBatch", {"name": "blocked", "keys": keys(4)}),      # UNSUPPORTED
        ("CFAdd", {"name": "blocked", "keys": keys(4)}),            # WRONG_TYPE
        ("QueryBatch", {"name": "missing", "keys": keys(4)}),       # NOT_FOUND
        ("CreateFilter", {"name": "flat", **FILTERS["flat"][1]}),   # ALREADY_EXISTS
    ]
    steps += [("Checkpoint", {"name": name, "wait": True}) for name in FILTERS]
    return steps, held


def _comparable(method, resp):
    if method == "Health":
        return {k: v for k, v in resp.items() if k not in ("backend", "devices")}
    return resp


def _sink_blobs(directory):
    return {
        fn: open(os.path.join(directory, fn), "rb").read()
        for fn in sorted(os.listdir(directory)) if fn.endswith(".ckpt")
    }


def _filter_blobs(jsvc, psvc):
    for name in FILTERS:
        jf, pf = jsvc._filters[name].filter, psvc._filters[name].filter
        _, _, jblob = jck.snapshot_blob(jf, seq=7)
        _, _, pblob = ck.snapshot_blob(pf, seq=7)
        assert bytes(pblob) == bytes(jblob), name


def _burst(servers, rng):
    """Concurrent clients: inserts commute, so the state after the burst
    is the same whatever the coalescer merged."""
    bursts = [[rng.bytes(L) for _ in range(64)] for _ in range(24)]

    def drive(srv, part):
        for j in part:
            name = ("blocked", "counting", "sharded")[j % 3]
            req = {"name": name, "keys": bursts[j]} if j % 2 else \
                {"name": name, "keys_fixed": _fixed(bursts[j])}
            assert srv.call("InsertBatch", req)["ok"]

    for srv in servers:
        threads = [threading.Thread(target=drive, args=(srv, range(t, 24, 4)))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()


def test_scripted_sequence_matches_reference_server(tmp_path, fixed_clock):
    jax_srv, port_srv = _pair(tmp_path)
    servers = (jax_srv, port_srv)
    try:
        for seed, coalesce in ((2014, False), (2015, True)):
            _coalescing(servers, coalesce)
            rng = np.random.default_rng(seed)
            steps, held = _script(rng)
            for i, (method, req) in enumerate(steps):
                want = jax_srv.call(method, req)
                got = port_srv.call(method, req)
                assert _comparable(method, got) == _comparable(method, want), (
                    coalesce, i, method, req.get("name"))
            assert port_srv.call("Health", {})["backend"] == "cpu"
            _burst(servers, rng)
            _filter_blobs(jax_srv.service, port_srv.service)
            for name in FILTERS:
                assert jax_srv.call("Clear", {"name": name}) == \
                    port_srv.call("Clear", {"name": name})
                probe = {"name": name, "keys": held[name][:64]}
                verb = {"cf": "CFExists", "cms": "CMSQuery",
                        "topk": "CMSQuery"}.get(name, "QueryBatch")
                assert jax_srv.call(verb, probe) == port_srv.call(verb, probe), name
        jblobs, pblobs = _sink_blobs(jax_srv.sink_dir), _sink_blobs(port_srv.sink_dir)
        assert list(pblobs) == list(jblobs) and len(pblobs) == 2 * len(FILTERS)
        for fn in jblobs:
            assert pblobs[fn] == jblobs[fn], fn
    finally:
        jax_srv.close()
        port_srv.close()

    # a sink written by each server restores in the other package's server
    jsvc = jservice.BloomService(sink_factory=lambda config: jck.FileSink(port_srv.sink_dir))
    psvc = service.BloomService(
        sink_factory=lambda config: ck.FileSink(jax_srv.sink_dir), device="cpu"
    )
    for name, (verb, req) in FILTERS.items():
        rj = getattr(jsvc, verb)({"name": name, **req})
        rp = getattr(psvc, verb)({"name": name, **req})
        assert rp == rj and rp["restored_seq"] is not None, name
    _filter_blobs(jsvc, psvc)
