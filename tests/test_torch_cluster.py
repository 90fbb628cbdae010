"""Cluster mode of the port (``tpubloom_torch.cluster``: slots, the
ownership state, the routed client, the admin CLI) and the fleet scraper
(``tpubloom_torch.obs.aggregate``) against ``tpubloom`` on the CPU.

Exact (tolerance 0), against the reference: ``crc16`` and ``key_slot``
over 10,000 seeded names; ``ranges_of`` / ``expand_ranges`` /
``SlotMap.to_dict``, and ``cluster_slots.json`` written by either package
loading in the other (a corrupt one reads as no map in both);
``even_ranges`` and ``plan_moves`` over seeded owner maps; every answer of
``ClusterState`` (``check``, ``set_slot``, the forward table, the import
gate) over one table of scripts; the error frames of keyed and cluster
RPCs at a port node and a ``tpubloom`` node holding the same map;
``merge_scrapes`` on the same scrape texts; and the plan ``rebalance``
prints and the slots it moves over a sparse map. The rest holds the port
to ``tests/test_cluster.py``'s contracts: the routed client's MOVED heal
and its fixed-width keys on each hop, ``init`` / ``info`` /
``--plan-only``, a merged scrape over two port nodes and a dead address,
the sentinels' ``TopologyEvents`` push, and the CLIs without ``jax``.
Migration is in ``tests/test_torch_cluster_migrate.py``."""

import json
import os
import socket
import subprocess
import sys
import time

import grpc
import numpy as np
import pytest

from tpubloom import checkpoint as jck
from tpubloom import faults as jfaults
from tpubloom.cluster import node as jnode
from tpubloom.cluster import rebalance as jrebalance
from tpubloom.cluster import slots as JS
from tpubloom.obs import aggregate as jagg
from tpubloom.obs import blackbox as jblackbox
from tpubloom.obs import flight as jflight
from tpubloom.obs import trace as jtrace
from tpubloom.repl import OpLog as JOpLog
from tpubloom.server import protocol as jprotocol
from tpubloom.server import service as jservice
from tpubloom_torch import checkpoint as ck
from tpubloom_torch import faults
from tpubloom_torch.cluster import rebalance
from tpubloom_torch.cluster import slots as S
from tpubloom_torch.cluster.client import ClusterClient
from tpubloom_torch.cluster.node import ClusterState
from tpubloom_torch.obs import aggregate as agg
from tpubloom_torch.obs import blackbox, counters, flight, trace
from tpubloom_torch.repl import OpLog
from tpubloom_torch.server import protocol, service
from tpubloom_torch.server.client import BloomClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ERRORS = (protocol.BloomServiceError, jprotocol.BloomServiceError)


@pytest.fixture(autouse=True)
def port_globals():
    """Both packages' fault points and observability rings start and end
    each test reset."""
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()
    for mod in (trace, flight, blackbox, counters, jtrace, jflight, jblackbox):
        mod.reset_for_tests()


class CNode:
    """One in-process cluster node of either package: a primary with an op
    log (the slot map persists beside it), an optional checkpoint sink and,
    on the port, an optional ingest coalescer."""

    def __init__(self, pkg, tmp_path, name, *, sink=False, coalesce=None):
        svc_mod = service if pkg == "torch" else jservice
        d = tmp_path / name
        self.log = (OpLog if pkg == "torch" else JOpLog)(str(d / "log"))
        args = {"oplog": self.log}
        if sink:
            codec = ck if pkg == "torch" else jck
            args["sink_factory"] = lambda c: codec.FileSink(str(d / "ck"))
        if pkg == "torch":
            args["device"] = "cpu"
            args["coalesce"] = coalesce
        self.service = svc_mod.BloomService(**args)
        self.server, port = svc_mod.build_server(self.service, "127.0.0.1:0")
        self.server.start()
        self.addr = f"127.0.0.1:{port}"
        self.service.listen_address = self.addr
        cls = ClusterState if pkg == "torch" else jnode.ClusterState
        self.service.cluster = cls(self.addr, state_dir=str(d / "log"))

    @property
    def cluster(self):
        return self.service.cluster

    def close(self):
        self.server.stop(grace=None)
        self.service.shutdown()
        self.log.close()
        self.cluster.close()


def assign_even(nodes, epoch=1) -> list:
    addrs = [n.addr for n in nodes]
    ranges = rebalance.even_ranges(addrs)
    for n in nodes:
        n.service.ClusterSetSlot({"assign": ranges, "epoch": epoch})
    return addrs


def name_owned_by(owner, addr, prefix="f") -> str:
    """The first ``<prefix>-<i>`` whose slot ``owner(slot)`` gives to ``addr``."""
    for i in range(4096):
        cand = f"{prefix}-{i}"
        if owner(S.key_slot(cand)) == addr:
            return cand
    raise AssertionError("no candidate name hashed to the wanted node")


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# -- slot hashing and the map ----------------------------------------------------


def _names(n=10_000, seed=17) -> list:
    """Seeded filter names: plain ones, ``{tag}`` ones (a tag alone, a tag
    inside, an empty ``{}``, an unclosed ``{``, two tags), non-ASCII ones
    and ``bytes`` ones."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        body = "".join(chr(c) for c in rng.integers(33, 127, rng.integers(1, 24)))
        kind = i % 8
        if kind == 1:
            body = f"user:{{{body[:5]}}}:seen"
        elif kind == 2:
            body = "{}" + body
        elif kind == 3:
            body = body + "{" + body[:3]
        elif kind == 4:
            body = f"{{{body[:2]}}}x{{{body[2:4]}}}"
        elif kind == 5:
            body = body + "é" + chr(0x4E00 + i % 64)
        elif kind == 6:
            body = body.encode() + bytes(rng.integers(0, 256, 4, dtype=np.uint8))
        elif kind == 7:
            body = f"{{{body}}}"
        out.append(body)
    return out


def test_crc16_and_key_slot_equal_reference():
    assert S.crc16(b"123456789") == JS.crc16(b"123456789") == 0x31C3
    names = _names()
    for name in names:
        raw = name if isinstance(name, bytes) else name.encode()
        assert S.crc16(raw) == JS.crc16(raw), name
        assert S.key_slot(name) == JS.key_slot(name), name
    # the hash-tag rule: a non-empty {...} hashes alone, {} hashes the whole name
    assert S.key_slot("user:{42}:seen") == S.key_slot("42") == JS.key_slot("user:{42}:blocked")
    assert S.key_slot("{}x") == S.crc16(b"{}x") % S.NUM_SLOTS
    slots = {S.key_slot(n) for n in names}
    assert len(slots) > 5000, "the seeded names spread over the keyspace"


@pytest.mark.parametrize("writer", ["torch", "tpubloom"])
def test_slot_map_files_cross_packages(writer, tmp_path):
    """``ranges_of`` / ``expand_ranges`` / ``SlotMap.to_dict`` equal the
    reference's on a seeded map; ``cluster_slots.json`` written by
    ``writer`` loads equal in both packages; a corrupt one loads as no map
    in both."""
    rng = np.random.default_rng(3)
    addrs = ["a:1", "b:2", "c:3"]
    owners = {int(s): addrs[int(rng.integers(0, 3))]
              for s in rng.choice(S.NUM_SLOTS, 3000, replace=False)}
    assert S.ranges_of(owners) == JS.ranges_of(owners)
    ranges = S.ranges_of(owners)
    assert S.expand_ranges(ranges) == JS.expand_ranges(ranges) == owners
    maps = {}
    for pkg, mod in (("torch", S), ("tpubloom", JS)):
        m = mod.SlotMap()
        assert m.adopt_assignments(ranges, 7)
        assert not m.adopt_assignments(ranges, 6)
        m.migrating[int(ranges[0][0])] = "c:3"
        m.importing[int(ranges[-1][1])] = "a:1"
        maps[pkg] = m
    assert maps["torch"].to_dict() == maps["tpubloom"].to_dict()
    wmod, m = (S, maps["torch"]) if writer == "torch" else (JS, maps["tpubloom"])
    store = wmod.SlotStore(str(tmp_path))
    store.store(m)
    for mod in (S, JS):
        loaded = mod.SlotStore(str(tmp_path)).load()
        assert loaded.to_dict() == m.to_dict()
        assert loaded.owners == owners and loaded.epoch == 7
    with open(store.path, "a") as f:
        f.write("rot")
    assert S.SlotStore(str(tmp_path)).load() is None
    assert JS.SlotStore(str(tmp_path)).load() is None


def _owner_map(n_nodes: int, stray: int, seed: int) -> tuple:
    """A seeded owner map over ``n_nodes`` nodes (uneven shares, some slots
    unassigned) with ``stray`` nodes outside the target set owning some."""
    rng = np.random.default_rng(seed)
    nodes = [f"10.0.0.{i}:7000" for i in range(n_nodes)]
    leaving = [f"10.0.1.{i}:7000" for i in range(stray)]
    everyone = nodes + leaving
    weights = rng.random(len(everyone)) + 0.05
    assigned = rng.choice(S.NUM_SLOTS, int(rng.integers(64, S.NUM_SLOTS)), replace=False)
    picks = rng.choice(len(everyone), len(assigned), p=weights / weights.sum())
    return {int(s): everyone[int(p)] for s, p in zip(assigned, picks)}, nodes


@pytest.mark.parametrize("n_nodes", [1, 2, 3, 5, 7])
@pytest.mark.parametrize("stray", [0, 2])
def test_even_ranges_and_plan_moves_equal_reference(n_nodes, stray):
    nodes = [f"10.0.0.{i}:7000" for i in range(n_nodes)]
    assert rebalance.even_ranges(nodes) == jrebalance.even_ranges(nodes)
    for seed in range(4):
        owners, nodes = _owner_map(n_nodes, stray, seed)
        moves = rebalance.plan_moves(dict(owners), nodes)
        assert moves == jrebalance.plan_moves(dict(owners), nodes)
        after = dict(owners)
        for slot, src, dst in moves:
            assert after[slot] == src and dst in nodes
            after[slot] = dst
        counts = [sum(1 for a in after.values() if a == n) for n in nodes]
        assert set(after.values()) <= set(nodes)
        assert max(counts) - min(counts) <= 1


# -- the ownership state ---------------------------------------------------------

SELF, PEER, THIRD = "10.0.0.1:7000", "10.0.0.2:7000", "10.0.0.3:7000"
HALF = [[0, 8191, SELF], [8192, S.NUM_SLOTS - 1, PEER]]
MINE = name_owned_by(lambda s: SELF if s < 8192 else PEER, SELF, "mine")
THEIRS = name_owned_by(lambda s: SELF if s < 8192 else PEER, PEER, "theirs")
MINE2 = "{" + MINE + "}:b"
SLOT = {n: S.key_slot(n) for n in (MINE, THEIRS, MINE2)}


def _assign(epoch, ranges=HALF):
    return ("set_slot", {"assign": ranges, "epoch": epoch})


def _mark(name, state, addr=None, **kw):
    return ("set_slot", {"slot": SLOT.get(name, name), "state": state, "addr": addr, **kw})


#: scripts of ClusterState calls, each run on a fresh state of each package
#: (``SELF``'s), their answers compared step by step: the cases of
#: tests/test_cluster.py's ``test_moved_ask_clusterdown_shapes`` and
#: ``test_slot_map_epoch_discipline``, then the forward table and the gate
STATE_SCRIPTS = {
    "unassigned_is_clusterdown": [
        ("check", (MINE,), {}), ("check", (THEIRS,), {"asking": True}), ("describe", (), {}),
        ("summary", (), {})],
    "owned_served_foreign_moved": [
        _assign(1), ("check", (MINE,), {}), ("check", (THEIRS,), {}),
        ("check", (THEIRS,), {"asking": True}), ("owner", (SLOT[THEIRS],), {}),
        ("describe", (), {}), ("summary", (), {})],
    "importing_serves_only_asking": [
        _assign(1), _mark(THEIRS, "importing", PEER), ("check", (THEIRS,), {}),
        ("check", (THEIRS,), {"asking": True}), ("is_importing", (SLOT[THEIRS],), {}),
        ("summary", (), {}), _mark(THEIRS, "stable"), ("check", (THEIRS,), {"asking": True})],
    "migrating_asks_for_missing": [
        _assign(1), _mark(MINE, "migrating", PEER), ("check", (MINE,), {"exists": True}),
        ("check", (MINE,), {}), ("check", (MINE2,), {"asking": True}), ("describe", (), {})],
    "replica_serves_its_primary": [
        _assign(1), ("check", (THEIRS,), {"primary_address": PEER}),
        ("check", (MINE,), {"primary_address": PEER})],
    "epoch_discipline": [
        _assign(5), _assign(4, [[0, 10, PEER]]), _mark(1, "node", PEER, epoch=2),
        _mark(1, "node", PEER, epoch=6), ("owner", (1,), {}), ("epoch", (), {}),
        _mark(2, "migrating", THIRD, epoch=3), _mark(2, "importing", THIRD, epoch=5),
        _mark(3, "node", THIRD), ("epoch", (), {}), _mark(3, "bogus", THIRD),
        _assign(8, [[0, 100, SELF]]), ("describe", (), {})],
    "forward_table": [
        _assign(1), _mark(MINE, "migrating", PEER), ("forward_target", (MINE,), {}),
        ("begin_forwarding", (MINE2, THIRD), {}), ("forward_target", (MINE2,), {}),
        ("forward_target", (THEIRS,), {}), _mark(MINE, "node", PEER, epoch=2),
        ("forward_target", (MINE2,), {}), ("forward_target", (MINE,), {}),
        ("check", (MINE,), {}), _mark(MINE, "node", SELF, epoch=3),
        ("forward_target", (MINE2,), {})],
    "forward_table_expiry": [
        _assign(1), ("begin_forwarding", (MINE, PEER), {}), ("forward_target", (MINE,), {}),
        _mark(MINE, "node", PEER, epoch=2), ("forward_target", (MINE,), {}),
        ("begin_forwarding", (MINE, PEER), {}), ("forward_target", (MINE,), {})],
    "import_gate": [
        _assign(1), _mark(THEIRS, "importing", PEER), ("gate_base", (THEIRS,), {}),
        ("gate_claim", (THEIRS, 3), {}), ("seed_gate", (THEIRS, 10), {}),
        ("gate_base", (THEIRS,), {}), ("gate_claim", (THEIRS, 9), {}),
        ("gate_claim", (THEIRS, 10), {}), ("gate_claim", (THEIRS, 11), {}),
        ("gate_claim", (THEIRS, 11), {}), ("gate_unclaim", (THEIRS, 11), {}),
        ("gate_claim", (THEIRS, 11), {}), _mark(THEIRS, "importing", THIRD),
        ("gate_base", (THEIRS,), {}), _mark(THEIRS, "node", SELF, epoch=2),
        ("gate_base", (THEIRS,), {}), ("gate_claim", (THEIRS, 12), {})],
}


def _run_step(state, step):
    method, args, kw = step if len(step) == 3 else (step[0], (step[1],), {})
    try:
        return getattr(state, method)(*args, **kw)
    except ERRORS as e:
        return ("error", e.code, e.message, e.details)


@pytest.mark.parametrize("script", sorted(STATE_SCRIPTS))
def test_cluster_state_answers_as_reference(script, tmp_path):
    """Every call of the script answers alike in both packages (a return
    value, or an error's code, message and details), and the slot maps the
    two states persisted load equal in either package."""
    ttl = {"forward_ttl_s": 0.0} if script == "forward_table_expiry" else {}
    port = ClusterState(SELF, state_dir=str(tmp_path / "p"), **ttl)
    ref = jnode.ClusterState(SELF, state_dir=str(tmp_path / "r"), **ttl)
    try:
        for i, step in enumerate(STATE_SCRIPTS[script]):
            got, want = _run_step(port, step), _run_step(ref, step)
            assert got == want, (i, step, got, want)
        for mod in (S, JS):
            a, b = mod.SlotStore(str(tmp_path / "p")).load(), mod.SlotStore(str(tmp_path / "r")).load()
            assert (a is None and b is None) or a.to_dict() == b.to_dict()
    finally:
        port.close()
        ref.close()


# -- RPC answers at a port node and a tpubloom node ----------------------------------


@pytest.fixture(scope="module")
def twin_nodes():
    """A port service and a ``tpubloom`` one, each served over gRPC with no
    op log; each case attaches fresh ``ClusterState``s named ``SELF``."""
    nodes = {}
    for pkg, mod in (("torch", service), ("tpubloom", jservice)):
        svc = mod.BloomService(device="cpu") if pkg == "torch" else mod.BloomService()
        srv, port = mod.build_server(svc, "127.0.0.1:0")
        srv.start()
        nodes[pkg] = (svc, srv, f"127.0.0.1:{port}")
    yield nodes
    for svc, srv, _ in nodes.values():
        srv.stop(grace=None)
        svc.shutdown()


def _raw(addr, method, req) -> dict:
    ch = grpc.insecure_channel(addr)
    try:
        raw = ch.unary_unary(protocol.method_path(method), request_serializer=lambda b: b,
                             response_deserializer=lambda b: b)(protocol.encode(req), timeout=30)
        return protocol.decode(raw)
    finally:
        ch.close()


KEYS = [b"k%015d" % i for i in range(4)]
#: (the map set-up, method, request): keyed RPCs on slots this node does not
#: serve, and the cluster verbs' refusals
FRAME_CASES = {
    "clusterdown_create": (None, "CreateFilter", {"name": MINE, "capacity": 1000,
                                                  "error_rate": 0.01}),
    "moved_create": ("half", "CreateFilter", {"name": THEIRS, "capacity": 1000,
                                              "error_rate": 0.01}),
    "moved_insert": ("half", "InsertBatch", {"name": THEIRS, "keys": KEYS}),
    "moved_insert_fixed": ("half", "InsertBatch", {"name": THEIRS, "keys_fixed": {
        "data": b"".join(KEYS), "width": 16, "n": 4}}),
    "moved_query": ("half", "QueryBatch", {"name": THEIRS, "keys": KEYS}),
    "moved_delete": ("half", "DeleteBatch", {"name": THEIRS, "keys": KEYS}),
    "moved_stats": ("half", "Stats", {"name": THEIRS}),
    "moved_drop": ("half", "DropFilter", {"name": THEIRS}),
    "moved_cms": ("half", "CMSIncrBy", {"name": THEIRS, "keys": KEYS}),
    "moved_cf": ("half", "CFAdd", {"name": THEIRS, "keys": KEYS}),
    "moved_importing_not_asking": ("importing", "QueryBatch", {"name": THEIRS, "keys": KEYS}),
    "ask_missing_on_migrating": ("migrating", "QueryBatch", {"name": MINE, "keys": KEYS}),
    "ask_missing_create": ("migrating", "CreateFilter", {"name": MINE2, "capacity": 1000,
                                                         "error_rate": 0.01}),
    "migrate_slot_without_log": ("half", "MigrateSlot", {"slot": SLOT[MINE], "target": PEER}),
    "migrate_install_not_importing": ("half", "MigrateInstall", {"name": MINE, "probe": True}),
    "stale_assign": ("half", "ClusterSetSlot", {"assign": HALF, "epoch": 0}),
    "bad_state": ("half", "ClusterSetSlot", {"slot": 1, "state": "bogus"}),
    "cluster_slots": ("migrating", "ClusterSlots", {}),
}


@pytest.mark.parametrize("case", sorted(FRAME_CASES))
def test_rpc_frames_equal_reference(case, twin_nodes):
    setup, method, req = FRAME_CASES[case]
    frames = {}
    for pkg, (svc, _srv, addr) in twin_nodes.items():
        svc.cluster = (ClusterState if pkg == "torch" else jnode.ClusterState)(SELF)
        try:
            if setup is not None:
                svc.cluster.set_slot({"assign": HALF, "epoch": 1})
            if setup == "importing":
                svc.cluster.set_slot({"slot": SLOT[THEIRS], "state": "importing", "addr": PEER})
            if setup == "migrating":
                svc.cluster.set_slot({"slot": SLOT[MINE], "state": "migrating", "addr": PEER})
            frames[pkg] = _raw(addr, method, dict(req))
        finally:
            svc.cluster.close()
            svc.cluster = None
    assert frames["torch"] == frames["tpubloom"]
    if method != "ClusterSlots":
        assert frames["torch"]["ok"] is False, frames["torch"]


def test_cluster_state_call_raises_as_reference(twin_nodes):
    """``ClusterState.call`` of either package to either node raises the
    same error (code, message, details) for a refused keyed RPC."""
    got = []
    for pkg, (svc, _srv, addr) in twin_nodes.items():
        svc.cluster = (ClusterState if pkg == "torch" else jnode.ClusterState)(SELF)
        svc.cluster.set_slot({"assign": HALF, "epoch": 1})
    try:
        for caller in (ClusterState("c"), jnode.ClusterState("c")):
            for _pkg, (_svc, _srv, addr) in twin_nodes.items():
                with pytest.raises(ERRORS) as exc:
                    caller.call(addr, "QueryBatch", {"name": THEIRS, "keys": KEYS})
                got.append((exc.value.code, exc.value.message, exc.value.details))
            caller.close()
    finally:
        for svc, _srv, _addr in twin_nodes.values():
            svc.cluster.close()
            svc.cluster = None
    assert len(set(map(repr, got))) == 1 and got[0][0] == "MOVED", got


# -- the fleet scraper --------------------------------------------------------------

SCRAPES = {
    "10.0.0.1:9095": (
        "# HELP tpubloom_uptime_seconds seconds since start\n"
        "# TYPE tpubloom_uptime_seconds gauge\n"
        "tpubloom_uptime_seconds 12.5\n"
        "\n"
        "# HELP tpubloom_rpc_seconds latency\n"
        "# TYPE tpubloom_rpc_seconds histogram\n"
        'tpubloom_rpc_seconds_bucket{method="InsertBatch",le="0.001"} 3\n'
        'tpubloom_rpc_seconds_bucket{method="InsertBatch",le="+Inf"} 4\n'
        'tpubloom_filter_fill_ratio{filter="a\\"b"} 0.25\n'
        "malformed_line_without_value\n"),
    "10.0.0.2:9095": (
        "# HELP tpubloom_uptime_seconds seconds since start\n"
        "# TYPE tpubloom_uptime_seconds gauge\n"
        "tpubloom_uptime_seconds 3\n"
        "# TYPE tpubloom_cluster_slots_owned gauge\n"
        "tpubloom_cluster_slots_owned 8192\n"),
    "10.0.0.3:9095": None,
    'odd"node\\x': "tpubloom_keys_inserted_total 1\n",
}


def test_merge_scrapes_equals_reference():
    assert agg.merge_scrapes(SCRAPES) == jagg.merge_scrapes(SCRAPES)
    for node_, text in SCRAPES.items():
        if text is not None:
            assert agg.relabel(text, node_) == jagg.relabel(text, node_)
    # rendered services of both packages, merged alike
    psvc, jsvc = service.BloomService(device="cpu"), jservice.BloomService()
    try:
        from tpubloom.obs.exposition import render_service as jrender
        from tpubloom_torch.obs.exposition import render_service

        texts = {"p:1": render_service(psvc), "j:1": jrender(jsvc), "dead:1": None}
        assert agg.merge_scrapes(texts) == jagg.merge_scrapes(texts)
    finally:
        psvc.shutdown()
        jsvc.shutdown()


def test_aggregate_over_port_nodes_and_a_dead_address(tmp_path, capsys):
    """Two port nodes' ``/metrics`` and one dead address, merged by
    ``aggregate`` and by ``main([... "--once"])``: per-node labels, headers
    once, the dead node up 0."""
    from tpubloom_torch.obs.exposition import parse_families
    from tpubloom_torch.obs.httpd import start_metrics_server

    a, b = CNode("torch", tmp_path, "a"), CNode("torch", tmp_path, "b")
    servers = []
    try:
        assign_even([a, b])
        for n, prefix in ((a, "agg-a"), (b, "agg-b")):
            n.service.CreateFilter({"name": name_owned_by(n.cluster.owner, n.addr, prefix),
                                    "config": {"m": 1 << 16, "k": 5, "block_bits": 512}})
        servers = [start_metrics_server(n.service, port=0, host="127.0.0.1") for n in (a, b)]
        dead = f"127.0.0.1:{free_port()}"
        nodes = [f"127.0.0.1:{ms.port}" for ms in servers] + [dead]
        merged = agg.aggregate(nodes, timeout=3.0)
        assert agg.main(["--nodes", ",".join(nodes), "--once", "--timeout", "3"]) == 0
        once = capsys.readouterr().out
        for text in (merged, once):
            fams = parse_families(text)
            up = fams["tpubloom_aggregate_node_up"]
            assert up[(("node", nodes[0]),)] == 1.0 and up[(("node", nodes[1]),)] == 1.0
            assert up[(("node", dead),)] == 0.0
            created = fams["tpubloom_filters_created_total"]
            assert all(created[(("node", nd),)] >= 1.0 for nd in nodes[:2])
            assert fams["tpubloom_cluster_config_epoch"][(("node", nodes[0]),)] == 1.0
            assert text.count("# TYPE tpubloom_uptime_seconds gauge") == 1
            labels = {dict(k).get("filter") for k in fams["tpubloom_filter_fill_ratio"]}
            assert {f for f in labels if f} and all(
                f.startswith(("agg-a", "agg-b")) for f in labels if f)
    finally:
        for ms in servers:
            ms.close()
        a.close()
        b.close()


# -- the routed client over port nodes -------------------------------------------------


def test_cluster_client_routing_and_moved_heal(tmp_path):
    a, b = CNode("torch", tmp_path, "a"), CNode("torch", tmp_path, "b")
    try:
        addrs = assign_even([a, b])
        cc = ClusterClient(startup_nodes=addrs)
        assert cc.epoch == 1
        names = [name_owned_by(a.cluster.owner, addrs[0], "ra"),
                 name_owned_by(a.cluster.owner, addrs[1], "rb")]
        for n in names:
            cc.create_filter(n, capacity=2000, error_rate=0.01)
            cc.insert_batch(n, [b"k1", b"k2"])
            assert cc.include_batch(n, [b"k1", b"k2", b"nope"]).tolist() == [True, True, False]
        assert names[0] in a.service._filters and names[1] in b.service._filters
        assert set(names) <= set(cc.list_filters())
        assert cc.stats(names[0])["n_inserted"] >= 2
        # flip names[0]'s slot to b out of band: the client heals by MOVED
        slot = S.key_slot(names[0])
        for n in (a, b):
            n.service.ClusterSetSlot({"slot": slot, "state": "node", "addr": addrs[1], "epoch": 2})
        before = counters.get("client_moved_redirects")
        cc.create_filter(names[0], capacity=2000, error_rate=0.01, exist_ok=True)
        assert counters.get("client_moved_redirects") > before
        assert cc.epoch == 2 and names[0] in b.service._filters
        cc.close()
    finally:
        a.close()
        b.close()


def test_cluster_client_follows_ask(tmp_path):
    """A filter already handed to the importing node while its slot is
    marked migrating: the owner answers ASK, and the client's one-shot
    ``asking`` hop is served by the target without touching its slot
    cache."""
    a, b = CNode("torch", tmp_path, "a"), CNode("torch", tmp_path, "b")
    try:
        addrs = assign_even([a, b])
        name = name_owned_by(a.cluster.owner, addrs[0], "ask")
        slot = S.key_slot(name)
        a.service.ClusterSetSlot({"slot": slot, "state": "migrating", "addr": addrs[1]})
        b.service.ClusterSetSlot({"slot": slot, "state": "importing", "addr": addrs[0]})
        b.service.CreateFilter({"name": name, "capacity": 1000, "error_rate": 0.01,
                                "asking": True})
        cc = ClusterClient(startup_nodes=addrs)
        before = counters.get("client_ask_redirects")
        assert cc.insert_batch(name, [b"k1", b"k2"]) == 2
        assert cc.include_batch(name, [b"k1", b"nope"]).tolist() == [True, False]
        assert counters.get("client_ask_redirects") == before + 2
        assert cc._slot_owner[slot] == addrs[0], "an ASK does not move the slot in the cache"
        assert name in b.service._filters and name not in a.service._filters
        cc.close()
    finally:
        a.close()
        b.close()


def test_cluster_client_ships_keys_fixed_per_hop(tmp_path, monkeypatch):
    """Inserts, queries and deletes of equal-width keys go as ``keys_fixed``
    on every hop, a MOVED hop included."""
    a, b = CNode("torch", tmp_path, "a"), CNode("torch", tmp_path, "b")
    try:
        addrs = assign_even([a, b])
        seen: list = []
        orig = BloomClient._rpc

        def spy(self, method, req, **kw):
            if method in ("InsertBatch", "QueryBatch", "DeleteBatch"):
                seen.append((method, self.address, "keys_fixed" in req, "keys" in req))
            return orig(self, method, req, **kw)

        monkeypatch.setattr(BloomClient, "_rpc", spy)
        cc = ClusterClient(startup_nodes=addrs)
        name = name_owned_by(a.cluster.owner, addrs[0], "fx")
        cc.create_filter(name, capacity=2000, error_rate=0.01, counting=True)
        keys = [b"fx-%05d" % i for i in range(16)]
        assert cc.insert_batch(name, keys) == 16
        # the slot moves to b out of band (the filter created there too): the
        # next calls take a MOVED hop, each hop fixed-width
        slot = S.key_slot(name)
        for n in (a, b):
            n.service.ClusterSetSlot({"slot": slot, "state": "node", "addr": addrs[1], "epoch": 2})
        b.service.CreateFilter({"name": name, "capacity": 2000, "error_rate": 0.01,
                                "options": {"counting": True}})
        assert cc.insert_batch(name, keys) == 16
        assert cc.include_batch(name, keys).all()
        assert cc.delete_batch(name, keys) == 16
        assert not cc.include_batch(name, keys).any()
        assert {m for m, _, fx, _ in seen if fx} == {"InsertBatch", "QueryBatch", "DeleteBatch"}
        assert all(fx and not plain for _, _, fx, plain in seen), seen
        assert {addr for _, addr, _, _ in seen} == set(addrs), "a hop went to each node"
        cc.close()
    finally:
        a.close()
        b.close()


def test_topology_events_push_repoints_cluster_client(tmp_path):
    """A ``ClusterClient`` shard behind a port ``Sentinel`` with
    ``topology_push``: the leader's announcement re-points the shard
    client without an error round trip."""
    from tpubloom_torch.ha.sentinel import Sentinel

    a, b = CNode("torch", tmp_path, "a"), CNode("torch", tmp_path, "b")
    sent = Sentinel(a.addr, peers=[], poll_s=0.1, down_after_s=30.0).start()
    cc = None
    try:
        for n in (a, b):
            n.service.ClusterSetSlot({"assign": [[0, S.NUM_SLOTS - 1, a.addr]], "epoch": 1})
        cc = ClusterClient(shards=[{"sentinels": [sent.address]}], topology_push=True)
        shard = cc._shard_clients[0]
        assert shard.address == a.addr and cc.epoch == 1
        # the subscription starts on the push thread: announce once its
        # stream is live, so that the announcement travels on that stream
        # and not on a later subscription after the loop's backoff
        assert shard.push_live.wait(15), "the shard's TopologyEvents stream went live"
        before = counters.get("client_topology_pushes")
        assert sent.handle_AnnounceTopology({"epoch": 2, "primary": b.addr,
                                             "replicas": [a.addr]})["adopted"]
        deadline = time.monotonic() + 15
        while shard.address != b.addr:
            assert time.monotonic() < deadline, "push-driven re-point"
            time.sleep(0.02)
        assert shard.epoch == 2 and counters.get("client_topology_pushes") > before
        assert cc._client_for(b.addr) is shard
    finally:
        if cc is not None:
            cc.close()
        sent.stop()
        a.close()
        b.close()


# -- the admin CLI ----------------------------------------------------------------------


def test_rebalance_cli_init_info_and_plan(tmp_path, capsys):
    a, b = CNode("torch", tmp_path, "a"), CNode("torch", tmp_path, "b")
    try:
        nodes_arg = f"{a.addr},{b.addr}"
        assert rebalance.main(["init", "--nodes", nodes_arg]) == 0
        out = json.loads(capsys.readouterr().out)
        assert out["unreachable"] == [] and out["epoch"] == 1
        assert out["assigned"] == rebalance.even_ranges([a.addr, b.addr])
        assert a.cluster.epoch() == 1 and b.cluster.epoch() == 1
        assert rebalance.main(["info", "--nodes", nodes_arg]) == 0
        views = json.loads(capsys.readouterr().out)
        assert views[a.addr]["enabled"] and views[b.addr]["enabled"]
        assert views[a.addr]["ranges"] == views[b.addr]["ranges"]
        assert rebalance.main(["rebalance", "--nodes", nodes_arg, "--plan-only"]) == 0
        plan = json.loads(capsys.readouterr().out.splitlines()[0])
        assert plan["planned_moves"] == 0
        # a slot moved by the CLI's migrate (no filter in it: marks and finalize)
        assert rebalance.main(["migrate", "--nodes", nodes_arg, "--slot", "0", "--to", b.addr]) == 0
        resp = json.loads(capsys.readouterr().out)
        assert resp["ok"] and resp["filters_moved"] == 0 and resp["epoch"] == 2
        assert a.cluster.owner(0) == b.cluster.owner(0) == b.addr
    finally:
        a.close()
        b.close()


def test_rebalance_of_a_sparse_map_moves_as_reference(tmp_path, capsys):
    """A map that assigns only a few slots (most on one node, one on a node
    outside ``--nodes``): both packages' ``rebalance --plan-only`` print the
    same plan over the same port cluster, and a port cluster and a
    ``tpubloom`` cluster given that map, each rebalanced by its own
    package's CLI, print the same moves and results and end with the same
    map on every node, node for node."""
    clusters = {pkg: [CNode(pkg, tmp_path, f"{pkg}{i}") for i in range(4)]
                for pkg in ("torch", "tpubloom")}
    try:
        ends = {}
        for pkg, nodes in clusters.items():
            addrs = [n.addr for n in nodes]
            owners = {s: addrs[0] for s in range(100, 112)}
            owners.update({s: addrs[1] for s in (5000, 5001)})
            owners[9000] = addrs[3]  # a node that leaves
            ranges = S.ranges_of(owners)
            for n in nodes:
                n.service.ClusterSetSlot({"assign": ranges, "epoch": 3})
            target = ",".join(addrs[:3])
            if pkg == "torch":
                assert rebalance.main(["rebalance", "--nodes", target, "--plan-only"]) == 0
                mine = capsys.readouterr().out
                assert jrebalance.main(["rebalance", "--nodes", target, "--plan-only"]) == 0
                assert capsys.readouterr().out == mine
                plan = json.loads(mine.splitlines()[0])
                assert plan["planned_moves"] == len(rebalance.plan_moves(owners, addrs[:3])) == 8
            cli = rebalance if pkg == "torch" else jrebalance
            rc = cli.main(["rebalance", "--nodes", target])
            lines = capsys.readouterr().out.splitlines()
            index = {addr: i for i, addr in enumerate(addrs)}
            ends[pkg] = {
                "rc": rc, "result": json.loads(lines[-1]),
                "moves": [[m[0], index[m[1]], index[m[2]]] for m in json.loads(lines[0])["moves"]],
                "views": [(n.cluster.epoch(), {s: index[a] for s, a in n.cluster.slots.owners.items()},
                           dict(n.cluster.slots.migrating), dict(n.cluster.slots.importing))
                          for n in nodes]}
            for slot, _src, dst in ends[pkg]["moves"][:-1]:
                assert ends[pkg]["views"][dst][1][slot] == dst
        assert ends["torch"]["result"]["moved"] >= 7
        for key in ("rc", "result", "moves"):
            assert ends["torch"][key] == ends["tpubloom"][key], key
        for i in range(4):
            p, j = ends["torch"]["views"][i], ends["tpubloom"]["views"][i]
            assert p[0] == j[0] and p[1] == j[1], i
            assert [sorted(x) for x in p[2:]] == [sorted(x) for x in j[2:]], i
    finally:
        for nodes in clusters.values():
            for n in nodes:
                n.close()


@pytest.mark.parametrize("module,flags", [
    ("tpubloom_torch.cluster", ("init", "info", "migrate", "rebalance")),
    ("tpubloom_torch.obs.aggregate", ("--nodes", "--once", "--port", "--timeout")),
])
def test_cli_help_without_jax(module, flags):
    """``python -m <module> --help`` names its subcommands or flags and
    imports neither jax nor ``tpubloom``, nor torch: the admin CLI and the
    scraper speak gRPC, HTTP and JSON only."""
    code = ("import runpy, sys\n"
            f"sys.argv = [{module!r}, '--help']\n"
            "try:\n"
            f"    runpy.run_module({module!r}, run_name='__main__', alter_sys=True)\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'torch')\n"
            "             or m.startswith(('jax.', 'tpubloom.', 'torch.')))\n"
            "print('FOREIGN', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO, env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    for flag in flags:
        assert flag in out.stdout
    assert "FOREIGN []" in out.stdout
