"""High availability of the port's server (``tpubloom_torch.ha.promotion``
behind ``Promote`` / ``ReplicaOf`` and ``python -m tpubloom_torch.server
promote``) against ``tpubloom.ha`` on the CPU.

Exact (tolerance 0): the answers of ``Promote`` and ``ReplicaOf`` and the
role and epoch they leave, case for case, on a primary, a chained replica
and a bare one, with no epoch, the current one, a newer and an older one;
a failover across the two packages in both directions, where the promoted
node and its re-pointed survivor hold the old primary's words and the
survivor resumes by a partial resync through the promoted node's alias.
The rest holds the port to ``tests/test_ha.py``'s contracts: bare and
chained promotion, a demotion under coalesced writes that keeps every
acknowledged write in the log, a paged tenant's applied seq counted by a
bare replica's fresh log, the ``ha.promote`` fault point and the
``promote`` subcommand. Filters are small (m <= 2^16, batches of a few
hundred 16-byte keys made with numpy from a seed)."""

import threading
import time

import numpy as np
import pytest

from tests.test_torch_repl import assert_same_filters, keys
from tests.test_torch_repl_stream import Node, _wait
from tpubloom import faults as jfaults
from tpubloom.obs import blackbox as jblackbox
from tpubloom.obs import flight as jflight
from tpubloom.obs import trace as jtrace
from tpubloom.server import protocol as jprotocol
from tpubloom.server import service as jservice
from tpubloom.storage import StorageConfig as JStorageConfig
from tpubloom_torch import faults
from tpubloom_torch.ha import EpochStore
from tpubloom_torch.obs import blackbox, counters, flight, trace
from tpubloom_torch.server import ingest, protocol, service
from tpubloom_torch.server.client import BloomClient
from tpubloom_torch.storage import StorageConfig

#: epoch the primary holds before its replicas attach (they adopt it at
#: their full resync): "older", "current" and "newer" are relative to it
EPOCH = 2
EPOCHS = {None: None, "older": EPOCH - 1, "current": EPOCH, "newer": EPOCH + 1}


@pytest.fixture(autouse=True)
def port_globals():
    """Both packages' process-global fault points and observability rings
    start and end each test reset: a `tpubloom` replica with a log dir
    arms its package's black box, which later tests expect off."""
    faults.reset()
    jfaults.reset()
    blackbox.reset_for_tests()
    yield
    faults.reset()
    jfaults.reset()
    for mod in (trace, flight, blackbox, counters, jtrace, jflight, jblackbox):
        mod.reset_for_tests()


def _fill(node, rng, n=200):
    """The same creates and (``n`` > 0) writes on either package's primary
    (the seqs they mint are equal): a blocked filter and a counting one."""
    svc = node.service
    svc.CreateFilter({"name": "f", "config": {"m": 1 << 16, "k": 7, "key_len": 16,
                                              "block_bits": 512, "block_hash": "chunk"}})
    svc.CreateFilter({"name": "cnt", "capacity": 3000, "error_rate": 0.01,
                      "options": {"counting": True, "key_len": 16}})
    for name in ("f", "cnt") if n else ():
        svc.InsertBatch({"name": name, "keys": keys(rng, n)})


def _answer(svc, method, req):
    """A handler's answer, or its error as ``(code, message, details)``."""
    try:
        return getattr(svc, method)(dict(req))
    except (protocol.BloomServiceError, jprotocol.BloomServiceError) as e:
        return ("error", e.code, e.message, e.details)


def _labelled(resp, labels):
    """Addresses and log ids named by role, so two packages' answers
    compare field for field."""
    if not isinstance(resp, dict):
        return resp
    return {k: labels.get(v, v) if isinstance(v, str) else v for k, v in resp.items()}


#: (target, RPC, epoch): a primary with a chained replica, that replica, a
#: bare replica (no op log); "ReplicaOf" demotes to (or, on the replica,
#: re-points at) the target's upstream; "NO ONE" promotes through ReplicaOf
ANSWER_CASES = [
    ("primary", "Promote", None), ("primary", "Promote", "current"),
    ("primary", "Promote", "newer"), ("primary", "Promote", "older"),
    ("primary", "NO ONE", None), ("primary", "NO ONE", "newer"),
    ("primary", "ReplicaOf", None), ("primary", "ReplicaOf", "older"),
    ("replica", "Promote", None), ("replica", "Promote", "current"),
    ("replica", "Promote", "newer"), ("replica", "Promote", "older"),
    ("replica", "NO ONE", None), ("replica", "ReplicaOf", "current"),
    ("bare", "Promote", None), ("bare", "Promote", "log_dir"),
]


def _answer_case(pkg, tmp_path, target, rpc, epoch):
    rng = np.random.default_rng(16)
    d = tmp_path / pkg
    d.mkdir()
    p = Node(pkg, d, "p")
    r = None
    try:
        p.service.adopt_epoch(EPOCH)
        _fill(p, rng, 0)  # the seqs matter here, not the keys
        r = Node(pkg, d, "r", upstream=p, chained=target != "bare")
        r.sync(p)
        assert r.service.epoch == EPOCH
        node = p if target == "primary" else r
        labels = {p.addr: "P", r.addr: "R", p.log.log_id: "P-log"}
        if r.log is not None:
            labels[r.log.log_id] = "R-log"
        req = {}
        if epoch == "log_dir":
            req["repl_log_dir"] = str(d / "adopted")
        elif EPOCHS[epoch] is not None:
            req["epoch"] = EPOCHS[epoch]
        if rpc == "Promote":
            method = "Promote"
        else:
            method = "ReplicaOf"
            req["primary"] = "NO ONE" if rpc == "NO ONE" else (
                "127.0.0.1:1" if target == "primary" else p.addr)
        resp = _answer(node.service, method, req)
        if node.service.oplog is not None:
            labels.setdefault(node.service.oplog.log_id, "adopted-log")
        app = node.service.replica_applier
        state = {"read_only": node.service.read_only, "epoch": node.service.epoch,
                 "primary": labels.get(node.service.primary_address, node.service.primary_address),
                 "applier": None if app is None else labels.get(app.primary_address,
                                                                app.primary_address),
                 "log_seq": None if node.service.oplog is None else node.service.oplog.last_seq}
        return _labelled(resp, labels), state
    finally:
        if r is not None:
            r.close()
        p.close()


@pytest.mark.parametrize("target,rpc,epoch", ANSWER_CASES)
def test_promote_and_replicaof_answer_as_reference(target, rpc, epoch, tmp_path):
    """``Promote`` and ``ReplicaOf`` answer as ``tpubloom``'s, field for
    field (log ids and addresses by role), and leave the same role, epoch,
    upstream and log head."""
    got = _answer_case("torch", tmp_path, target, rpc, epoch)
    want = _answer_case("jax", tmp_path, target, rpc, epoch)
    assert got == want


@pytest.mark.parametrize("primary_pkg,promoted_pkg", [("jax", "torch"), ("torch", "jax")])
def test_failover_across_packages(primary_pkg, promoted_pkg, tmp_path):
    """A chained replica of the other package is promoted after its primary
    stops; the survivor (the primary's package) re-points with
    ``ReplicaOf`` and resumes by a PARTIAL resync through the alias; every
    filter's words equal across the three nodes (tolerance 0)."""
    rng = np.random.default_rng(61)
    p = Node(primary_pkg, tmp_path, "p")
    r1 = r2 = None
    try:
        _fill(p, rng)
        r1 = Node(promoted_pkg, tmp_path, "r1", upstream=p, chained=True)
        r2 = Node(primary_pkg, tmp_path, "r2", upstream=p, chained=True)
        p.service.InsertBatch({"name": "cnt", "keys": keys(rng, 100)})
        r1.sync(p)
        r2.sync(p)
        p.server.stop(grace=None)  # the primary dies
        resp = r1.service.Promote({})
        assert resp["ok"] and not resp["already_primary"] and resp["epoch"] == 1
        assert resp["adopted_seq"] == p.log.last_seq
        assert_same_filters(p.service, r1.service)
        old = r2.service.replica_applier
        r2.service.ReplicaOf({"primary": r1.addr, "epoch": 1})
        survivor = r2.service.replica_applier
        assert survivor is not old
        more = keys(rng, 150)
        with r1.client() as c:
            c.insert_batch("f", more)
            c.insert_batch("cnt", more)
            c.delete_batch("cnt", more[:50])
        assert survivor.wait_for_seq(r1.service.oplog.last_seq, 30), survivor.status()
        assert survivor.partial_syncs >= 1 and survivor.full_syncs == 0, survivor.status()
        assert_same_filters(r1.service, r2.service)
        p.service.InsertBatch({"name": "f", "keys": more})
        p.service.InsertBatch({"name": "cnt", "keys": more})
        p.service.DeleteBatch({"name": "cnt", "keys": more[:50]})
        assert_same_filters(p.service, r2.service)
    finally:
        for n in (r2, r1):
            if n is not None:
                n.close()
        p.close()


@pytest.mark.parametrize("kind", ["bare", "chained"])
def test_promotion_adopts_the_log(kind, tmp_path):
    """``tests/test_ha.py``'s bare and chained promotions on the port: a
    bare replica needs a log dir (``NO_LOG_DIR``), opens a fresh log at
    its applied seq and seeds the manifest; a chained one adopts its own
    log. Either way the epoch persists beside the log, writes land in the
    adopted seq space, a re-promote is idempotent and a stale pin answers
    ``STALE_EPOCH``; the old primary's other replica partial-resyncs
    through the alias and counts stay exactly once."""
    rng = np.random.default_rng(7)
    p = Node("torch", tmp_path, "p")
    r = Node("torch", tmp_path, "r", upstream=p, chained=kind == "chained")
    sib = Node("torch", tmp_path, "sib", upstream=p)
    rc, pc = r.client(), p.client()
    try:
        ks = keys(rng, 200)
        pc.create_filter("cnt", capacity=20_000, error_rate=0.01, counting=True)
        pc.insert_batch("cnt", ks)
        r.sync(p)
        sib.sync(p)
        if kind == "bare":
            with pytest.raises(protocol.BloomServiceError, match="NO_LOG_DIR"):
                rc.promote()
            adopt_dir = str(tmp_path / "adopted")
            resp = rc.promote(repl_log_dir=adopt_dir)
            assert r.service.oplog.directory == adopt_dir
            assert "cnt" in r.service._manifest_read()
        else:
            resp = rc.promote()
            assert r.service.oplog is r.log
        assert resp["epoch"] == 1 and not resp["already_primary"]
        assert resp["adopted_seq"] == p.log.last_seq
        assert EpochStore(r.service.oplog.directory).load() == 1
        h = rc.health()
        assert h["role"] == "primary" and h["epoch"] == 1
        rc.insert_batch("cnt", [b"after-promotion!"])
        assert r.service.oplog.last_seq == p.log.last_seq + 1
        assert rc.promote()["already_primary"]
        with pytest.raises(protocol.BloomServiceError, match="STALE_EPOCH"):
            rc._call_once("Promote", {"epoch": 0})
        sc = sib.client()
        sc.replica_of(r.addr, epoch=1)
        new = sib.service.replica_applier
        assert new is not sib.applier
        assert new.wait_for_seq(r.service.oplog.last_seq, 30), new.status()
        assert new.partial_syncs >= 1 and new.full_syncs == 0, new.status()
        assert sc.include("cnt", b"after-promotion!")
        rc.delete_batch("cnt", ks)
        assert new.wait_for_seq(r.service.oplog.last_seq, 30)
        for cl in (rc, sc):
            assert not cl.include_batch("cnt", ks).any(), "records applied twice"
        sc.close()
        assert_same_filters(r.service, sib.service)
    finally:
        rc.close()
        pc.close()
        for n in (sib, r, p):
            n.close()


def test_demotion_with_coalesced_writes_keeps_every_acked_write(tmp_path):
    """A live primary demoted while writers are parked in the ingest
    coalescer (a long flush deadline keeps them there): every write a
    client saw acknowledged is a record of the log the new applier takes
    over. Without the demotion barrier's coalescer leg, the parked
    requests would flush after the applier owns the log: applied and
    acknowledged, but never logged."""
    from tpubloom_torch.ha.promotion import become_replica

    p = Node("torch", tmp_path, "p",
             coalesce=ingest.CoalesceConfig(max_keys=64, max_wait_us=100_000))
    acked: list = []
    stop = threading.Event()

    def writer(t):
        with p.client(max_retries=0) as c:
            i = 0
            while not stop.is_set():
                key = b"w%02d-%012d" % (t, i)
                try:
                    c.insert_batch("d", [key])
                except Exception:  # noqa: BLE001 — the READONLY fence
                    return
                acked.append(key)
                i += 1

    try:
        with p.client() as c:
            c.create_filter("d", capacity=50_000, error_rate=0.01)
        threads = [threading.Thread(target=writer, args=(t,), daemon=True) for t in range(4)]
        for th in threads:
            th.start()
        _wait(lambda: len(acked) > 8, msg="writers warm")
        co = p.service._coalescer
        _wait(lambda: sum(len(v) for v in list(co._groups.values())) >= 2, msg="writes parked")
        flushes = p.service.metrics.snapshot()["counters"].get("ingest_flushes", 0)
        become_replica(p.service, "127.0.0.1:1")
        stop.set()
        for th in threads:
            th.join(timeout=30)
        assert flushes > 0, "the writes went through the coalescer"
        logged = {k for rec in p.log.read_from(0) if rec["method"] == "InsertBatch"
                  for k in rec["req"]["keys"]}
        missing = [k for k in acked if k not in logged]
        assert not missing, f"{len(missing)} acked write(s) not in the log, e.g. {missing[:3]}"
        assert p.service.read_only and p.service.replica_applier is not None
    finally:
        stop.set()
        p.close()


def _paged_case(pkg, tmp_path):
    """A bare replica on a one-tenant budget whose PAGED tenant holds the
    highest applied seq (records applied without an applier, so its
    cursor does not cover them): promotion's fresh log must start there."""
    rng = np.random.default_rng(23)
    d = tmp_path / pkg
    d.mkdir()
    p = Node(pkg, d, "p")
    try:
        for name in ("a", "b"):
            p.service.CreateFilter({"name": name, "config": {"m": 1 << 14, "k": 5, "key_len": 16,
                                                             "block_bits": 512}})
        p.service.InsertBatch({"name": "a", "keys": keys(rng, 50)})
        p.service.InsertBatch({"name": "b", "keys": keys(rng, 50)})
        records = list(p.log.read_from(0))
    finally:
        p.close()
    torch_pkg = pkg == "torch"
    svc_mod = service if torch_pkg else jservice
    storage = (StorageConfig if torch_pkg else JStorageConfig)(max_resident_filters=1)
    kw = {"device": "cpu"} if torch_pkg else {}
    r = svc_mod.BloomService(sink_factory=lambda c: None, read_only=True, storage=storage, **kw)
    try:
        for rec in records:
            r.apply_record(rec)
        r.QueryBatch({"name": "a", "keys": [b"x" * 16]})  # hydrates a, pages out b
        paged = sorted(n for n in ("a", "b") if n not in r._filters)
        resp = r.Promote({"repl_log_dir": str(d / "adopted")})
        resp["log_id"] = resp["log_id"] == r.oplog.log_id
        out = (paged, r.storage.max_applied_seq(), resp, r.oplog.last_seq,
               sorted(r._manifest_read()))
        r.oplog.close()
        return out, records[-1]["seq"]
    finally:
        r.shutdown()


def test_promotion_counts_a_paged_tenants_applied_seq(tmp_path):
    """With ``StorageConfig``, a bare replica's promotion adopts the paged
    tenant's applied seq (``TenantStore.max_applied_seq``), answers as
    ``tpubloom`` does, and its manifest names the paged tenant too."""
    got, last = _paged_case("torch", tmp_path)
    want, _ = _paged_case("jax", tmp_path)
    assert got == want
    paged, max_paged, resp, _, manifest = got
    assert paged == ["b"] and max_paged == last
    assert resp["adopted_seq"] == last and manifest == ["a", "b"]


def test_promote_fault_point_aborts_cleanly(tmp_path):
    """``ha.promote`` armed: the promotion aborts before any state changes
    (still a fenced replica at its epoch); disarmed, it promotes."""
    rng = np.random.default_rng(5)
    p = Node("torch", tmp_path, "p")
    r = Node("torch", tmp_path, "r", upstream=p, chained=True)
    rc = r.client()
    try:
        _fill(p, rng, 50)
        r.sync(p)
        faults.arm("ha.promote", "always")
        with pytest.raises(protocol.BloomServiceError, match="INTERNAL"):
            rc.promote()
        assert counters.get("fault_ha_promote") >= 1
        assert rc.health()["role"] == "replica" and r.service.read_only and r.service.epoch == 0
        with pytest.raises(protocol.BloomServiceError, match="READONLY"):
            rc._call_once("InsertBatch", {"name": "cnt", "keys": [b"fenced" * 3]})
        faults.disarm("ha.promote")
        resp = rc.promote()
        assert resp["ok"] and not resp["already_primary"]
        rc.insert_batch("cnt", [b"post-promotion-k"])
        assert rc.include("cnt", b"post-promotion-k")
    finally:
        rc.close()
        r.close()
        p.close()


def test_promote_subcommand(tmp_path, capsys):
    """``python -m tpubloom_torch.server promote ADDR`` sends ``Promote``
    and prints its answer (the reference's ``_promote_main``)."""
    rng = np.random.default_rng(9)
    p = Node("torch", tmp_path, "p")
    r = Node("torch", tmp_path, "r", upstream=p, chained=True)
    try:
        _fill(p, rng, 20)
        r.sync(p)
        with pytest.raises(SystemExit) as e:
            service.main(["promote", r.addr, "--epoch", "4"])
        assert e.value.code == 0
        out = capsys.readouterr().out
        assert '"epoch": 4' in out and '"already_primary": false' in out
        assert r.service.read_only is False and r.service.epoch == 4
    finally:
        r.close()
        p.close()
