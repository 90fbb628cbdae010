"""The port's failover coordinator (``tpubloom_torch.ha.sentinel``,
``python -m tpubloom_torch.sentinel``) against ``tpubloom.ha.sentinel`` on
the CPU, and the port's client (``BloomClient(sentinels=)``,
``fetch_topology``, the ``TopologyEvents`` push) against port sentinels.

Exact: a port sentinel answers ``Ping``, ``Topology``, ``VoteDown`` and
``AnnounceTopology`` as a ``tpubloom`` sentinel does, request for request
through the vote-rule table of ``tests/test_ha.py``; ``sentinel_state.json``
written by either package loads in the other. The failover story runs
in process: a quorum of one ``tpubloom`` and two port sentinels over port
services promotes the most caught-up replica, re-points the survivor,
redirects a sentinel-resolved client and fences the restarted stale
primary; one sentinel short of the quorum never fails over. Last, a port
primary in a child process on the CPU is SIGKILLed under client load; the
port sentinels promote a replica, and a counting tenant proves zero lost
and zero doubled acknowledged writes; the restarted stale primary is
fenced."""

import os
import signal
import socket
import subprocess
import sys
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
from tpubloom.ha.sentinel import Sentinel as JSentinel
from tpubloom_torch import faults
from tpubloom_torch.ha.sentinel import Sentinel, SentinelStateStore
from tpubloom_torch.obs import blackbox, counters, flight, trace
from tpubloom_torch.repl import OpLog
from tpubloom_torch.server import protocol, service
from tpubloom_torch.server.client import BloomClient, fetch_topology

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = "127.0.0.1:1"  # a watched primary no test reaches


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


#: the vote-rule table of ``tests/test_ha.py::test_sentinel_vote_rules``
#: and its state-persistence case, as (RPC or "sdown", request): ``sdown``
#: sets the sentinel's own view of the primary
VOTE_TABLE = [
    ("Ping", {}),
    ("Topology", {}),
    ("VoteDown", {"epoch": 1, "primary": W}),  # not SDOWN: refused
    ("sdown", True),
    ("VoteDown", {"epoch": 1, "primary": "elsewhere:9"}),  # another primary
    ("VoteDown", {"epoch": 1, "primary": W}),  # granted
    ("VoteDown", {"epoch": 1, "primary": W}),  # the epoch is spent
    ("VoteDown", {"epoch": 2, "primary": W}),  # a newer one is grantable
    ("VoteDown", {}),  # no epoch, no primary
    ("AnnounceTopology", {"epoch": 2, "primary": "127.0.0.1:9",
                          "replicas": ["127.0.0.1:8"], "fenced": W}),  # not newer
    ("AnnounceTopology", {"epoch": 7, "primary": "127.0.0.1:9",
                          "replicas": ["127.0.0.1:8"], "fenced": W}),  # adopted
    ("AnnounceTopology", {"epoch": 7, "primary": "127.0.0.1:7"}),  # same epoch
    ("Topology", {}),
    ("Ping", {}),
    ("sdown", True),
    ("VoteDown", {"epoch": 7, "primary": "127.0.0.1:9"}),  # not past the topology
    ("VoteDown", {"epoch": 8, "primary": "127.0.0.1:9"}),  # granted
    ("VoteDown", {"epoch": 9, "primary": W}),  # the old primary
    ("AnnounceTopology", {"epoch": 3, "primary": W}),  # older
    ("Topology", {}),
]


def _drive(sentinel, table, mod):
    """Each request of ``table`` through the sentinel's wire handler (the
    bytes a peer sends, the bytes it answers), decoded; ``Ping``'s random
    id by its presence."""
    out = []
    for method, req in table:
        if method == "sdown":
            sentinel._sdown = req
            continue
        raw = sentinel._wrap(method)(mod.encode(req) if req else b"", None)
        resp = mod.decode(raw)
        if "sentinel_id" in resp:
            resp["sentinel_id"] = resp["sentinel_id"] == sentinel.sentinel_id
        out.append((method, resp))
    return out, (sentinel._last_vote_epoch, sorted(sentinel._fence_watch),
                 sentinel.topology.to_dict())


@pytest.mark.parametrize("state", [False, True], ids=["in_memory", "state_dir"])
def test_sentinel_answers_as_reference(state, tmp_path):
    """Request for request through the vote-rule table, a port sentinel's
    answers, its vote discipline, fence list and topology equal a
    ``tpubloom`` sentinel's; with a state dir, so do their persisted
    states after a restart."""
    from tpubloom.server import protocol as jprotocol

    def make(cls, pkg):
        kw = {"state_dir": str(tmp_path / pkg)} if state else {}
        return cls(W, peers=[], quorum=2, **kw)

    got = _drive(make(Sentinel, "torch"), VOTE_TABLE, protocol)
    want = _drive(make(JSentinel, "jax"), VOTE_TABLE, jprotocol)
    assert got == want
    answers = dict(got[0][:4])
    assert [r["granted"] for m, r in got[0] if m == "VoteDown"] == [
        False, False, True, False, True, False, False, True, False]
    assert answers["Ping"]["ok"] and not answers["VoteDown"]["granted"]
    if state:
        back = make(Sentinel, "torch").topology.to_dict()
        assert back == make(JSentinel, "jax").topology.to_dict()
        assert back["epoch"] == 7 and back["primary"] == "127.0.0.1:9"


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_sentinel_state_loads_in_either_package(writer, tmp_path):
    """``sentinel_state.json`` written by one package's sentinel restores
    the other's: topology, the spent vote and the fence list; a torn file
    reads as absent (back to ``--watch``) in both."""
    cls, other = (Sentinel, JSentinel) if writer == "torch" else (JSentinel, Sentinel)
    state = str(tmp_path / "state")
    s = cls(W, peers=[], quorum=2, state_dir=state)
    s.handle_AnnounceTopology({"epoch": 7, "primary": "127.0.0.1:9",
                               "replicas": ["127.0.0.1:8"], "fenced": W})
    s._sdown = True
    assert s.handle_VoteDown({"epoch": 8, "primary": "127.0.0.1:9"})["granted"]
    back = other(W, peers=[], quorum=2, state_dir=state)
    assert back.handle_Topology({}) == {"ok": True, "epoch": 7, "primary": "127.0.0.1:9",
                                        "replicas": ["127.0.0.1:8"]}
    assert back._last_vote_epoch == 8 and W in back._fence_watch
    back._sdown = True
    assert not back.handle_VoteDown({"epoch": 8, "primary": "127.0.0.1:9"})["granted"]
    assert back.handle_VoteDown({"epoch": 9, "primary": "127.0.0.1:9"})["granted"]
    assert SentinelStateStore(state).load()["last_vote_epoch"] == 9
    with open(SentinelStateStore(state).path, "a") as f:
        f.write("rot")
    for c in (Sentinel, JSentinel):
        fresh = c(W, peers=[], quorum=2, state_dir=state)
        assert fresh.handle_Topology({})["primary"] == W and fresh._last_vote_epoch == 0


def test_vote_fault_point_fires_before_the_vote():
    """``ha.vote`` armed: the grant path dies before the vote registers, so
    the same epoch is still grantable once disarmed, and only once."""
    s = Sentinel(W, peers=[], quorum=2)
    s._sdown = True
    faults.arm("ha.vote", "once")
    with pytest.raises(faults.InjectedFault):
        s.handle_VoteDown({"epoch": 1, "primary": W})
    assert counters.get("fault_ha_vote") >= 1
    assert s.handle_VoteDown({"epoch": 1, "primary": W})["granted"]
    assert not s.handle_VoteDown({"epoch": 1, "primary": W})["granted"]


def test_client_sentinel_paths(tmp_path):
    """The copied client against a port sentinel watching a live port
    primary: ``fetch_topology``, a sentinel-resolved ``BloomClient``, the
    ``TopologyEvents`` push re-pointing it on an announced topology, and
    ``refresh_topology``; no sentinel reachable is ``NO_TOPOLOGY``."""
    assert fetch_topology(["127.0.0.1:1"], timeout=0.3) is None
    with pytest.raises(protocol.BloomServiceError, match="NO_TOPOLOGY"):
        BloomClient(sentinels=["127.0.0.1:1"])
    p = Node("torch", tmp_path, "p")
    q = Node("torch", tmp_path, "q")
    s = Sentinel(p.addr, peers=[], quorum=1, poll_s=0.05).start()
    c = None
    try:
        topo = fetch_topology([s.address])
        assert topo == {"ok": True, "epoch": 0, "primary": p.addr, "replicas": []}
        c = BloomClient(sentinels=[s.address])
        assert c.address == p.addr
        c.create_filter("f", capacity=1000, error_rate=0.01)
        assert c.enable_topology_push()
        q.service.adopt_epoch(3)
        resp = s.handle_AnnounceTopology({"epoch": 3, "primary": q.addr, "replicas": []})
        assert resp == {"ok": True, "adopted": True, "epoch": 3}
        _wait(lambda: c.address == q.addr, msg="the push re-points the client")
        assert c.epoch == 3 and counters.get("client_topology_pushes") >= 1
        assert not c.refresh_topology()  # the push got there first
        c.create_filter("g", capacity=1000, error_rate=0.01)
        assert "g" in q.service._filters and "g" not in p.service._filters
    finally:
        if c is not None:
            c.close()
        s.stop()
        q.close()
        p.close()


def _quorum(watch, classes, **kw):
    """A sentinel of each class, peered with the others, quorum 2."""
    defaults = dict(poll_s=0.1, down_after_s=0.5, failover_cooldown_s=0.5)
    defaults.update(kw)
    sents = [cls(watch, peers=[], **defaults) for cls in classes]
    for s in sents:
        s.peers.extend(x.address for x in sents if x is not s)
        s.quorum = 2
    for s in sents:
        s.start()
    return sents


def test_sentinel_quorum_fails_over_in_process(tmp_path):
    """One ``tpubloom`` and two port sentinels over port services: SDOWN to
    ODOWN by vote, the most caught-up replica promoted, the lagging
    survivor re-pointed (a partial resync through the alias), a
    sentinel-resolved client redirected, and the restarted stale primary
    fenced to a replica at the new epoch, its writes READONLY."""
    rng = np.random.default_rng(44)
    p = Node("torch", tmp_path, "p")
    r1 = Node("torch", tmp_path, "r1", upstream=p, chained=True)
    r2 = Node("torch", tmp_path, "r2", upstream=p, chained=True)
    sents, back = [], None
    try:
        ks = keys(rng, 200)
        with p.client() as pc:
            pc.create_filter("cnt", capacity=20_000, error_rate=0.01, counting=True)
            pc.insert_batch("cnt", ks)
            r1.sync(p)
            r2.sync(p)
            sents = _quorum(p.addr, [JSentinel, Sentinel, Sentinel])
            _wait(lambda: all(len(s.handle_Topology({})["replicas"]) == 2 for s in sents),
                  msg="replica discovery")
            r2.applier.stop()  # r2 lags: the pick must be r1
            fresh = keys(rng, 40)
            pc.insert_batch("cnt", fresh)
            r1.sync(p)
        p.server.stop(grace=None)  # the primary dies
        _wait(lambda: any(s.failovers for s in sents), timeout=25, msg="failover")
        time.sleep(1.0)  # a dueling second election would land here
        assert sum(s.failovers for s in sents) == 1
        leader = next(s for s in sents if s.failovers)
        topo = leader.handle_Topology({})
        assert topo["primary"] == r1.addr, "promoted a lagging replica"
        assert not r1.service.read_only and r1.service.epoch == topo["epoch"]
        _wait(lambda: all(s.handle_Topology({})["primary"] == r1.addr for s in sents),
              msg="the quorum agrees")
        with BloomClient(sentinels=[s.address for s in sents], max_retries=3,
                         backoff_base=0.05) as c:
            c.insert_batch("cnt", [b"post-failover-k1"])
            assert c.address == r1.addr and c.epoch == topo["epoch"]
        survivor = r2.service.replica_applier
        assert survivor is not None and survivor is not r2.applier
        assert survivor.wait_for_seq(r1.service.oplog.last_seq, 30), survivor.status()
        assert survivor.partial_syncs >= 1 and survivor.full_syncs == 0, survivor.status()
        assert_same_filters(r1.service, r2.service)
        # the old primary restarts from its log on its old port (stale epoch)
        back_log = OpLog(p.log.directory)
        back = service.BloomService(sink_factory=lambda c: None, oplog=back_log, device="cpu")
        back.replay_oplog()
        back.listen_address = p.addr
        back_srv, back_port = service.build_server(back, p.addr)
        assert back_port == p.port
        back_srv.start()
        assert not back.read_only and back.epoch == 0
        _wait(lambda: back.read_only, timeout=20, msg="fencing")
        with BloomClient(p.addr, max_retries=0) as fc:
            h = fc.health()
            assert h["role"] == "replica" and h["epoch"] == topo["epoch"]
            with pytest.raises(protocol.BloomServiceError, match="READONLY"):
                fc._call_once("InsertBatch", {"name": "cnt", "keys": [b"stale-write-0001"]})
        assert back.replica_applier.wait_for_seq(r1.service.oplog.last_seq, 30), \
            back.replica_applier.status()
        assert_same_filters(r1.service, back)
        back.replica_applier.stop()
        back_srv.stop(grace=None)
        back.shutdown()
        back_log.close()
    finally:
        for s in sents:
            s.stop()
        for n in (r2, r1, p):
            n.close()


def test_sentinel_without_quorum_never_fails_over(tmp_path):
    """One vote of a required two never promotes: a partitioned minority
    sentinel cannot split the deployment's brain."""
    p = Node("torch", tmp_path, "p")
    r1 = Node("torch", tmp_path, "r1", upstream=p, chained=True)
    lone = Sentinel(p.addr, peers=["127.0.0.1:1"], quorum=2, poll_s=0.1,
                    down_after_s=0.3, failover_cooldown_s=0.3).start()
    try:
        _wait(lambda: len(lone.handle_Topology({})["replicas"]) == 1, msg="discovery")
        p.server.stop(grace=None)
        time.sleep(3.0)  # several elections' worth
        assert lone.failovers == 0 and lone._sdown
        assert r1.service.read_only, "promoted without a quorum"
        assert lone.handle_Topology({})["primary"] == p.addr
    finally:
        lone.stop()
        r1.close()
        p.close()


def test_sentinel_cli_help():
    """``python -m tpubloom_torch.sentinel --help`` names its flags and
    imports neither jax nor ``tpubloom``."""
    code = ("import runpy, sys\n"
            "sys.argv = ['tpubloom_torch.sentinel', '--help']\n"
            "try:\n"
            "    runpy.run_module('tpubloom_torch.sentinel', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'tpubloom.')))\n"
            "print('FOREIGN', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO, env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    for flag in ("--watch", "--peers", "--quorum", "--down-after", "--poll", "--state-dir"):
        assert flag in out.stdout
    assert "FOREIGN []" in out.stdout


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_failover_sigkill_of_a_port_primary(tmp_path):
    """A port primary in a child process (``python -m tpubloom_torch.server
    --device cpu``) is SIGKILLed under client load. The port sentinels
    promote a replica and the client completes every batch through its
    sentinel view. Every acknowledged ``cnt`` batch re-driven with its
    original rid: every key present, and one delete a batch empties the
    tenant (zero lost, zero doubled). The restarted stale primary is
    fenced to a replica at the new epoch."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    args = [sys.executable, "-m", "tpubloom_torch.server", str(port), "--device", "cpu",
            "--repl-log-dir", str(tmp_path / "primary-log")]
    proc = subprocess.Popen(args, stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT, env=env)
    boot = BloomClient(f"127.0.0.1:{port}")
    sents, reps, proc2 = [], [], None
    try:
        boot.wait_ready(timeout=120)
        boot.create_filter("cnt", capacity=50_000, error_rate=0.01, counting=True)

        class Upstream:
            addr = f"127.0.0.1:{port}"

        reps = [Node("torch", tmp_path, f"r{i}", upstream=Upstream, chained=True)
                for i in (1, 2)]
        sents = _quorum(Upstream.addr, [Sentinel, Sentinel, Sentinel])
        _wait(lambda: len(sents[0].handle_Topology({})["replicas"]) == 2, msg="discovery")
        client = BloomClient(sentinels=[s.address for s in sents], max_retries=8,
                             backoff_base=0.1, backoff_max=1.0, breaker_threshold=0)
        batches = [[b"acc-%03d-%08d" % (i, j) for j in range(20)] for i in range(30)]
        acked, errors, killed = [], [], threading.Event()

        def writer():
            for i, ks in enumerate(batches):
                if i == 8:
                    killed.set()
                try:
                    client.insert_batch("cnt", ks)
                    acked.append((i, client.last_rid))
                    continue
                except Exception as e:  # noqa: BLE001
                    errors.append((i, repr(e)))
                rid = client.last_rid  # re-drive the logical call, same rid
                while True:
                    try:
                        client.refresh_topology()
                        client._call_once("InsertBatch", {"name": "cnt", "keys": ks, "rid": rid})
                        acked.append((i, rid))
                        break
                    except Exception as e:  # noqa: BLE001
                        errors.append((i, repr(e)))
                        if len(errors) > 300:
                            raise
                        time.sleep(0.2)

        t = threading.Thread(target=writer, daemon=True)
        t.start()
        assert killed.wait(60), f"the writer never reached the kill point: {errors[:3]}"
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
        t.join(timeout=120)
        assert not t.is_alive(), f"writer wedged: {len(acked)} acked, {errors[-3:]}"
        assert len(acked) == len(batches), errors[-3:]
        topo = fetch_topology([s.address for s in sents])
        assert topo is not None and topo["primary"] != Upstream.addr
        assert client.address == topo["primary"]
        with BloomClient(topo["primary"]) as redrive:
            for i, rid in acked:
                redrive._call_once("InsertBatch", {"name": "cnt", "keys": batches[i], "rid": rid})
            every = [k for b in batches for k in b]
            assert redrive.include_batch("cnt", every).all(), "acknowledged writes lost"
            for i, _ in acked:
                redrive.delete_batch("cnt", batches[i])
            assert not redrive.include_batch("cnt", every).any(), "acknowledged writes doubled"
        client.close()
        proc2 = subprocess.Popen(args, stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT,
                                 env=env)
        with BloomClient(Upstream.addr, max_retries=0) as probe:
            probe.wait_ready(timeout=120)
            _wait(lambda: probe.health()["role"] == "replica", timeout=30, msg="fencing")
            assert probe.health()["epoch"] == topo["epoch"]
            with pytest.raises(protocol.BloomServiceError, match="READONLY"):
                probe._call_once("InsertBatch", {"name": "cnt", "keys": [b"stale-write-0001"]})
    finally:
        for pr in (proc, proc2):
            if pr is not None and pr.poll() is None:
                pr.send_signal(signal.SIGTERM)
                try:
                    pr.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    pr.kill()
        for s in sents:
            s.stop()
        for n in reps:
            n.close()
        boot.close()


def test_vote_granted_while_probing_holds_the_election_back():
    """A sentinel that grants a peer's vote after its monitor tick decided
    to run, while it probes the replicas for a finished failover, starts no
    election of its own: the peer leads this failover, and a second
    election at the next epoch could win too and promote a second time."""
    s = Sentinel(W, peers=[], quorum=2)
    s._sdown = True
    grants = []

    def probe():
        grants.append(s.handle_VoteDown({"epoch": 1, "primary": W, "candidate": "peer"}))
        return False

    s._adopt_completed_failover = probe
    s._attempt_failover()
    assert grants[0]["granted"]
    assert s._last_vote_epoch == 1 and s.last_election_rid is None
    # once the hold-off has passed, the sentinel runs its own election
    s._granted_at -= 3600
    s._attempt_failover()
    assert s._last_vote_epoch == 2 and s.last_election_rid.startswith("election-2-")
