"""Tenant residency of the port's server (``tpubloom_torch.storage``)
against ``tpubloom`` on the CPU: the counterparts of
``tests/test_storage.py`` at small sizes.

Every test ends with every tenant's config and state bytes (read without
hydrating it: ``TenantStore.peek_blob``) equal to those of a reference
``tpubloom`` service, without residency, fed the same operations
(tolerance 0). Counting filters prove exactly once: one delete round
empties what one insert round put in, across evictions and hydrations.
``_device_bytes`` is checked for every kind the port serves, and an
evicted tenant's tensors must be freed. The module runs under the port's
armed lock tracker (``tpubloom_torch.utils.locks``) and fails on any
violation (a block under ``storage.state``, for one). One subprocess test:
SIGKILL during eviction churn on ``python -m tpubloom_torch.server
--device cpu``."""

import gc
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import weakref

import numpy as np
import pytest

from tests.test_torch_repl import payload
from tpubloom.server import service as jservice
from tpubloom_torch import checkpoint as ck
from tpubloom_torch import faults
from tpubloom_torch.obs import blackbox, counters, flight, trace
from tpubloom_torch.repl import OpLog
from tpubloom_torch.server import protocol, service
from tpubloom_torch.server.client import BloomClient
from tpubloom_torch.storage import StorageConfig
from tpubloom_torch.storage.residency import _device_bytes
from tpubloom_torch.utils import locks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def port_lock_check():
    locks.set_enabled(True)
    locks.reset()
    yield
    vios = list(locks.violations())
    locks.set_enabled(None)
    assert not vios, vios


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


class Pair:
    """A port server with residency (gRPC) and a reference service without
    it; :meth:`both` sends one request to each."""

    def __init__(self, tmp_path, *, oplog=False, sub="", **storage_kw):
        self.ckpt_dir = str(tmp_path / f"ckpt{sub}")
        kw = {}
        if oplog:
            # small segments, so whole-segment truncation has work to do
            kw["oplog"] = OpLog(str(tmp_path / f"oplog{sub}"), segment_bytes=512)
        self.service = service.BloomService(
            sink_factory=lambda c: ck.FileSink(self.ckpt_dir),
            storage=StorageConfig(**storage_kw), device="cpu", **kw)
        self.server, port = service.build_server(self.service, "127.0.0.1:0")
        self.server.start()
        self.addr = f"127.0.0.1:{port}"
        self.ref = jservice.BloomService(sink_factory=lambda c: None)

    def client(self, **kw) -> BloomClient:
        return BloomClient(self.addr, **kw)

    def both(self, method, req):
        self.ref_only(method, req)
        return getattr(self.service, method)(dict(req))

    def ref_only(self, method, req):
        return getattr(self.ref, method)(dict(req))

    def assert_tenants_equal(self):
        assert_tenants_equal(self.service, self.ref)

    def stop(self):
        self.server.stop(grace=None)
        self.service.shutdown()
        self.ref.shutdown()
        if self.service.oplog is not None:
            self.service.oplog.close()


def assert_tenants_equal(svc, ref):
    """Every tenant of the paged port service, resident or not, against the
    reference service's filter of that name."""
    assert sorted(svc.storage.names()) == sorted(ref._filters)
    for name in ref._filters:
        blob, _ = svc.storage.peek_blob(name)
        got = payload(ck.restore_blob(bytes(blob), device="cpu"))
        assert got == payload(ref._filters[name].filter), name


def create(name, *, counting=False, capacity=5000):
    return {"name": name, "capacity": capacity, "error_rate": 0.01,
            "options": {"counting": counting}}


def hits(resp) -> np.ndarray:
    return np.unpackbits(np.frombuffer(resp["hits"], np.uint8), count=resp["n"]).astype(bool)


def _hits(client, name, keys):
    return np.asarray(client.include_batch(name, keys), dtype=bool)


def test_round_robin_through_small_budget(tmp_path):
    s = Pair(tmp_path, max_resident_filters=3)
    try:
        names = [f"rr-{i}" for i in range(8)]
        with s.client() as c:
            for n in names:
                c.create_filter(n, capacity=5000, error_rate=0.01)
                s.ref_only("CreateFilter", create(n))
            for rnd in range(2):
                for n in names:
                    ks = [b"%s-%d" % (n.encode(), rnd)]
                    assert c.insert_batch(n, ks) == 1
                    s.ref_only("InsertBatch", {"name": n, "keys": ks})
            for rnd in range(2):
                for n in names:
                    assert _hits(c, n, [b"%s-%d" % (n.encode(), rnd)]).all()
            assert counters.get("storage_hydrations_total") > 0
            assert counters.get("storage_evictions_total") > 0
            assert len(s.service._filters) <= 3
            assert s.service.metrics.hydrations.n > 0
            assert set(c.list_filters()) >= set(names)
            h = c.health()
            assert h["storage"]["tenants"] == 8 and h["storage"]["resident"] <= 3
        s.assert_tenants_equal()
    finally:
        s.stop()


def test_counting_exactly_once_across_paging(tmp_path):
    s = Pair(tmp_path, max_resident_filters=2)
    try:
        ks = [b"eo-%d" % i for i in range(50)]
        with s.client() as c:
            c.create_filter("cnt", capacity=5000, error_rate=0.01, counting=True)
            s.ref_only("CreateFilter", create("cnt", counting=True))
            assert c.insert_batch("cnt", ks) == 50
            s.ref_only("InsertBatch", {"name": "cnt", "keys": ks})
            for i in range(4):
                fill = [b"fx-%d-%d" % (i, j) for j in range(80)]
                c.create_filter(f"fill-{i}", capacity=5000, error_rate=0.01)
                c.insert_batch(f"fill-{i}", fill)
                s.ref_only("CreateFilter", create(f"fill-{i}"))
                s.ref_only("InsertBatch", {"name": f"fill-{i}", "keys": fill})
            assert "cnt" not in s.service._filters
            s.assert_tenants_equal()  # cnt paged out, its bytes intact
            assert _hits(c, "cnt", ks).all()
            assert c.delete_batch("cnt", ks) == 50
            s.ref_only("DeleteBatch", {"name": "cnt", "keys": ks})
            assert not _hits(c, "cnt", ks).any()
        s.assert_tenants_equal()
    finally:
        s.stop()


def test_cold_tier_roundtrip(tmp_path):
    """A warm pool of one byte demotes every eviction to COLD: hydration
    restores from the checkpoint sink, not host RAM."""
    s = Pair(tmp_path, max_resident_filters=2, warm_pool_bytes=1)
    try:
        with s.client() as c:
            s.both("CreateFilter", create("cold-a", counting=True))
            s.both("InsertBatch", {"name": "cold-a", "keys": [b"ca-1", b"ca-2"]})
            for i in range(3):
                s.both("CreateFilter", create(f"cb-{i}"))
                s.both("InsertBatch", {"name": f"cb-{i}",
                                       "keys": [b"y-%d-%d" % (i, j) for j in range(10)]})
            assert "cold-a" not in s.service._filters
            assert s.service.storage.summary()["cold"] >= 1
            assert counters.get("storage_warm_demotions") > 0
            s.assert_tenants_equal()  # read from the sink
            assert _hits(c, "cold-a", [b"ca-1", b"ca-2"]).all()
            assert c.delete_batch("cold-a", [b"ca-1", b"ca-2"]) == 2
            s.ref_only("DeleteBatch", {"name": "cold-a", "keys": [b"ca-1", b"ca-2"]})
            assert not _hits(c, "cold-a", [b"ca-1", b"ca-2"]).any()
        s.assert_tenants_equal()
    finally:
        s.stop()


def test_hydrate_under_concurrent_load_exactly_once(tmp_path):
    """Writers and churners race the eviction/hydration cycle: no request
    errs, every acked write serves exactly once."""
    s = Pair(tmp_path, max_resident_filters=2, hydration_max_concurrent=16)
    try:
        s.both("CreateFilter", create("hot", counting=True))
        for i in range(3):
            s.both("CreateFilter", create(f"churn-{i}"))
        acked, churned, errors = [], [], []
        lock = threading.Lock()

        def writer(t):
            try:
                with s.client() as c:
                    for i in range(5):
                        ks = [b"w-%d-%d-%d" % (t, i, j) for j in range(10)]
                        assert c.insert_batch("hot", ks) == 10
                        with lock:
                            acked.extend(ks)
            except BaseException as e:  # noqa: BLE001
                errors.append(repr(e))

        def churner(t):
            try:
                with s.client() as c:
                    for i in range(8):
                        k = [b"c-%d-%d" % (t, i)]
                        c.insert_batch(f"churn-{t % 3}", k)
                        with lock:
                            churned.append((f"churn-{t % 3}", k))
                        c.include_batch(f"churn-{(t + 1) % 3}", [b"zz"])
            except BaseException as e:  # noqa: BLE001
                errors.append(repr(e))

        threads = [threading.Thread(target=writer, args=(t,)) for t in range(3)] + \
            [threading.Thread(target=churner, args=(t,)) for t in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors, errors
        assert len(acked) == 3 * 5 * 10
        assert counters.get("storage_hydrations_total") > 0
        s.ref_only("InsertBatch", {"name": "hot", "keys": acked})
        for name, k in churned:
            s.ref_only("InsertBatch", {"name": name, "keys": k})
        s.assert_tenants_equal()
        with s.client() as admin:
            assert _hits(admin, "hot", acked).all()
            assert admin.delete_batch("hot", acked) == len(acked)
            s.ref_only("DeleteBatch", {"name": "hot", "keys": acked})
            assert not _hits(admin, "hot", acked).any()
        s.assert_tenants_equal()
    finally:
        s.stop()


def test_quota_exceeded_sheds_while_hot_serves(tmp_path):
    s = Pair(tmp_path, max_resident_filters=2, tenant_hydrations_per_min=2)
    try:
        with s.client() as c:
            for n in ("hot", "thrash", "pump"):
                s.both("CreateFilter", create(n))
            c.insert_batch("hot", [b"h-1"])
            s.ref_only("InsertBatch", {"name": "hot", "keys": [b"h-1"]})
            shed = None
            for _ in range(8):
                for k in (b"h-keep",):
                    c.insert_batch("hot", [k])
                    s.ref_only("InsertBatch", {"name": "hot", "keys": [k]})
                try:
                    c._call_once("QueryBatch", {"name": "thrash", "keys": [b"t"]})
                except protocol.BloomServiceError as e:
                    shed = e
                    break
                c.insert_batch("hot", [b"h-keep2"])
                s.ref_only("InsertBatch", {"name": "hot", "keys": [b"h-keep2"]})
                c._call_once("QueryBatch", {"name": "pump", "keys": [b"p"]})
            assert shed is not None, "the thrashing tenant never shed"
            assert shed.code == "RESOURCE_EXHAUSTED"
            assert shed.details.get("retry_after_ms") is not None
            assert shed.details.get("tenant") == "thrash"
            assert counters.get("storage_hydrations_shed") > 0
            assert "hot" in s.service._filters
            assert _hits(c, "hot", [b"h-1"]).all()
        s.assert_tenants_equal()
    finally:
        s.stop()


def test_storage_evict_fault_aborts_cleanly(tmp_path):
    s = Pair(tmp_path, max_resident_filters=2)
    try:
        with s.client() as c:
            s.both("CreateFilter", create("a"))
            s.both("CreateFilter", create("b"))
            c.insert_batch("a", [b"a-1"])
            s.ref_only("InsertBatch", {"name": "a", "keys": [b"a-1"]})
            faults.arm("storage.evict", "once")
            s.both("CreateFilter", create("over"))  # the budget pass fires the fault
            assert counters.get("fault_storage_evict") >= 1
            assert len(s.service._filters) == 3
            assert _hits(c, "a", [b"a-1"]).all()
            s.both("CreateFilter", create("over2"))
            assert len(s.service._filters) <= 2
        s.assert_tenants_equal()
    finally:
        s.stop()


def test_storage_hydrate_fault_retry_exactly_once(tmp_path):
    s = Pair(tmp_path, max_resident_filters=2)
    try:
        with s.client() as c:
            s.both("CreateFilter", create("cnt", counting=True))
            s.both("InsertBatch", {"name": "cnt", "keys": [b"k1", b"k2"]})
            for i in range(3):
                s.both("CreateFilter", create(f"pad-{i}"))
                c.insert_batch(f"pad-{i}", [b"x-%d-%d" % (i, j) for j in range(10)])
                s.ref_only("InsertBatch", {"name": f"pad-{i}",
                                           "keys": [b"x-%d-%d" % (i, j) for j in range(10)]})
            assert "cnt" not in s.service._filters
            faults.arm("storage.hydrate", "once")
            with pytest.raises(protocol.BloomServiceError) as ei:
                c._call_once("QueryBatch", {"name": "cnt", "keys": [b"k1"]})
            assert ei.value.code == "INTERNAL"
            assert counters.get("fault_storage_hydrate") >= 1
            assert _hits(c, "cnt", [b"k1", b"k2"]).all()
            s.assert_tenants_equal()
            assert c.delete_batch("cnt", [b"k1", b"k2"]) == 2
            s.ref_only("DeleteBatch", {"name": "cnt", "keys": [b"k1", b"k2"]})
            assert not _hits(c, "cnt", [b"k1", b"k2"]).any()
        s.assert_tenants_equal()
    finally:
        s.stop()


def test_truncation_respects_paged_floor_and_restart_recovers(tmp_path):
    """The checkpoint-keyed truncation sweep runs with paged tenants (their
    evictions landed durable generations), and a restart over the same
    directories rebuilds the evicted tenant from checkpoint and log."""
    s = Pair(tmp_path, oplog=True, max_resident_filters=2)
    svc = s.service
    try:
        s.both("CreateFilter", {**create("aa", counting=True)})
        for i in range(20):
            s.both("InsertBatch", {"name": "aa", "keys": [b"aa-%d" % i]})
        for i in range(3):
            req = create(f"bb-{i}")
            req["options"]["checkpoint_every"] = 8
            s.both("CreateFilter", req)
            s.both("InsertBatch", {"name": f"bb-{i}", "keys": [b"pad-%d" % i]})
        assert "aa" not in svc._filters
        for i in range(80):
            s.both("InsertBatch", {"name": "bb-0", "keys": [b"bb-%d" % i]})
        with svc._lock:
            resident = list(svc._filters.values())
        for mf in resident:
            with mf.lock:
                mf.checkpointer.trigger()
            assert mf.checkpointer.flush()
        svc._maybe_truncate_log()
        assert svc.metrics.snapshot()["counters"].get("repl_log_truncations", 0) >= 1
        s.assert_tenants_equal()
    finally:
        s.server.stop(grace=None)
        svc.shutdown()
        svc.oplog.close()
    # a restart over the same directories
    s2 = Pair(tmp_path, oplog=True, max_resident_filters=2)
    s2.ref.shutdown()
    s2.ref = s.ref
    try:
        s2.service.replay_oplog()
        ks = [b"aa-%d" % i for i in range(20)]
        assert hits(s2.service.QueryBatch({"name": "aa", "keys": ks})).all()
        s2.assert_tenants_equal()
        s2.both("DeleteBatch", {"name": "aa", "keys": ks})
        assert not hits(s2.service.QueryBatch({"name": "aa", "keys": ks})).any()
        s2.assert_tenants_equal()
    finally:
        s2.stop()


def test_apply_record_hydrates_evicted_tenant(tmp_path):
    """A replayed or streamed record naming an evicted tenant hydrates it
    and applies, instead of skipping it as an unknown filter."""
    s = Pair(tmp_path, oplog=True, max_resident_filters=2)
    svc = s.service
    try:
        s.both("CreateFilter", create("ap"))
        for i in range(3):
            s.both("CreateFilter", create(f"ap-fill-{i}"))
            s.both("InsertBatch", {"name": f"ap-fill-{i}", "keys": [b"x"]})
        assert "ap" not in svc._filters
        seq = svc.oplog.last_seq + 100
        svc._replaying = True  # the context apply_record runs in
        try:
            assert svc.apply_record({"method": "InsertBatch", "seq": seq,
                                     "req": {"name": "ap", "keys": [b"from-record"]}})
        finally:
            svc._replaying = False
        s.ref_only("InsertBatch", {"name": "ap", "keys": [b"from-record"]})
        assert hits(svc.QueryBatch({"name": "ap", "keys": [b"from-record"]}))[0]
        assert svc._filters["ap"].applied_seq == seq
        s.assert_tenants_equal()
    finally:
        s.stop()


#: one create request of each kind the port serves
KINDS = {
    "blocked": ("CreateFilter", {"config": {"m": 1 << 16, "k": 7, "key_len": 16,
                                            "block_bits": 512, "block_hash": "chunk"}}),
    "flat": ("CreateFilter", {"config": {"m": 1 << 16, "k": 5, "key_len": 16}}),
    "counting": ("CreateFilter", {"config": {"m": 1 << 14, "k": 4, "key_len": 16,
                                             "counting": True}}),
    "blocked-counting": ("CreateFilter", {"config": {"m": 1 << 14, "k": 4, "key_len": 16,
                                                     "counting": True, "block_bits": 512}}),
    "sharded": ("CreateFilter", {"config": {"m": 1 << 18, "k": 5, "key_len": 16,
                                            "block_bits": 512, "shards": 8}}),
    "scalable": ("CreateFilter", {"capacity": 300, "error_rate": 0.01,
                                  "options": {"key_len": 16},
                                  "scalable": {"growth": 2, "tightening": 0.5}}),
    "cuckoo": ("CFReserve", {"capacity": 1000, "options": {"key_len": 16}}),
    "cms": ("CMSInitByDim", {"width": 2016, "depth": 5, "options": {"key_len": 16}}),
    "topk": ("TopKReserve", {"topk": 5, "width": 512, "depth": 4, "options": {"key_len": 16}}),
}
ADD = {"cuckoo": "CFAdd", "cms": "CMSIncrBy", "topk": "TopKAdd"}


def test_device_bytes_and_eviction_free_every_kind(tmp_path):
    """For every kind: ``_device_bytes`` is the bytes the filter's tensors
    hold (the reference's snapshot payload has as many), the budget counts
    each tenant's bytes as filed when it became resident (a scalable stack
    that grew since is counted at its size then, as in the reference), and
    an eviction takes exactly those bytes off the budget and leaves no
    reference to the tensors (on the card, ``memory_allocated`` falls by
    them)."""
    s = Pair(tmp_path, max_resident_filters=len(KINDS) + 1)
    svc = s.service
    try:
        rng = np.random.default_rng(14)
        filed = {}
        for name, (verb, req) in KINDS.items():
            s.both(verb, {"name": name, **req})
            filed[name] = _device_bytes(svc._filters[name].filter)
            ks = [bytes(r) for r in rng.integers(0, 256, (400, 16), dtype=np.uint8)]
            s.both(ADD.get(name, "InsertBatch"), {"name": name, "keys": ks})
        assert filed["scalable"] < _device_bytes(svc._filters["scalable"].filter)
        expect = {}
        for name in KINDS:
            filt = svc._filters[name].filter
            tensors = filt._state_tensors()
            assert tensors and all(t.device == svc.device for t in tensors)
            expect[name] = sum(t.numel() * t.element_size() for t in tensors)
            _, body = payload(s.ref._filters[name].filter)
            assert expect[name] == len(body), name
            assert _device_bytes(filt) == expect[name], name
        assert {n: b for n, b in filed.items() if n != "scalable"} == \
            {n: b for n, b in expect.items() if n != "scalable"}
        assert svc.storage.summary()["resident_bytes"] == sum(filed.values())
        # evict all but the newest: each eviction frees its tensors
        refs = {n: [weakref.ref(t) for t in svc._filters[n].filter._state_tensors()]
                for n in KINDS}
        svc.storage.config.max_resident_filters = 1
        gc.collect()
        gc.disable()  # freed by reference counts, not by a later collection
        try:
            svc.storage.ensure_budget()
            freed = {n: all(r() is None for r in rs) for n, rs in refs.items()}
        finally:
            gc.enable()
        left = list(svc._filters)
        assert len(left) == 1
        assert svc.storage.summary()["resident_bytes"] == filed[left[0]]
        for name in refs:
            assert freed[name] == (name not in left), f"{name}: freed {freed[name]}"
        s.assert_tenants_equal()
    finally:
        s.stop()


# -- SIGKILL during eviction (subprocess) --------------------------------------


def _free_port() -> int:
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def _spawn(tmp_path, port):
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    env.pop("TPUBLOOM_FAULTS", None)
    return subprocess.Popen(
        [sys.executable, "-m", "tpubloom_torch.server", str(port), str(tmp_path / "ckpt"),
         "--device", "cpu", "--repl-log-dir", str(tmp_path / "oplog"),
         "--max-resident-filters", "2", "--trace-sample", "0.0"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, env=env, cwd=tmp_path)


def test_sigkill_during_eviction_loses_nothing(tmp_path):
    """A server churning evictions under acked counting load is SIGKILLed
    and restarted over the same directories: every acked write is there
    exactly once, and the tenants equal a reference fed the acked
    writes."""
    from tpubloom_torch.obs import blackbox as bb

    names = [f"sk-{i}" for i in range(6)]
    acked = {n: [] for n in names}
    sent = []  # the write in flight when the kill lands may or may not apply
    port = _free_port()
    proc, proc2 = _spawn(tmp_path, port), None
    ref = jservice.BloomService(sink_factory=lambda c: None)
    try:
        with BloomClient(f"127.0.0.1:{port}") as c:
            c.wait_ready(timeout=120)
            for n in names:
                c.create_filter(n, capacity=5000, error_rate=0.01, counting=True)
            stop, errors = threading.Event(), []

            def writer():
                i = 0
                with BloomClient(f"127.0.0.1:{port}") as wc:
                    while not stop.is_set():
                        n = names[i % len(names)]
                        ks = [b"%s-%d" % (n.encode(), i)]
                        sent[:] = [(n, ks)]
                        try:
                            wc.insert_batch(n, ks)
                        except Exception as e:  # noqa: BLE001
                            errors.append(repr(e))
                            return
                        acked[n].extend(ks)
                        sent.clear()
                        i += 1

            t = threading.Thread(target=writer, daemon=True)
            t.start()
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                hyd = c.stats()["process_counters"].get("storage_hydrations_total", 0)
                if hyd >= 8 and sum(len(v) for v in acked.values()) >= 30:
                    break
                time.sleep(0.1)
            else:
                pytest.fail(f"paging never churned; errors={errors}")
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
        stop.set()
        t.join(timeout=10)
        node = bb.read_node(str(tmp_path / "oplog"))
        assert node is not None
        assert {"boot", "eviction"} <= {e["kind"] for e in node["events"]}

        port2 = _free_port()
        proc2 = _spawn(tmp_path, port2)
        with BloomClient(f"127.0.0.1:{port2}") as c2:
            c2.wait_ready(timeout=120)
            for n in names:
                ks = acked[n]
                ref.CreateFilter(create(n, counting=True))
                if not ks:
                    continue
                ref.InsertBatch({"name": n, "keys": ks})
                got = np.asarray(c2.include_batch(n, ks), dtype=bool)
                assert got.all(), f"{n}: {int((~got).sum())} acked write(s) lost"
            # the restarted server's tenants against the reference, then a
            # delete round that must empty each (exactly once)
            for n in names:
                blob = c2._rpc("Checkpoint", {"name": n, "wait": True})
                assert blob["ok"]
            restarted = service.BloomService(
                sink_factory=lambda c: ck.FileSink(str(tmp_path / "ckpt")), device="cpu")
            try:
                for n in names:
                    restarted.CreateFilter(create(n, counting=True))
                    got = payload(restarted._filters[n].filter)
                    if sent and sent[0][0] == n and got != payload(ref._filters[n].filter):
                        # the unacked write applied before the kill
                        ref.InsertBatch({"name": n, "keys": sent[0][1]})
                    assert got == payload(ref._filters[n].filter), n
            finally:
                restarted.shutdown()
            for n in names:
                if acked[n]:
                    if sent and sent[0][0] == n and c2.include(n, sent[0][1][0]):
                        c2.delete_batch(n, sent[0][1])
                    c2.delete_batch(n, acked[n])
                    assert not np.asarray(c2.include_batch(n, acked[n]), dtype=bool).any(), n
        assert sum(len(v) for v in acked.values()) >= 30
    finally:
        ref.shutdown()
        for p in (proc, proc2):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait(timeout=10)


def test_one_evictor_and_room_before_hydration(tmp_path):
    """The budget bounds the device's bytes under concurrency: callers
    that find the budget over while another thread evicts leave the work
    to it (four concurrent passes over one tenant of excess evict one),
    and a hydration makes room for its tenant before it restores it."""
    s = Pair(tmp_path, max_resident_filters=3)
    svc = s.service
    try:
        for n in ("a", "b", "c"):
            s.both("CreateFilter", create(n))
            s.both("InsertBatch", {"name": n, "keys": [n.encode() * 16]})
        assert sorted(svc._filters) == ["a", "b", "c"]
        svc.storage.config.max_resident_filters = 2
        start, counts = threading.Barrier(4), []

        def budget():
            start.wait()
            counts.append(svc.storage.ensure_budget())

        threads = [threading.Thread(target=budget) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert sum(counts) == 1 and len(svc._filters) == 2
        paged = next(n for n in ("a", "b", "c") if n not in svc._filters)
        resident_at_restore = []
        restore = svc._managed_from_blob

        def watched(*a, **kw):
            resident_at_restore.append(len(svc._filters))
            return restore(*a, **kw)

        svc._managed_from_blob = watched
        assert hits(svc.QueryBatch({"name": paged, "keys": [paged.encode() * 16]})).all()
        assert resident_at_restore == [1]  # a victim went out before it came in
        assert len(svc._filters) == 2
        s.assert_tenants_equal()
    finally:
        s.stop()
