"""Live slot migration of the port (``tpubloom_torch.cluster.migrate``
behind ``MigrateSlot`` / ``MigrateInstall``, the dual-write forwards and
the import gate) against ``tpubloom`` on the CPU.

Across packages: a slot holding a blocked filter and a counting one
migrates under client load from a port node to a port node, from a port
node to a ``tpubloom`` node and from a ``tpubloom`` node to a port node
(the port's nodes with the ingest coalescer on): the target's blocked
state bytes equal a filter fed every acknowledged key (tolerance 0),
every acknowledged counting key is present and one delete a batch leaves
every counter 0 (zero lost, zero doubled), no writer sees an error, the
source answers MOVED and holds no copy. On the port alone, the cases of
``tests/test_cluster.py``: an interrupted migration resumed by the op-log
tail (no blob re-sent) while a write waits on ``IMPORT_NOT_READY``; the
``cluster.migrate_apply`` fault with an exactly-once re-drive; every
hash-tagged filter of a slot (sketches too) moving together; and a port
source in a child process (``python -m tpubloom_torch.server --device cpu
--cluster``) SIGKILLed mid-migration under load, restarted and re-driven
with zero lost and zero doubled acknowledged writes."""

import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from tests.test_torch_cluster import CNode, REPO, assign_even, free_port, port_globals  # noqa: F401
from tests.test_torch_repl import payload
from tpubloom_torch import FilterConfig, faults
from tpubloom_torch.cluster import slots as S
from tpubloom_torch.cluster.client import ClusterClient
from tpubloom_torch.cluster.rebalance import even_ranges
from tpubloom_torch.filter import BlockedBloomFilter
from tpubloom_torch.obs import counters
from tpubloom_torch.server import ingest, protocol
from tpubloom_torch.server.client import BloomClient

L = 16
BLOCKED = {"m": 1 << 16, "k": 7, "key_len": L, "block_bits": 512, "block_hash": "chunk"}
COALESCE = ingest.CoalesceConfig(max_keys=1 << 10, max_wait_us=2000)


def tag_owned_by(owner, addr, prefix="t") -> str:
    """A hash tag whose slot ``owner(slot)`` gives to ``addr``."""
    for i in range(4096):
        if owner(S.key_slot(f"{{{prefix}{i}}}")) == addr:
            return f"{prefix}{i}"
    raise AssertionError("no tag hashed to the wanted node")


def rows(rng, n) -> list:
    return [bytes(r) for r in rng.integers(0, 256, (n, L), dtype=np.uint8)]


def counting_empty(svc, name) -> bool:
    """Every counter of a counting filter at 0, by its blob's payload."""
    return not any(payload(svc._filters[name].filter)[1])


class Writers:
    """Threads of one ``ClusterClient`` each writing batches into one filter
    until stopped, each batch under its own rid; acknowledged batches and
    every error are kept."""

    def __init__(self, cc, jobs):
        self.cc, self.acked, self.errors = cc, {n: [] for n, _ in jobs}, []
        self.stop = threading.Event()
        self.threads = [threading.Thread(target=self._run, args=job, daemon=True) for job in jobs]

    def _run(self, name, make):
        i = 0
        while not self.stop.is_set():
            ks = make(i)
            try:
                self.cc.insert_batch(name, ks)
                self.acked[name].append(ks)
            except Exception as e:  # noqa: BLE001 — reported by the test
                self.errors.append(repr(e))
            i += 1

    def __enter__(self):
        for t in self.threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        for t in self.threads:
            t.join(timeout=120)


@pytest.mark.parametrize("src_pkg,tgt_pkg", [("torch", "torch"), ("torch", "tpubloom"),
                                             ("tpubloom", "torch")])
def test_live_migration_under_load_across_packages(src_pkg, tgt_pkg, tmp_path):
    src = CNode(src_pkg, tmp_path, "src", coalesce=COALESCE)
    tgt = CNode(tgt_pkg, tmp_path, "tgt", coalesce=COALESCE)
    try:
        addrs = assign_even([src, tgt])
        tag = tag_owned_by(src.cluster.owner, src.addr)
        blk, cnt = f"{{{tag}}}:blk", f"{{{tag}}}:cnt"
        slot = S.key_slot(blk)
        cc = ClusterClient(startup_nodes=addrs, max_retries=3, backoff_base=0.05)
        cc.create_filter(blk, config=BLOCKED)
        cc.create_filter(cnt, capacity=20_000, error_rate=0.01, counting=True, key_len=L)
        rng = np.random.default_rng(17)
        pre = rows(rng, 256)
        cc.insert_batch(blk, pre)
        cc.insert_batch(cnt, pre[:64])
        seeds = np.random.SeedSequence(18).spawn(2)

        def blk_batch(i, g=np.random.default_rng(seeds[0])):
            return rows(g, 64)

        def cnt_batch(i):
            return [b"cnt-%05d-%06d" % (i, j) for j in range(20)]

        with Writers(cc, [(blk, blk_batch), (cnt, cnt_batch)]) as w:
            time.sleep(0.3)
            resp = BloomClient(addrs[0], timeout=120).migrate_slot(slot, addrs[1])
            time.sleep(0.2)
        assert not w.errors, f"writers saw errors across the handoff: {w.errors[:3]}"
        assert resp["ok"] and resp["filters_moved"] == 2 and resp["snapshots"] == 2
        assert resp["epoch"] == 2 and all(w.acked.values())
        # ownership: the source answers MOVED and dropped its copies; the maps agree
        assert src.cluster.owner(slot) == tgt.cluster.owner(slot) == addrs[1]
        with pytest.raises(protocol.BloomServiceError, match="MOVED"):
            BloomClient(addrs[0]).include_batch(blk, [pre[0]])
        assert blk not in src.service._filters and cnt not in src.service._filters
        # words: the target's blocked state equals a filter fed every acknowledged key
        direct = BlockedBloomFilter(FilterConfig(key_name=blk, **BLOCKED), device="cpu")
        direct.insert_batch(pre + [k for ks in w.acked[blk] for k in ks])
        assert payload(tgt.service._filters[blk].filter)[1] == payload(direct)[1]
        # exactly once: every acknowledged counting key present, then one delete a batch empties it
        every = pre[:64] + [k for ks in w.acked[cnt] for k in ks]
        assert cc.include_batch(cnt, every).all(), "acknowledged writes lost"
        cc.delete_batch(cnt, pre[:64])
        for ks in w.acked[cnt]:
            cc.delete_batch(cnt, ks)
        assert counting_empty(tgt.service, cnt), "acknowledged writes doubled"
        cc.close()
    finally:
        src.close()
        tgt.close()


def test_migration_resume_takes_tail_path(tmp_path):
    """An interrupted migration re-driven: the first filter resumes by the
    op-log tail (no blob re-sent), the second goes by snapshot while a write
    into it waits on ``IMPORT_NOT_READY`` re-drives; exactly once."""
    a, b = CNode("torch", tmp_path, "a", coalesce=COALESCE), CNode("torch", tmp_path, "b")
    try:
        addrs = assign_even([a, b])
        cc = ClusterClient(startup_nodes=addrs)
        tag = tag_owned_by(a.cluster.owner, addrs[0], "r")
        fa, fb = f"{{{tag}}}:a", f"{{{tag}}}:b"
        slot = S.key_slot(fa)
        for n in (fa, fb):
            cc.create_filter(n, capacity=20_000, error_rate=0.01, counting=True)
        keys0 = [b"r-%04d" % i for i in range(200)]
        cc.insert_batch(fa, keys0)
        cc.insert_batch(fb, keys0)
        # passes: fa's probe (1), fa's install (2), fb's probe (3) fires
        faults.arm("cluster.migrate_send", "nth:3", times=1)
        with pytest.raises(protocol.BloomServiceError):
            BloomClient(addrs[0]).migrate_slot(slot, addrs[1])
        faults.disarm("cluster.migrate_send")
        assert a.cluster.owner(slot) == addrs[0] and b.cluster.is_importing(slot)
        assert fa in b.service._filters and fb not in b.service._filters
        keys1 = [b"r2-%04d" % i for i in range(150)]
        cc.insert_batch(fa, keys1)  # forwarded live: fa's gate exists
        before = counters.get("cluster_migrate_snapshots_sent")
        unready = counters.get("cluster_forward_failures")
        done: list = []
        mt = threading.Thread(target=lambda: done.append(
            BloomClient(addrs[0], timeout=120).migrate_slot(slot, addrs[1])))
        mt.start()
        cc.insert_batch(fb, keys1)  # waits on IMPORT_NOT_READY until fb's snapshot lands
        mt.join(timeout=120)
        assert done, "the re-driven migration did not finish"
        resp = done[0]
        assert resp["ok"] and resp["filters_moved"] == 2
        assert resp["snapshots"] == 1 and resp["tail_records"] >= 1
        assert counters.get("cluster_migrate_snapshots_sent") == before + 1
        assert counters.get("cluster_forward_failures") >= unready
        for n in (fa, fb):
            assert cc.include_batch(n, keys0 + keys1).all(), f"lost writes ({n})"
            cc.delete_batch(n, keys0)
            cc.delete_batch(n, keys1)
            assert counting_empty(b.service, n), f"the tail resume doubled records ({n})"
        cc.close()
    finally:
        a.close()
        b.close()


def test_migrate_apply_fault_redrive_exactly_once(tmp_path):
    """``cluster.migrate_apply`` fires in the target's install: the driver
    fails, the source still owns the slot, and the re-driven migration
    lands every counter exactly once."""
    a, b = CNode("torch", tmp_path, "a"), CNode("torch", tmp_path, "b")
    try:
        addrs = assign_even([a, b])
        cc = ClusterClient(startup_nodes=addrs)
        tag = tag_owned_by(a.cluster.owner, addrs[0], "ma")
        name = f"{{{tag}}}:c"
        slot = S.key_slot(name)
        cc.create_filter(name, capacity=20_000, error_rate=0.01, counting=True)
        keys = [b"ma-%04d" % i for i in range(200)]
        cc.insert_batch(name, keys)
        before = counters.get("fault_cluster_migrate_apply")
        faults.arm("cluster.migrate_apply", "nth:2", times=1)  # 1 is the probe
        with pytest.raises(protocol.BloomServiceError):
            BloomClient(addrs[0]).migrate_slot(slot, addrs[1])
        assert counters.get("fault_cluster_migrate_apply") == before + 1
        assert a.cluster.owner(slot) == addrs[0] and name not in b.service._filters
        resp = BloomClient(addrs[0], timeout=120).migrate_slot(slot, addrs[1])
        assert resp["ok"] and b.cluster.owner(slot) == addrs[1]
        assert cc.include_batch(name, keys).all(), "lost writes"
        cc.delete_batch(name, keys)
        assert counting_empty(b.service, name), "the re-driven install doubled records"
        cc.close()
    finally:
        a.close()
        b.close()


def test_migration_moves_all_hash_tagged_filters(tmp_path):
    """Every filter of a hash tag's slot moves in one ``MigrateSlot``: a
    blocked filter, a counting one, a cuckoo filter and a count-min sketch,
    each answering at its new owner as it did before."""
    a, b = CNode("torch", tmp_path, "a"), CNode("torch", tmp_path, "b")
    try:
        addrs = assign_even([a, b])
        cc = ClusterClient(startup_nodes=addrs)
        tag = tag_owned_by(a.cluster.owner, addrs[0], "tg")
        names = {k: f"{{{tag}}}:{k}" for k in ("seen", "blocked", "cf", "cms")}
        slot = S.key_slot(names["seen"])
        assert {S.key_slot(n) for n in names.values()} == {slot}
        keys = [b"tag-%012d" % i for i in range(40)]
        cc.create_filter(names["seen"], config=BLOCKED)
        cc.create_filter(names["blocked"], capacity=2000, error_rate=0.01, counting=True)
        with BloomClient(addrs[0]) as c:
            c.cf_reserve(names["cf"], 1000, key_len=L)
            c.cms_init_by_dim(names["cms"], 2016, 5, key_len=L)
            c.cf_add(names["cf"], keys)
            c.cms_incrby(names["cms"], keys)
        for n in (names["seen"], names["blocked"]):
            cc.insert_batch(n, keys)
        before = {n: payload(a.service._filters[n].filter) for n in names.values()}
        resp = BloomClient(addrs[0]).migrate_slot(slot, addrs[1])
        assert resp["filters_moved"] == 4 and resp["snapshots"] == 4
        for n in names.values():
            assert n in b.service._filters and n not in a.service._filters
            assert payload(b.service._filters[n].filter) == before[n], n
        assert cc.include_batch(names["seen"], keys).all()
        with BloomClient(addrs[1]) as c:
            assert all(c.cf_exists(names["cf"], keys))
            assert list(c.cms_query(names["cms"], keys)) == [1] * len(keys)
        cc.close()
    finally:
        a.close()
        b.close()


def test_migration_sigkill_acceptance(tmp_path):
    """A port source in a child process (``python -m tpubloom_torch.server
    --device cpu --cluster``) is made to fail mid-migration under client
    load and is then SIGKILLed; restarted on its log, it re-drives the
    migration to the end; every acknowledged write is at the new owner
    exactly once, and the dead node's black box decodes."""
    from tpubloom_torch.obs import blackbox as bb
    from tpubloom_torch.obs.context import new_rid

    port = free_port()
    src_addr = f"127.0.0.1:{port}"
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    env.pop("TPUBLOOM_FAULTS", None)
    plog = tmp_path / "src-log"
    args = [sys.executable, "-m", "tpubloom_torch.server", str(port), "--device", "cpu",
            "--cluster", "--repl-log-dir", str(plog), "--trace-sample", "0.0"]
    # passes: filter 1's probe (1) and install (2), filter 2's probe (3) and install (4)
    proc = subprocess.Popen(args, stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT,
                            env={**env, "TPUBLOOM_FAULTS": "cluster.migrate_send=nth:4:times=1"})
    t2, t3 = CNode("torch", tmp_path, "t2"), CNode("torch", tmp_path, "t3")
    boot = BloomClient(src_addr)
    cc = proc2 = None
    try:
        boot.wait_ready(timeout=120)
        addrs = [src_addr, t2.addr, t3.addr]
        ranges = even_ranges(addrs)
        boot.cluster_set_slot(assign=ranges, epoch=1)
        for n in (t2, t3):
            n.service.ClusterSetSlot({"assign": ranges, "epoch": 1})
        owners = S.expand_ranges(ranges)
        tag = tag_owned_by(owners.get, src_addr, "m")
        names = [f"{{{tag}}}:a", f"{{{tag}}}:b"]
        slot = S.key_slot(names[0])
        cc = ClusterClient(startup_nodes=addrs, max_retries=3, backoff_base=0.05, backoff_max=0.5)
        for n in names:
            cc.create_filter(n, capacity=50_000, error_rate=0.01, counting=True)
        seed = {n: [b"seed-%s-%03d" % (n.encode(), i) for i in range(200)] for n in names}
        for n in names:
            cc.insert_batch(n, seed[n])
        seed_rid = cc.last_rid
        batches = [(names[i % 2], [b"acc-%03d-%03d" % (i, j) for j in range(15)])
                   for i in range(16)]
        acked, errors, done = [], [], threading.Event()

        def writer():
            # one rid a logical batch, kept across every retry
            for name, keys in batches:
                rid, deadline = new_rid(), time.monotonic() + 240
                while True:
                    try:
                        cc._keyed("InsertBatch", {"name": name, "keys": keys}, rid=rid)
                        acked.append((name, keys))
                        break
                    except Exception as e:  # noqa: BLE001
                        errors.append(repr(e))
                        if time.monotonic() > deadline:
                            raise
                        time.sleep(0.2)
            done.set()

        w = threading.Thread(target=writer, daemon=True)
        w.start()
        time.sleep(0.3)
        with pytest.raises(Exception):
            BloomClient(src_addr, timeout=120).migrate_slot(slot, t2.addr)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
        node = bb.read_node(str(plog))
        assert node is not None and "boot" in [e["kind"] for e in node["events"]]
        assert seed_rid in {s.get("rid") for s in node["spans"]}
        proc2 = subprocess.Popen(args, stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT,
                                 env=env)
        BloomClient(src_addr).wait_ready(timeout=120)
        resp = BloomClient(src_addr, timeout=120).migrate_slot(slot, t2.addr)
        assert resp["ok"] and resp["filters_moved"] == 2
        assert done.wait(240), f"writer wedged; acked={len(acked)} last={errors[-3:]}"
        w.join(timeout=10)
        assert len(acked) == len(batches)
        assert t2.cluster.owner(slot) == t2.addr
        with pytest.raises(protocol.BloomServiceError, match="MOVED"):
            BloomClient(src_addr).include_batch(names[0], [b"x"])
        per_name = {n: list(seed[n]) for n in names}
        for name, keys in acked:
            per_name[name].extend(keys)
        for n in names:
            assert cc.include_batch(n, per_name[n]).all(), f"acknowledged writes lost ({n})"
        for n in names:
            cc.delete_batch(n, seed[n])
        for name, keys in acked:
            cc.delete_batch(name, keys)
        for n in names:
            assert counting_empty(t2.service, n), f"acknowledged writes doubled ({n})"
    finally:
        for pr in (proc, proc2):
            if pr is not None and pr.poll() is None:
                pr.send_signal(signal.SIGTERM)
                try:
                    pr.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    pr.kill()
        boot.close()
        if cc is not None:
            cc.close()
        t2.close()
        t3.close()


@pytest.mark.parametrize("pkg,coalesce,answer", [("torch", COALESCE, "MOVED"),
                                                 ("torch", None, "MOVED"),
                                                 ("tpubloom", None, "NOT_FOUND")])
def test_write_racing_the_retire_is_redirected(pkg, coalesce, answer, tmp_path):
    """A write that passed the ownership check while its slot's handoff
    finalized, and whose filter the source then retired (the window a
    request parked in the coalescer meets), answers MOVED to the new owner
    on the port, where nothing was applied; ``tpubloom`` answers NOT_FOUND
    there (its copy of the wrapper has no check after the handler), which
    the routed client does not heal."""
    a = CNode(pkg, tmp_path, "a", coalesce=coalesce)
    try:
        peer = "10.0.0.9:7000"
        a.service.ClusterSetSlot({"assign": [[0, S.NUM_SLOTS - 1, a.addr]], "epoch": 1})
        a.service.CreateFilter({"name": "f", "config": BLOCKED})
        slot = S.key_slot("f")
        get = a.service._get

        def retire_first(name):
            # the finalize and the retire land between the check and the lookup
            a.service.ClusterSetSlot({"slot": slot, "state": "node", "addr": peer, "epoch": 2})
            a.service._filters.pop(name, None)
            a.service._get = get
            return get(name)

        a.service._get = retire_first
        with BloomClient(a.addr) as c:
            with pytest.raises(protocol.BloomServiceError) as exc:
                c._call_once("InsertBatch", {"name": "f", "keys": rows(np.random.default_rng(1), 8)})
        assert exc.value.code == answer
        if answer == "MOVED":
            assert exc.value.details == {"slot": slot, "addr": peer, "epoch": 2}
    finally:
        a.close()


def test_migrated_away_filter_is_freed_with_its_last_reference(tmp_path):
    """A source whose coalesced writes failed their forward (``IMPORT_NOT_READY``
    while an interrupted migration waited for its resume) frees the
    retired filter when the migration drops it, by reference counting
    alone: neither the dispatcher's idle loop nor a stored error's
    traceback keeps it (on the card, its device memory)."""
    import gc
    import weakref

    a = CNode("torch", tmp_path, "a", coalesce=COALESCE)
    b = CNode("torch", tmp_path, "b", coalesce=COALESCE)
    gc.disable()
    try:
        addrs = assign_even([a, b])
        cc = ClusterClient(startup_nodes=addrs)
        tag = tag_owned_by(a.cluster.owner, addrs[0], "gc")
        fa, fb = f"{{{tag}}}a", f"{{{tag}}}b"
        for n in (fa, fb):
            cc.create_filter(n, capacity=20_000, error_rate=0.01, counting=True)
            cc.insert_batch(n, [b"gc-%05d" % i for i in range(50)])
        alive = {n: weakref.ref(a.service._filters[n].filter) for n in (fa, fb)}
        slot = S.key_slot(fa)
        faults.arm("cluster.migrate_send", "nth:3", times=1)
        with pytest.raises(protocol.BloomServiceError):
            BloomClient(addrs[0]).migrate_slot(slot, addrs[1])
        faults.disarm("cluster.migrate_send")
        unready = counters.get("cluster_forward_failures")
        writer = threading.Thread(target=cc.insert_batch,
                                  args=(fb, [b"gc2-%05d" % i for i in range(20)]))
        writer.start()
        deadline = time.monotonic() + 30
        while counters.get("cluster_forward_failures") == unready:
            assert time.monotonic() < deadline, "the write met IMPORT_NOT_READY"
            time.sleep(0.01)
        BloomClient(addrs[0], timeout=60).migrate_slot(slot, addrs[1])
        writer.join(timeout=60)
        deadline = time.monotonic() + 10
        while any(r() is not None for r in alive.values()):
            assert time.monotonic() < deadline, {n: r() is not None for n, r in alive.items()}
            time.sleep(0.05)
        cc.close()
    finally:
        gc.enable()
        a.close()
        b.close()


class FlushRefused(protocol.BloomServiceError):
    """A subclass of the service's error, as a flush may raise one."""


@pytest.mark.parametrize("make", [lambda: RuntimeError("device fault"),
                                  lambda: FlushRefused("READONLY", "refused by the flush")],
                         ids=["runtime_error", "service_error_subclass"])
def test_failed_flush_does_not_pin_the_filter(make, tmp_path, monkeypatch):
    """A coalesced flush that fails, with an exception of any class, hands
    its waiters an error that holds none of the flush's frames: the filter
    that the failing flush held goes with its last reference once dropped,
    with the cyclic collector off."""
    import gc
    import logging
    import weakref

    # pytest's log capture keeps each record's exc_info, and with it the
    # flush's frames, until the test ends; a service's own handlers format
    # the record and let it go
    monkeypatch.setattr(logging.getLogger(ingest.log.name), "propagate", False)
    a = CNode("torch", tmp_path, "a", coalesce=COALESCE)
    gc.disable()
    try:
        assign_even([a])
        c = BloomClient(a.addr)
        c.create_filter("f", capacity=20_000, error_rate=0.01, key_len=L)
        alive = weakref.ref(a.service._filters["f"].filter)
        svc = a.service

        def failing(name, kind, entries, ftrace):
            held = svc._get(name).filter  # noqa: F841 — the frame holds the filter
            raise make()

        svc._coalescer._flush_inner = failing
        with pytest.raises(protocol.BloomServiceError) as exc:
            c.insert_batch("f", [b"k-%013d" % i for i in range(32)])
        want = "READONLY" if isinstance(make(), FlushRefused) else "INTERNAL"
        assert exc.value.code == want
        del svc._coalescer._flush_inner
        c.drop_filter("f", final_checkpoint=False)
        deadline = time.monotonic() + 10
        while alive() is not None:
            assert time.monotonic() < deadline, "the dropped filter is still held"
            time.sleep(0.05)
        c.close()
    finally:
        gc.enable()
        a.close()
