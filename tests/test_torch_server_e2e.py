"""The port's server as its users start it: ``python -m
tpubloom_torch.server`` in a subprocess on the CPU, driven by the port's
coalesced ``BloomClient`` from several threads; the flags and constructor
arguments of the durable planes (op log, replication, residency) building
their objects, and so do cluster mode's; and
the import boundary: no module of ``jax`` or ``tpubloom`` is loaded by the
port's server, its client, or any of the modules they bring in."""

import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from tpubloom_torch import FilterConfig, faults
from tpubloom_torch.filter import BlockedBloomFilter
from tpubloom_torch.obs import blackbox, counters, flight, trace
from tpubloom_torch.server import service

REPO = Path(__file__).resolve().parent.parent
L = 16

#: modules the server brings in that the earlier slices did not have
NEW_MODULES = [
    "tpubloom_torch.obs." + m for m in (
        "blackbox", "context", "exposition", "flight", "httpd", "names",
        "slowlog", "trace")
] + [
    "tpubloom_torch.server." + m for m in (
        "client", "ingest", "metrics", "protocol", "service", "streams")
] + [
    "tpubloom_torch.cluster", "tpubloom_torch.cluster.client",
    "tpubloom_torch.cluster.migrate", "tpubloom_torch.cluster.node",
    "tpubloom_torch.cluster.slots", "tpubloom_torch.repl",
    "tpubloom_torch.repl.log", "tpubloom_torch.repl.monitor",
    "tpubloom_torch.repl.primary", "tpubloom_torch.repl.record",
    "tpubloom_torch.repl.replica", "tpubloom_torch.utils.crcjson",
    "tpubloom_torch.storage", "tpubloom_torch.storage.residency",
    "tpubloom_torch.ha", "tpubloom_torch.ha.topology",
    "tpubloom_torch.ha.promotion", "tpubloom_torch.ha.sentinel", "tpubloom_torch.sentinel",
    "tpubloom_torch.cluster.rebalance", "tpubloom_torch.obs.aggregate",
    "tpubloom_torch.parallel.distributed", "tpubloom_torch.version",
    "tpubloom_torch.analysis", "tpubloom_torch.analysis.lint",
    "tpubloom_torch.analysis.lock_order", "tpubloom_torch.analysis.__main__",
]


@pytest.fixture(autouse=True)
def port_globals():
    yield
    faults.reset()
    trace.reset_for_tests()
    flight.reset_for_tests()
    blackbox.reset_for_tests()
    counters.reset_for_tests()


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("TPUBLOOM_FAULTS", None)
    env.update(extra)
    return env


def _foreign(names) -> list:
    return sorted(
        n for n in names
        if n == "jax" or n.startswith("jax.") or n == "tpubloom" or n.startswith("tpubloom.")
    )


def test_new_modules_serve_without_jax(tmp_path):
    """Every module of the serving plane imports, and a port server with
    an op log and tenant residency serves requests through the client (one
    of them to a tenant it paged out, which hydrates) and replicates them
    to a port replica, with no ``jax`` or ``tpubloom`` module in
    ``sys.modules``."""
    code = f"""
import importlib, sys
for m in {NEW_MODULES!r}:
    importlib.import_module(m)
from tpubloom_torch.server.client import BloomClient
from tpubloom_torch.server.service import BloomService, build_server
from tpubloom_torch import checkpoint as ckpt
from tpubloom_torch.repl import OpLog, ReplicaApplier
from tpubloom_torch.storage import StorageConfig
log = OpLog({str(tmp_path / "log")!r})
svc = BloomService(sink_factory=lambda c: ckpt.FileSink({str(tmp_path)!r}), device="cpu",
                   oplog=log, storage=StorageConfig(max_resident_filters=1))
srv, port = build_server(svc, "127.0.0.1:0")
srv.start()
rsvc = BloomService(read_only=True, device="cpu")
applier = ReplicaApplier(rsvc, f"127.0.0.1:{{port}}", reconnect_base=0.05).start()
with BloomClient(f"127.0.0.1:{{port}}") as c:
    c.create_filter("f", config={{"m": 1 << 16, "k": 5, "block_bits": 512}})
    c.create_filter("g", config={{"m": 1 << 16, "k": 5, "block_bits": 512}})
    assert list(svc._filters) == ["g"]
    c.insert_batch("f", [b"a" * 16, b"b" * 16])
    assert c.include_batch("g", [b"a" * 16]).tolist() == [False]
    assert list(svc._filters) == ["g"]
    assert c.include_batch("f", [b"a" * 16, b"z" * 16]).tolist() == [True, False]
    assert svc.storage.summary()["resident"] == 1
    c.checkpoint("f")
assert applier.wait_for_seq(log.last_seq, 60), applier.status()
assert rsvc._filters["f"].filter.words.equal(svc._filters["f"].filter.words)
applier.stop()
srv.stop(grace=None)
svc.shutdown()
log.close()
print("FOREIGN", sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "tpubloom")))
"""
    out = subprocess.run(
        [sys.executable, "-c", code], env=_env(), capture_output=True,
        text=True, timeout=120, cwd=tmp_path,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOREIGN []" in out.stdout, out.stdout


class _ServerProcess:
    """``python -X importtime -m tpubloom_torch.server ...``: the bound
    port comes from its startup log line, and every module it imports,
    lazily or not, is listed on its stderr."""

    def __init__(self, args, cwd):
        self.proc = subprocess.Popen(
            [sys.executable, "-X", "importtime", "-m", "tpubloom_torch.server", *args],
            env=_env(), cwd=cwd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True,
        )
        self.lines: list = []
        self.port = None
        self._ready = threading.Event()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stderr:
            self.lines.append(line)
            m = re.search(r"listening on :(\d+)", line)
            if m:
                self.port = int(m.group(1))
                self._ready.set()
        self._ready.set()

    def wait_ready(self, timeout=60.0) -> int:
        self._ready.wait(timeout)
        assert self.port is not None, "".join(self.lines[-40:])
        return self.port

    def stop(self) -> int:
        self.proc.terminate()
        return self.proc.wait(timeout=60)

    def imported(self) -> list:
        return [
            line.split("|")[-1].strip() for line in self.lines
            if line.startswith("import time:") and "|" in line
        ]


def test_server_subprocess_serves_coalesced_client(tmp_path):
    from tpubloom_torch.server.client import BloomClient

    proc = _ServerProcess(
        ["0", str(tmp_path / "ckpt"), "--device", "cpu",
         "--coalesce-max-keys", "4096", "--coalesce-max-wait-us", "2000"],
        cwd=tmp_path,
    )
    try:
        port = proc.wait_ready()
        addr = f"127.0.0.1:{port}"
        cfg = {"m": 1 << 18, "k": 7, "block_bits": 512, "key_len": L}
        rng = np.random.default_rng(14)
        batches = [[rng.bytes(L) for _ in range(256)] for _ in range(32)]
        fresh = [rng.bytes(L) for _ in range(2048)]
        with BloomClient(addr) as c:
            assert c.health()["backend"] == "cpu"
            c.create_filter("e2e", config=cfg)

        def writer(part):
            with BloomClient(addr) as c:
                for j in part:
                    assert c.insert_batch("e2e", batches[j]) == len(batches[j])

        threads = [threading.Thread(target=writer, args=(range(t, 32, 8),))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

        held = [k for b in batches for k in b]
        probes = [held[i::8] + fresh[i::8] for i in range(8)]
        got = [None] * 8

        def reader(i):
            with BloomClient(addr) as c:
                got[i] = c.include_batch("e2e", probes[i])

        threads = [threading.Thread(target=reader, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        direct = BlockedBloomFilter(FilterConfig(key_name="e2e", **cfg), device="cpu")
        direct.insert_batch(held)
        for i in range(8):
            np.testing.assert_array_equal(got[i], direct.include_batch(probes[i]))
            assert got[i][: len(held[i::8])].all()
        with BloomClient(addr) as c:
            st = c.stats()
            assert st["counters"]["keys_inserted"] == len(held)
            assert st["counters"]["ingest_flushes"] >= 1
    finally:
        rc = proc.stop()
    assert rc == 0, "".join(proc.lines[-40:])
    mods = proc.imported()
    assert "tpubloom_torch.server.service" in mods
    assert _foreign(mods) == []


def test_server_without_card_exits_with_resolve_device_error(tmp_path):
    """No CUDA card (the case on this CPU host) and no ``--device cpu``:
    the server exits non-zero with ``resolve_device``'s message instead of
    serving from the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    out = subprocess.run(
        [sys.executable, "-m", "tpubloom_torch.server", "0", str(tmp_path)],
        env=_env(), capture_output=True, text=True, timeout=120, cwd=tmp_path,
    )
    assert out.returncode != 0
    assert "no CUDA device available" in out.stderr


#: the flags and constructor arguments of the durable planes and of cluster
#: mode, each with the object it must build: the op log, the replica's
#: applier, the residency store, the slot map's ``ClusterState``
#: (``--min-replicas-to-write`` builds the log its quorum needs)
DURABLE = [
    ("flag", ["--replica-of", "127.0.0.1:1"], "ReplicaApplier"),
    ("flag", ["--repl-log-dir", "oplog"], "OpLog"),
    ("flag", ["--min-replicas-to-write", "1", "--repl-log-dir", "oplog"], "OpLog"),
    ("flag", ["--max-resident-filters", "4"], "TenantStore"),
    ("flag", ["--max-resident-bytes", "1024"], "TenantStore"),
    ("flag", ["--cluster", "--repl-log-dir", "oplog"], "ClusterState"),
    ("arg", "oplog", "OpLog"),
    ("arg", "storage", "TenantStore"),
    ("arg", "cluster", "ClusterState"),
]


@pytest.mark.parametrize("how,what,builds", DURABLE)
def test_durable_planes_attach(how, what, builds, tmp_path, monkeypatch):
    """Each durable plane's or cluster mode's flag (through ``main()``,
    stopped before it serves) or constructor argument builds its object on
    ``--device cpu``; ``--cluster`` keeps its slot map beside the op log."""
    from tpubloom_torch.cluster import ClusterState
    from tpubloom_torch.repl import OpLog, ReplicaApplier
    from tpubloom_torch.storage import StorageConfig, TenantStore

    if how == "arg":
        value = {"oplog": lambda: OpLog(str(tmp_path / "log")),
                 "storage": lambda: StorageConfig(max_resident_filters=2),
                 "cluster": lambda: ClusterState("127.0.0.1:1", state_dir=str(tmp_path))}[what]()
        svc = service.BloomService(device="cpu", **{what: value})
        try:
            got = {"oplog": svc.oplog, "storage": svc.storage, "cluster": svc.cluster}[what]
            assert type(got).__name__ == builds
            assert got is value or what == "storage"
            assert svc._epoch_store is not None or what != "oplog"
            if what == "cluster":
                assert svc.ClusterSlots({})["enabled"]
                svc.ClusterSetSlot({"assign": [[0, 16383, "127.0.0.1:1"]], "epoch": 1})
                assert svc.Health({})["cluster"]["slots_owned"] == 16384
        finally:
            svc.shutdown()
            if what in ("oplog", "cluster"):
                value.close()
        return
    built = {}

    class Stop(Exception):
        pass

    def build_server(svc, address):
        built["service"] = svc
        raise Stop

    monkeypatch.setattr(service, "build_server", build_server)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(Stop):
        service.main(["0", str(tmp_path / "ckpt"), "--device", "cpu", *what])
    svc = built["service"]
    try:
        obj = {"OpLog": svc.oplog, "TenantStore": svc.storage,
               "ReplicaApplier": svc.replica_applier, "ClusterState": svc.cluster}[builds]
        assert type(obj).__name__ == builds and obj is not None
        if builds == "ClusterState":
            assert obj.self_addr == "127.0.0.1:0" and obj._store is not None
            assert os.path.dirname(os.path.abspath(obj._store.path)) == str(tmp_path / "oplog")
            svc.ClusterSetSlot({"assign": [[0, 16383, obj.self_addr]], "epoch": 2})
            assert ClusterState("x", state_dir=str(tmp_path / "oplog")).epoch() == 2
        if builds == "ReplicaApplier":
            assert svc.read_only and isinstance(obj, ReplicaApplier)
            obj.stop()
        if "--min-replicas-to-write" in what:
            assert svc.min_replicas_to_write == 1
        assert svc.device.type == "cpu"
    finally:
        svc.shutdown()
        if svc.oplog is not None:
            svc.oplog.close()
        if svc.cluster is not None:
            svc.cluster.close()


def test_inspect_quarantine_runs(tmp_path, capsys):
    (tmp_path / "corrupt").mkdir()
    (tmp_path / "corrupt" / "f.000000000001.ckpt").write_bytes(b"junk")
    with pytest.raises(SystemExit) as exc:
        service.main(["inspect-quarantine", str(tmp_path), "--json"])
    assert exc.value.code == 0
    assert '"total_bytes": 4' in capsys.readouterr().out


def test_metrics_port_serves_exposition(tmp_path):
    """``--metrics-port`` serves the Prometheus text (the README's start
    line), with the port's launch counters in it."""
    import urllib.request

    from tpubloom_torch.obs.httpd import start_metrics_server
    from tpubloom_torch.server.client import BloomClient

    svc = service.BloomService(device="cpu")
    srv, port = service.build_server(svc, "127.0.0.1:0")
    srv.start()
    metrics = start_metrics_server(svc, port=0, host="127.0.0.1")
    try:
        with BloomClient(f"127.0.0.1:{port}") as c:
            c.create_filter("m", config={"m": 1 << 16, "k": 5, "block_bits": 512})
            c.insert_batch("m", [b"k" * 16])
            c.include_batch("m", [b"k" * 16, b"q" * 16])
        deadline = time.time() + 10
        while True:
            try:
                body = urllib.request.urlopen(
                    f"http://127.0.0.1:{metrics.port}/metrics", timeout=5
                ).read().decode()
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.1)
    finally:
        metrics.close()
        srv.stop(grace=None)
    assert "tpubloom_keys_inserted_total 1" in body
    assert "tpubloom_query_sweep_launches_total" in body
    assert 'tpubloom_filter_fill_ratio{filter="m"}' in body
