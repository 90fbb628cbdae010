"""The port's correctness tooling (``tpubloom_torch.analysis``) against
``tpubloom.analysis``, and the gate it holds the port to:

* the port's lint and its unified entry point exit 0 on ``tpubloom_torch/``;
* every seeded lint fixture of ``tests/test_analysis.py`` (read from that
  file's source) gives the same check names through the port's lint as
  through the reference's;
* the tree checks read the port's registries (``tpubloom_torch/faults``,
  ``obs/names.py``, ``server/*``, the port's golden test) and credit
  fault-point arming only to the port's harness (``tests/test_torch_*.py``
  and ``chip_smoke.py``); a never-emitted metric anchors on its
  declaration, where a reasoned allow silences it;
* the port's lock-order manifest equals the reference's apart from the
  edges it names, with their reasons;
* an armed in-process port server with the coalescer and an op log mints
  only declared lock edges;
* ``tpubloom_torch.__version__`` is the reference's."""

import ast
import json
import os
import subprocess
import sys
import textwrap

import pytest

import tpubloom
import tpubloom_torch
from tests.test_analysis import CONFIG_KW
from tpubloom.analysis import lint as JL
from tpubloom.analysis import lock_order as jlock_order
from tpubloom_torch.analysis import __main__ as entry
from tpubloom_torch.analysis import lint as L
from tpubloom_torch.analysis import lock_order

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def no_inherited_reports(monkeypatch):
    monkeypatch.delenv("TPUBLOOM_LOCK_CHECK_DIR", raising=False)


def _seeded_fixtures() -> list:
    """``(test name, source, overrides)`` of every ``_lint_source(tmp_path,
    "<source>", **overrides)`` call in ``tests/test_analysis.py``."""
    path = os.path.join(REPO, "tests", "test_analysis.py")
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    out = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "_lint_source":
                source = node.args[1].value
                overrides = {
                    k.arg: eval(compile(ast.Expression(k.value), path, "eval"),
                                {"__builtins__": {}, "frozenset": frozenset})
                    for k in node.keywords
                }
                out.append((fn.name, source, overrides))
    return out


SEEDED = _seeded_fixtures()


def test_the_seeded_fixtures_were_found():
    assert len(SEEDED) >= 16
    assert {"test_blocking_under_lock_flagged", "test_donation_safety_flags_use_after_donate",
            "test_unknown_and_unused_suppressions_are_findings"} <= {n for n, _, _ in SEEDED}


@pytest.mark.parametrize("name,source,overrides", SEEDED,
                         ids=[f"{n}@{i}" for i, (n, _, _) in enumerate(SEEDED)])
def test_seeded_fixture_same_checks_as_reference(name, source, overrides, tmp_path):
    path = tmp_path / "fixture.py"
    path.write_text(textwrap.dedent(source))
    kw = {**CONFIG_KW, **overrides}
    got = sorted(f.check for f in L.lint_paths([str(path)], L.LintConfig(**kw)))
    want = sorted(f.check for f in JL.lint_paths([str(path)], JL.LintConfig(**kw)))
    assert got == want


# -- the gate on the real tree ------------------------------------------------------


def test_port_lint_clean_on_the_port_tree():
    assert L.lint_paths([os.path.join(REPO, "tpubloom_torch")], L.LintConfig()) == []
    proc = subprocess.run([sys.executable, "-m", "tpubloom_torch.analysis.lint"],
                          capture_output=True, text=True, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout


def test_port_entry_point_clean_on_the_port_tree(tmp_path):
    report = tmp_path / "lockcheck-1.json"
    report.write_text(json.dumps({
        "edges": [{"from": "filter.op", "to": "repl.oplog", "count": 3}],
        "violations": [], "suppressed": [],
    }))
    proc = subprocess.run(
        [sys.executable, "-m", "tpubloom_torch.analysis", "--json", "--reports", str(tmp_path)],
        capture_output=True, text=True, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    result = json.loads(proc.stdout)
    assert result == {"lint": [], "lock_order": [], "reports_checked": 1}
    assert entry.main([]) == 0  # the static half alone


def test_port_entry_point_fails_on_an_undeclared_edge_or_a_violation(tmp_path, capsys):
    (tmp_path / "lockcheck-2.json").write_text(json.dumps({
        "edges": [{"from": "repl.oplog", "to": "filter.op", "count": 1}],
        "violations": [{"kind": "lock-order-cycle", "message": "t.a -> t.b -> t.a",
                        "site": "x.py:1"}],
        "suppressed": [],
    }))
    assert entry.main(["--json", "--reports", str(tmp_path)]) == 1
    kinds = sorted(f["kind"] for f in json.loads(capsys.readouterr().out)["lock_order"])
    assert kinds == ["runtime-lock-order-cycle", "undeclared-lock-edge"]
    empty = tmp_path / "empty"
    empty.mkdir()
    assert entry.main(["--json", "--reports", str(empty)]) == 1
    assert [f["kind"] for f in json.loads(capsys.readouterr().out)["lock_order"]] == ["no-reports"]


# -- the tree checks aim at the port -----------------------------------------------


def _protocol_tree(root, pkg, golden):
    server = root / pkg / "server"
    server.mkdir(parents=True)
    (server / "protocol.py").write_text('METHODS = ("Ping", "Ghost")\nSTREAM_METHODS = ("Watch",)\n')
    (server / "service.py").write_text(textwrap.dedent("""
        class BloomService:
            def Ping(self, req):
                return {"ok": True}

        _STREAM_BEHAVIORS = {}
        """))
    (server / "client.py").write_text('_X = "Ping"\n')
    (root / "tests").mkdir(exist_ok=True)
    (root / "tests" / golden).write_text('_Y = "Ping"\n')


def test_protocol_coverage_reads_the_port_server(tmp_path):
    """``tests/test_analysis.py::test_orphan_protocol_method_flagged`` on a
    ``tpubloom_torch/server`` tree with the port's golden test; the same
    files under ``tpubloom/`` are the reference's business, not the port's."""
    port, ref = tmp_path / "port", tmp_path / "ref"
    _protocol_tree(port, "tpubloom_torch", L.GOLDEN_TEST)
    _protocol_tree(ref, "tpubloom", "test_protocol_golden.py")
    got = sorted(f.message for f in L.check_protocol_coverage(str(port)))
    want = sorted(f.message for f in JL.check_protocol_coverage(str(ref)))
    assert len(got) == len(want) == 5
    assert sum("'Ghost'" in m for m in got) == 3 and sum("'Watch'" in m for m in got) == 2
    assert L.check_protocol_coverage(str(ref)) == []  # no tpubloom_torch/ there


def test_chaos_coverage_credits_only_the_port_harness(tmp_path):
    faults_dir = tmp_path / "tpubloom_torch" / "faults"
    faults_dir.mkdir(parents=True)
    (faults_dir / "__init__.py").write_text(textwrap.dedent("""
        KNOWN_POINTS = {
            "zz.port_test",
            "zz.chip_script",
            "zz.reference_test",
            "zz.benchmark",
            "zz.reasoned",  # lint: allow(chaos-coverage): driven only in a subprocess
        }
        """))
    tests_dir, bench_dir = tmp_path / "tests", tmp_path / "benchmarks"
    tests_dir.mkdir()
    bench_dir.mkdir()
    (tests_dir / "test_torch_x.py").write_text('faults.arm("zz.port_test", "once")\n')
    (tmp_path / "chip_smoke.py").write_text('ENV = "zz.chip_script=nth:2"\n')
    (tests_dir / "test_x.py").write_text('faults.arm("zz.reference_test", "once")\n')
    (bench_dir / "h.py").write_text('faults.arm("zz.benchmark", "once")\n')
    raw = sorted(f.message.split("'")[1] for f in L.check_chaos_coverage(str(tmp_path)))
    assert raw == ["zz.benchmark", "zz.reasoned", "zz.reference_test"]
    config = L.LintConfig(**{**CONFIG_KW, "tree_checks": True, "repo_root": str(tmp_path)})
    piped = [f for f in L.lint_paths([str(faults_dir / "__init__.py")], config)
             if f.check == "chaos-coverage"]
    assert sorted(f.message.split("'")[1] for f in piped) == ["zz.benchmark", "zz.reference_test"]
    assert all(f.line > 0 for f in piped)


def test_never_emitted_metric_anchors_on_its_declaration(tmp_path):
    obs_dir = tmp_path / "tpubloom_torch" / "obs"
    obs_dir.mkdir(parents=True)
    names = obs_dir / "names.py"
    names.write_text(
        "COUNTERS = (\n"
        '    "used",\n'
        '    "stale",\n'
        '    "kept",  # lint: allow(metric-registry): parity with the reference\n'
        ")\n"
        "GAUGES = ()\n"
    )
    emit = tmp_path / "emit.py"
    emit.write_text('def f():\n    counters.incr("used")\n')
    config = L.LintConfig(repo_root=str(tmp_path), known_fault_points=frozenset())
    findings = L.lint_paths([str(names), str(emit)], config)
    assert [(f.check, f.line) for f in findings] == [("metric-registry", 3)]
    assert "'stale'" in findings[0].message


def test_port_registries_keep_the_reference_vocabulary():
    """The port's fault points and metric names are the reference's (its
    /metrics and TPUBLOOM_FAULTS vocabulary), so the allows on names the
    port never emits are what keeps its lint green."""
    port_root = REPO
    assert L.load_fault_points(port_root) == JL.load_fault_points(port_root)
    assert L.load_metric_names(port_root)[:2] == JL.load_metric_names(port_root)[:2]


# -- the lock-order manifest ----------------------------------------------------------


def test_manifest_differs_from_the_reference_only_where_named():
    ref, port = jlock_order.ALLOWED_EDGES, lock_order.ALLOWED_EDGES
    assert port <= ref
    assert ref - port == set(lock_order.DIFFERS_FROM_REFERENCE)
    assert all(reason.strip() for reason in lock_order.DIFFERS_FROM_REFERENCE.values())
    # the one difference: no such lock class exists in the port
    for root, _, files in os.walk(os.path.join(REPO, "tpubloom_torch")):
        for fn in files:
            if fn.endswith(".py") and root != os.path.join(REPO, "tpubloom_torch", "analysis"):
                with open(os.path.join(root, fn), encoding="utf-8") as f:
                    assert '"native.build"' not in f.read(), fn


def test_armed_ingest_and_oplog_scenario_mints_only_declared_edges(tmp_path):
    """A port server with the coalescer and an op log, its locks tracked
    (``TPUBLOOM_LOCK_CHECK``'s in-process switch), takes inserts, deletes
    and queries; its acquisition graph has edges, all declared, and no
    violation."""
    from tpubloom_torch import checkpoint as ck
    from tpubloom_torch.obs import counters
    from tpubloom_torch.repl import OpLog
    from tpubloom_torch.server.client import BloomClient
    from tpubloom_torch.server.ingest import CoalesceConfig
    from tpubloom_torch.server.service import BloomService, build_server
    from tpubloom_torch.utils import locks

    locks.set_enabled(True)
    locks.reset()
    log = srv = svc = None
    try:
        log = OpLog(str(tmp_path / "log"))
        svc = BloomService(oplog=log, device="cpu",
                           coalesce=CoalesceConfig(max_keys=1024, max_wait_us=1000),
                           sink_factory=lambda c: ck.FileSink(str(tmp_path / "ckpt")))
        srv, port = build_server(svc, "127.0.0.1:0")
        srv.start()
        with BloomClient(f"127.0.0.1:{port}") as c:
            c.create_filter("cnt", capacity=10_000, error_rate=0.01, counting=True)
            keys = [b"lk-%05d" % i for i in range(300)]
            c.insert_batch("cnt", keys)
            assert c.include_batch("cnt", keys).all()
            c.delete_batch("cnt", keys)
            assert not c.include_batch("cnt", keys).any()
        edges = {(e["from"], e["to"]) for e in locks.report()["edges"]}
        assert ("filter.op", "repl.oplog") in edges, edges
        assert lock_order.check_live() == []
        assert locks.violations() == []
    finally:
        if srv is not None:
            srv.stop(grace=None)
        if svc is not None:
            svc.shutdown()
        if log is not None:
            log.close()
        locks.set_enabled(None)
        locks.reset()
        counters.reset_for_tests()


def test_version_is_the_reference_version():
    assert tpubloom_torch.__version__ == tpubloom.__version__ == "0.1.0"
    assert "__version__" in tpubloom_torch.__all__


# -- the profiler-range registry ------------------------------------------------------

RANGE_CONFIG = dict(tree_checks=False, known_fault_points=frozenset(), counters=frozenset(),
                    gauges=frozenset(), ranges=frozenset({"filter.clear", "sweep.plan"}),
                    range_prefixes=("sweep.", "phase."))


@pytest.mark.parametrize("call,flagged", [
    ('obs.Range("tpubloom_torch.filter.clear")', False),
    ('obs.Range("tpubloom_torch.sweep.flat_query")', False),  # the declared prefix
    ('span.child("tpubloom_torch.sweep.plan")', False),
    ('obs.Range(f"tpubloom_torch.phase.{name}")', False),
    ("obs.Range(name)", False),  # a caller's own name, as annotate passes on
    ("span.child(None)", False),
    ('obs.Range("tpubloom_torch.filter.bogus")', True),  # undeclared
    ('obs.Range("filter.clear")', True),  # not under the package's name
    ('span.child("tpubloom_torch.kernel.plan")', True),
    ('obs.Range(f"tpubloom_torch.kernel.{name}")', True),  # undeclared dynamic head
])
def test_range_registry_flags_an_undeclared_range(call, flagged, tmp_path):
    path = tmp_path / "fixture.py"
    path.write_text(f"def f(obs, span, name):\n    {call}\n")
    checks = [f.check for f in L.lint_paths([str(path)], L.LintConfig(**RANGE_CONFIG))]
    assert checks == (["range-registry"] if flagged else [])


def test_range_registry_flags_a_declared_range_never_opened(tmp_path):
    obs_dir = tmp_path / "tpubloom_torch" / "obs"
    obs_dir.mkdir(parents=True)
    names = obs_dir / "names.py"
    names.write_text('RANGES = (\n    "filter.used",\n    "filter.stale",\n)\n'
                     'RANGE_DYNAMIC_PREFIXES = (("sweep.", "wrappers"), ("gone.", "none"))\n')
    emit = tmp_path / "emit.py"
    emit.write_text('def f(obs):\n    obs.Range("tpubloom_torch.filter.used")\n'
                    '    obs.Range("tpubloom_torch.sweep.flat_query")\n')
    config = L.LintConfig(repo_root=str(tmp_path), known_fault_points=frozenset())
    found = [f for f in L.lint_paths([str(names), str(emit)], config) if f.check == "range-registry"]
    assert sorted(f.message.split("'")[1] for f in found) == ["filter.stale", "gone."]
