"""Static concurrency/consistency lint for the tpubloom_torch tree.

A stdlib-only copy of ``tpubloom/analysis/lint.py`` aimed at the port:
``python -m tpubloom_torch.analysis.lint [paths...]`` (default: the
``tpubloom_torch/`` package) runs the same AST-based checkers, reading
the port's own registries (``tpubloom_torch/faults``,
``tpubloom_torch/obs/names.py``, ``tpubloom_torch/server/{protocol,
service,client}.py``) and crediting fault-point arming only to the
port's own harness (``tests/test_torch_*.py`` and ``chip_smoke.py``).
Exit status 0 = clean, 1 = findings.

Checks
======

``blocking-under-lock``
    No blocking call — gRPC stubs (``_rpc``/``_call``/``_node``/
    ``_peer``/``grpc.insecure_channel``), ``Condition.wait`` without a
    timeout, fsync/flush/checkpoint IO (``os.fsync``, ``.flush()``,
    ``ckpt.restore``/``_tracked_restore``, ``checkpointer.close``),
    ``time.sleep``, thread/worker ``join``, ``Future.result`` —
    lexically inside a ``with`` on a registry/filter/admission mutex
    or a lock-named condition (attributes like ``lock``, ``_lock``,
    ``_cond``, ``_admit_lock`` ...). Quorum waits moved to their own
    ``barrier-outside-lock`` check. The runtime half of this check is
    :func:`tpubloom_torch.utils.locks.note_blocking`.

``notify-before-append``
    In any function that both appends to the op log (``_log_op`` /
    ``_log_create`` / ``oplog.append``) and calls
    ``checkpointer.notify_inserts``, every notify must come AFTER the
    first append: a checkpoint triggered by its own batch must stamp
    that batch's seq (the crash-replay bug class).

``fault-registry``
    Every literal fault-point string passed to ``faults.fire`` /
    ``arm`` / ``is_armed`` is declared in ``faults.KNOWN_POINTS`` —
    and (tree mode) every declared point appears as a literal somewhere
    outside the registry, so the vocabulary cannot rot.

``metric-registry``
    Every literal counter/gauge name emitted via ``counters.incr`` /
    ``metrics.count`` / ``counters.set_gauge`` is declared in
    :mod:`tpubloom_torch.obs.names` under the right kind; (tree mode) every
    declared name is emitted at least once, and no name is declared
    twice or under both kinds.

``protocol-coverage``
    (tree mode) Every ``protocol.METHODS`` entry has a ``BloomService``
    handler, a client call site, and a golden-wire test (the port's,
    ``tests/test_torch_server_golden.py``); streaming methods are
    registered in the service behavior maps and golden-tested.

``ruby-parity``
    (tree mode) The Ruby drivers track the protocol too: every ``protocol.METHODS`` entry appears
    as a quoted call-site literal somewhere in ``clients/ruby``'s
    driver files, the base driver's ``METHODS`` registry constant
    matches the protocol list exactly (no drift in either direction),
    and the registry lists nothing the protocol dropped.

``donation-safety``
    A name passed at a donated position of a donating call — a callable
    built by ``jax.jit(..., donate_argnums=...)`` or ``pl.pallas_call(
    ..., input_output_aliases=...)`` — must not be referenced after the
    call in the same function unless it was rebound first: donation
    deletes the buffer on device, so a later use raises (best case) or
    reads freed memory through a stale handle (the ``InFlight`` fence
    bug class: a later donating kernel deleted the fenced handle). The
    port builds no donating callable, so on its tree this check finds
    nothing; it stays so that one ever added is checked.

``replay-safety``
    (tree mode) Every ``protocol.MUTATING_METHODS`` handler on
    ``BloomService`` must touch the rid→response dedup cache
    (``_dedup_get``/``_dedup_put``) — a mutating response that is not
    replay-cached turns a client retry into a second apply (the
    double-apply class: counting filters double-increment,
    presence replays report the batch's own keys). Handlers whose
    replay provably converges carry a reasoned suppression on the
    ``def`` line instead.

``barrier-outside-lock``
    ``commit_barrier`` / ``wait_acked`` lexically under a registry/
    filter/admission lock ``with``. The invariant: the commit barrier runs in the RPC wrapper AFTER the
    handler, outside every lock — a quorum wait under the filter lock
    would stall every other writer (and the ack path it waits on) for
    the full barrier budget.

``chaos-coverage``
    (tree mode) Every ``faults.KNOWN_POINTS`` entry is ARMED by literal
    in the port's own harness — via ``faults.arm("point", ...)`` or a
    ``TPUBLOOM_FAULTS``-syntax string (``"point=policy"``) in
    ``tests/test_torch_*.py`` or ``chip_smoke.py``. The reference's
    tests arm the same names against ``tpubloom``; they drive none of
    the port's failure paths, so they earn no credit here. A
    declared-but-never-armed point is dead chaos surface: the failure
    path it guards has never actually been driven. Suppress (with a reason) on the point's
    ``KNOWN_POINTS`` line.

``phase-registry``
    Every literal phase name passed to ``obs.phase(...)`` /
    ``ctx.add_phase(...)`` is declared in
    :data:`tpubloom_torch.obs.names.PHASES`; dynamic (f-string) phase
    names must start with a declared :data:`tpubloom_torch.obs.names.
    PHASE_DYNAMIC_PREFIXES` prefix (``kernel_shard<i>``); (tree mode)
    every declared phase/prefix is emitted somewhere — the
    counter-registry pattern extended to the phase vocabulary so
    dashboards and the slowlog keep lining up.

``trace-registry``
    The same closure for the distributed-tracing span
    vocabulary and the flight-recorder event vocabulary: every literal
    name at a ``trace.span(...)`` / ``trace.record_span(...)`` site is
    declared in :data:`tpubloom_torch.obs.names.SPANS` (f-string heads
    must match :data:`tpubloom_torch.obs.names.SPAN_DYNAMIC_PREFIXES` —
    ``rpc.<Method>``, ``phase.<name>``), every ``flight.note(...)``
    kind is declared in :data:`tpubloom_torch.obs.names.EVENTS`, and (tree
    mode) every declared span/prefix/event has an emit site — a
    TraceGet tree and a flight dump must never contain a name the
    catalog cannot explain, and the catalog cannot rot.

``range-registry``
    The same closure for the profiler ranges: every literal name (or
    f-string head) at a ``Range(...)`` / ``.child(...)`` site is
    ``tpubloom_torch.`` followed by a name declared in
    :data:`tpubloom_torch.obs.names.RANGES` or a head matching
    :data:`tpubloom_torch.obs.names.RANGE_DYNAMIC_PREFIXES`
    (``sweep.<wrapper>``, ``phase.<name>``), and (tree mode) every
    declared range/prefix has an emit site — a profiler trace of the
    port never holds a range the catalog cannot explain.

Suppressions
============

A finding is allowlisted inline, on the flagged line or its enclosing
``with`` line::

    mf.checkpointer.close()  # lint: allow(blocking-under-lock): unpublished

The reason is mandatory: an empty reason is itself a finding
(``suppression-reason``), as are suppressions naming unknown checks
(``unknown-suppression``) and suppressions that no longer match any
finding (``unused-suppression``) — allowlists cannot rot either.
"""

from __future__ import annotations

import argparse
import ast
import glob
import json
import os
import re
import sys
from dataclasses import dataclass, field
from typing import Iterable, Optional

CHECKS = (
    "blocking-under-lock",
    "notify-before-append",
    "fault-registry",
    "metric-registry",
    "protocol-coverage",
    "ruby-parity",
    "donation-safety",
    "replay-safety",
    "barrier-outside-lock",
    "chaos-coverage",
    "phase-registry",
    "trace-registry",
    "range-registry",
    "suppression-reason",
    "unknown-suppression",
    "unused-suppression",
)

#: ``with`` context attributes treated as "a lock is held inside".
LOCK_ATTRS = frozenset(
    {
        "lock",
        "_lock",
        "_cond",
        "_admit_lock",
        "_promote_lock",
        "_dedup_lock",
        "_trigger_lock",
        "_call_lock",
    }
)

#: Method names that are blocking wherever they appear.
BLOCKING_METHOD_NAMES = frozenset(
    {"_tracked_restore", "_rpc", "_node", "_peer", "result", "flush"}
)

#: Quorum-barrier calls: under a lock these get their own check
#: (``barrier-outside-lock``): the commit barrier runs
#: in the RPC wrapper AFTER the handler, outside every lock.
BARRIER_METHOD_NAMES = frozenset({"wait_acked", "commit_barrier"})

#: Fully dotted calls that are blocking.
BLOCKING_DOTTED = frozenset(
    {
        "os.fsync",
        "time.sleep",
        "subprocess.run",
        "subprocess.check_call",
        "subprocess.check_output",
        "grpc.insecure_channel",
    }
)

SUPPRESS_RE = re.compile(
    r"#\s*lint:\s*allow\(\s*(?P<checks>[a-z-]+(?:\s*,\s*[a-z-]+)*)\s*\)\s*"
    r"(?::\s*(?P<reason>.*))?$"
)


@dataclass
class Finding:
    check: str
    path: str
    line: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.check}] {self.message}"

    def to_dict(self) -> dict:
        return {
            "check": self.check,
            "path": self.path,
            "line": self.line,
            "message": self.message,
        }


@dataclass
class LintConfig:
    """Knobs for testability: the seeded-violation fixtures inject tiny
    registries instead of the real ones, and disable tree mode."""

    #: declared fault points (None = parse ``tpubloom_torch/faults``)
    known_fault_points: Optional[frozenset] = None
    #: declared metric names (None = parse ``tpubloom_torch/obs/names.py``)
    counters: Optional[frozenset] = None
    gauges: Optional[frozenset] = None
    #: declared phase vocabulary (None = parse ``tpubloom_torch/obs/names.py``)
    phases: Optional[frozenset] = None
    phase_prefixes: Optional[tuple] = None
    #: declared span/event vocabularies (``trace-registry``;
    #: None = parse ``tpubloom_torch/obs/names.py``)
    spans: Optional[frozenset] = None
    span_prefixes: Optional[tuple] = None
    events: Optional[frozenset] = None
    #: declared profiler-range vocabulary (``range-registry``; None =
    #: parse ``tpubloom_torch/obs/names.py``)
    ranges: Optional[frozenset] = None
    range_prefixes: Optional[tuple] = None
    #: run the cross-file tree checks (protocol coverage + reverse
    #: registry checks) against ``repo_root``
    tree_checks: bool = True
    repo_root: Optional[str] = None
    #: check names to skip entirely
    disable: frozenset = field(default_factory=frozenset)


#: the package this lint is aimed at, relative to the repo root: its
#: registries are read from there and ``python -m`` lints it by default
PACKAGE = "tpubloom_torch"
#: what every profiler range of the package is named under
RANGE_PREFIX = PACKAGE + "."


def _repo_root() -> str:
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


def _pkg_path(repo_root: str, *parts: str) -> str:
    """A file of the :data:`PACKAGE` tree under ``repo_root``."""
    return os.path.join(repo_root, PACKAGE, *parts)


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted rendering of a call target ('self.mf.lock')."""
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - unparse is total on 3.9+
        return "?"


# -- suppression handling -----------------------------------------------------


class _Suppressions:
    """Inline ``# lint: allow(check): reason`` comments for one file.
    Parsed from real COMMENT tokens (``tokenize``), so a docstring that
    merely *shows* the syntax is not a suppression."""

    def __init__(self, path: str, source: str, findings: list):
        import io
        import tokenize

        #: line -> {check -> reason}
        self.by_line: dict = {}
        self.used: set = set()
        comments = []
        try:
            for tok in tokenize.generate_tokens(io.StringIO(source).readline):
                if tok.type == tokenize.COMMENT:
                    comments.append((tok.start[0], tok.string))
        except tokenize.TokenizeError:  # pragma: no cover - parse already ran
            pass
        for lineno, text in comments:
            m = SUPPRESS_RE.search(text)
            if not m:
                continue
            checks = [c.strip() for c in m.group("checks").split(",")]
            reason = (m.group("reason") or "").strip()
            for check in checks:
                if check not in CHECKS:
                    findings.append(
                        Finding(
                            "unknown-suppression", path, lineno,
                            f"allow({check}) names no known check "
                            f"(known: {', '.join(CHECKS)})",
                        )
                    )
                    continue
                if not reason:
                    findings.append(
                        Finding(
                            "suppression-reason", path, lineno,
                            f"allow({check}) carries no reason — every "
                            f"suppression must say why it is safe",
                        )
                    )
                    continue
                self.by_line.setdefault(lineno, {})[check] = reason

    def matches(self, check: str, *lines: int) -> bool:
        for line in lines:
            if check in self.by_line.get(line, {}):
                self.used.add((line, check))
                return True
        return False

    def unused(self, path: str) -> list:
        out = []
        for line, checks in sorted(self.by_line.items()):
            for check in checks:
                if (line, check) not in self.used:
                    out.append(
                        Finding(
                            "unused-suppression", path, line,
                            f"allow({check}) matches no finding on this "
                            f"line — remove it or fix the anchor",
                        )
                    )
        return out


# -- per-file checkers --------------------------------------------------------


def _is_lock_with_item(item: ast.withitem) -> Optional[str]:
    ctx = item.context_expr
    if isinstance(ctx, ast.Attribute) and ctx.attr in LOCK_ATTRS:
        return _dotted(ctx)
    return None


def _barrier_name(call: ast.Call) -> Optional[str]:
    """Dotted rendering of a quorum-barrier call, else None."""
    func = call.func
    if isinstance(func, ast.Attribute) and func.attr in BARRIER_METHOD_NAMES:
        return f"{_dotted(func.value)}.{func.attr}"
    if isinstance(func, ast.Name) and func.id in BARRIER_METHOD_NAMES:
        return func.id
    return None


def _blocking_reason(call: ast.Call) -> Optional[str]:
    func = call.func
    if isinstance(func, ast.Attribute):
        attr = func.attr
        recv = _dotted(func.value)
        dotted = f"{recv}.{attr}"
        if dotted in BLOCKING_DOTTED:
            return f"{dotted}() blocks on IO/sleep"
        if attr in BLOCKING_METHOD_NAMES:
            return f"{dotted}() is a blocking call"
        low = recv.lower()
        if attr in ("wait", "wait_for") and (
            "cond" in low or low.endswith("condition")
        ):
            has_timeout = any(k.arg == "timeout" for k in call.keywords)
            n_args = len(call.args)
            bounded = has_timeout or (
                n_args >= (2 if attr == "wait_for" else 1)
            )
            if not bounded:
                return f"{dotted}() waits without a timeout"
            return None  # a bounded wait on the cond's own lock is fine
        if attr == "close" and "checkpointer" in low:
            return f"{dotted}() flushes + joins the checkpoint worker"
        if attr == "restore" and ("ckpt" in low or "checkpoint" in low):
            return f"{dotted}() reads checkpoint blobs from the sink"
        if attr == "join" and any(
            t in low for t in ("thread", "worker", "proc")
        ):
            return f"{dotted}() joins a thread"
    elif isinstance(func, ast.Name) and func.id in ("fsync", "sleep"):
        return f"{func.id}() blocks on IO/sleep"
    return None


class _FileVisitor(ast.NodeVisitor):
    """Single pass per file: lock-region blocking calls, notify-vs-append
    ordering, and literal fault/metric usage collection."""

    def __init__(self, path: str, config: LintConfig):
        self.path = path
        self.config = config
        self.findings: list = []
        #: stack of (lock_expr, with_lineno) for enclosing lock withs
        self._locks: list = []
        #: per-function ordering state stack
        self._funcs: list = []
        #: (name, kind, line) literal metric emissions
        self.metric_uses: list = []
        #: (point, line) literal fault-point usages
        self.fault_uses: list = []
        #: (name, line) literal phase emissions (obs.phase / add_phase)
        self.phase_uses: list = []
        #: (literal-prefix, line) dynamic (f-string) phase emissions
        self.phase_dynamic_uses: list = []
        #: (name, line) literal span emissions (trace.span /
        #: trace.record_span — incl. trace.py's own bare record_span
        #: calls) — ``trace-registry``
        self.span_uses: list = []
        #: (literal-prefix, line) dynamic (f-string) span emissions
        self.span_dynamic_uses: list = []
        #: (kind, line) literal flight-recorder events (flight.note)
        self.event_uses: list = []
        #: (name, line) literal profiler-range names (Range / .child),
        #: and (literal head, line) of the f-string ones — ``range-registry``
        self.range_uses: list = []
        self.range_dynamic_uses: list = []
        #: every string constant in the file (reverse fault check)
        self.str_constants: set = set()

    # -- traversal ----------------------------------------------------------

    def visit_With(self, node: ast.With) -> None:
        pushed = 0
        for item in node.items:
            lock = _is_lock_with_item(item)
            if lock is not None:
                self._locks.append((lock, node.lineno))
                pushed += 1
        self.generic_visit(node)
        for _ in range(pushed):
            self._locks.pop()

    def _visit_func(self, node) -> None:
        self._funcs.append({"appends": [], "notifies": []})
        # a nested function does not inherit the enclosing lock region:
        # it runs when CALLED, not where it is defined
        saved, self._locks = self._locks, []
        self.generic_visit(node)
        self._locks = saved
        state = self._funcs.pop()
        first_append = min(state["appends"], default=None)
        for line in state["notifies"]:
            if first_append is not None and line < first_append:
                f = Finding(
                    "notify-before-append", self.path, line,
                    "notify_inserts before the op-log append: a "
                    "checkpoint triggered by this batch would stamp a "
                    "repl_seq that misses the batch's own record "
                    "(crash-replay double-apply)",
                )
                if not self._suppressed(f):
                    self.findings.append(f)

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_Constant(self, node: ast.Constant) -> None:
        if isinstance(node.value, str):
            self.str_constants.add(node.value)

    def visit_Call(self, node: ast.Call) -> None:
        self._check_blocking(node)
        self._collect_ordering(node)
        self._collect_fault_use(node)
        self._collect_metric_use(node)
        self._collect_phase_use(node)
        self._collect_trace_use(node)
        self._collect_range_use(node)
        self.generic_visit(node)

    # -- checks -------------------------------------------------------------

    def _suppressed(self, finding: Finding, extra_lines: Iterable[int] = ()) -> bool:
        # resolved later, once the suppression table exists — buffer the
        # candidate lines on the finding
        finding._lines = (finding.line, *extra_lines)  # type: ignore[attr-defined]
        return False

    def _check_blocking(self, node: ast.Call) -> None:
        if not self._locks:
            return
        lock, with_line = self._locks[-1]
        barrier = _barrier_name(node)
        if barrier is not None:
            f = Finding(
                "barrier-outside-lock", self.path, node.lineno,
                f"{barrier}() runs a quorum barrier while holding "
                f"{lock!r} (with at line {with_line}) — the "
                f"invariant: commit barriers run in the RPC wrapper "
                f"AFTER the handler, outside every lock, or one slow "
                f"quorum stalls every other writer on this filter",
            )
            self._suppressed(f, (with_line,))
            self.findings.append(f)
            return
        reason = _blocking_reason(node)
        if reason is None:
            return
        f = Finding(
            "blocking-under-lock", self.path, node.lineno,
            f"{reason} while holding {lock!r} (with at line {with_line})",
        )
        self._suppressed(f, (with_line,))
        self.findings.append(f)

    def _collect_ordering(self, node: ast.Call) -> None:
        if not self._funcs or not isinstance(node.func, ast.Attribute):
            return
        attr = node.func.attr
        recv = _dotted(node.func.value).lower()
        state = self._funcs[-1]
        if attr in ("_log_op", "_log_create") or (
            attr in ("append", "append_record") and "log" in recv
        ):
            state["appends"].append(node.lineno)
        elif attr == "notify_inserts":
            state["notifies"].append(node.lineno)

    def _collect_fault_use(self, node: ast.Call) -> None:
        if not isinstance(node.func, ast.Attribute):
            return
        if node.func.attr not in ("fire", "arm", "is_armed"):
            return
        recv = _dotted(node.func.value)
        if "faults" not in recv:
            return
        if node.args and isinstance(node.args[0], ast.Constant) and isinstance(
            node.args[0].value, str
        ):
            self.fault_uses.append((node.args[0].value, node.lineno))

    def _collect_metric_use(self, node: ast.Call) -> None:
        if not isinstance(node.func, ast.Attribute):
            return
        attr = node.func.attr
        if attr not in ("incr", "count", "set_gauge"):
            return
        recv = _dotted(node.func.value).lower()
        if attr == "incr" and "counter" not in recv:
            return
        if attr == "count" and "metrics" not in recv:
            return
        if not (
            node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            return  # dynamic name: declared via DYNAMIC_PREFIXES instead
        kind = "gauge" if attr == "set_gauge" else "counter"
        self.metric_uses.append((node.args[0].value, kind, node.lineno))

    def _collect_phase_use(self, node: ast.Call) -> None:
        """Literal/dynamic phase names at ``obs.phase(...)`` /
        ``ctx.add_phase(...)`` sites (``phase-registry``)."""
        if not isinstance(node.func, ast.Attribute):
            return
        if node.func.attr not in ("phase", "add_phase") or not node.args:
            return
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            self.phase_uses.append((arg.value, node.lineno))
        elif isinstance(arg, ast.JoinedStr):
            head = ""
            if arg.values and isinstance(arg.values[0], ast.Constant):
                head = str(arg.values[0].value)
            self.phase_dynamic_uses.append((head, node.lineno))

    def _collect_trace_use(self, node: ast.Call) -> None:
        """Literal/dynamic span names at ``trace.span(...)`` /
        ``trace.record_span(...)`` sites and event kinds at
        ``flight.note(...)`` sites (``trace-registry``). The
        trace module's own internal minting calls ``record_span`` as a
        bare name — accepted too (the name is distinctive), so the
        ``rpc.``/``phase.`` prefixes have visible emit sites."""
        func = node.func
        if isinstance(func, ast.Attribute):
            attr = func.attr
            recv = _dotted(func.value).lower()
        elif isinstance(func, ast.Name):
            attr = func.id
            recv = None
        else:
            return
        if not node.args:
            return
        arg = node.args[0]
        if attr in ("span", "record_span"):
            if recv is not None and "trace" not in recv:
                return
            if recv is None and attr != "record_span":
                return  # a bare span() is too generic to claim
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                self.span_uses.append((arg.value, node.lineno))
            elif isinstance(arg, ast.JoinedStr):
                head = ""
                if arg.values and isinstance(arg.values[0], ast.Constant):
                    head = str(arg.values[0].value)
                self.span_dynamic_uses.append((head, node.lineno))
        elif attr == "note":
            if recv is None or "flight" not in recv:
                return
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                self.event_uses.append((arg.value, node.lineno))

    def _collect_range_use(self, node: ast.Call) -> None:
        """Literal/f-string names at ``Range(...)`` / ``.child(...)``
        sites (``range-registry``); a name held in a variable (a
        caller's own, as ``utils.tracing.annotate`` passes on) is not
        claimed."""
        func = node.func
        name = func.id if isinstance(func, ast.Name) else getattr(func, "attr", None)
        if name not in ("Range", "child") or not node.args:
            return
        if name == "child" and not isinstance(func, ast.Attribute):
            return
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            self.range_uses.append((arg.value, node.lineno))
        elif isinstance(arg, ast.JoinedStr):
            head = ""
            if arg.values and isinstance(arg.values[0], ast.Constant):
                head = str(arg.values[0].value)
            self.range_dynamic_uses.append((head, node.lineno))


# -- donation safety ----------------------------------------------------------


def _donated_indices(call: ast.Call) -> tuple:
    """Donated positional-arg indices declared on a ``jax.jit(...,
    donate_argnums=...)`` / ``pl.pallas_call(..., input_output_aliases=
    {in_idx: out_idx, ...})`` construction, else ``()``."""
    for kw in call.keywords:
        if kw.arg == "input_output_aliases" and isinstance(kw.value, ast.Dict):
            return tuple(
                k.value
                for k in kw.value.keys
                if isinstance(k, ast.Constant) and isinstance(k.value, int)
            )
        if kw.arg == "donate_argnums":
            v = kw.value
            if isinstance(v, ast.Constant) and isinstance(v.value, int):
                return (v.value,)
            if isinstance(v, (ast.Tuple, ast.List)):
                return tuple(
                    e.value
                    for e in v.elts
                    if isinstance(e, ast.Constant) and isinstance(e.value, int)
                )
    return ()


def _collect_donating_callees(tree: ast.AST) -> dict:
    """``{dotted-callee: (donated indices,)}`` for every assignment in
    the file whose value is a donating construction — ``fn = pl.
    pallas_call(..., input_output_aliases=...)`` in a kernel factory,
    ``self._insert = jax.jit(..., donate_argnums=0)`` in a filter class.
    Keyed on the rendered target (``fn``, ``self._insert``) so calls
    through the same spelling anywhere in the file resolve."""
    out: dict = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign) or not isinstance(
            node.value, ast.Call
        ):
            continue
        idxs = _donated_indices(node.value)
        if not idxs:
            continue
        for t in node.targets:
            if isinstance(t, (ast.Name, ast.Attribute)):
                out[_dotted(t)] = idxs
    return out


def _binding_lines(func: ast.AST, expr: str) -> list:
    """Line numbers where ``expr`` (a dotted name) is (re)bound inside
    ``func`` — assignment targets incl. tuple unpacking, aug-assign,
    for-loop targets, ``with ... as`` — i.e. the points after which a
    previously donated buffer name holds a FRESH value again."""
    lines = []

    def targets_of(node):
        if isinstance(node, ast.Assign):
            return node.targets
        if isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            return [node.target]
        if isinstance(node, ast.For):
            return [node.target]
        if isinstance(node, ast.withitem) and node.optional_vars is not None:
            return [node.optional_vars]
        return []

    for node in ast.walk(func):
        for t in targets_of(node):
            for sub in ast.walk(t):
                if isinstance(sub, (ast.Name, ast.Attribute)) and (
                    _dotted(sub) == expr
                ):
                    lines.append(node.lineno)
    return lines


def check_donation_safety(tree: ast.AST, path: str) -> list:
    """Use-after-donate: a name passed at a donated position and read
    again later in the same function without a rebind in between. The
    donated device buffer is DELETED by the call — the bug class
    where a later donating kernel consumed the handle an in-flight
    fence still held."""
    donating = _collect_donating_callees(tree)
    if not donating:
        return []
    findings: list = []
    funcs = [
        n
        for n in ast.walk(tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]
    for func in funcs:
        for call in ast.walk(func):
            if not isinstance(call, ast.Call):
                continue
            callee = _dotted(call.func)
            idxs = donating.get(callee)
            if not idxs:
                continue
            call_end = call.end_lineno or call.lineno
            for i in idxs:
                if i >= len(call.args):
                    continue
                arg = call.args[i]
                if not isinstance(arg, (ast.Name, ast.Attribute)):
                    continue
                expr = _dotted(arg)
                rebinds = _binding_lines(func, expr)
                for node in ast.walk(func):
                    if not isinstance(node, (ast.Name, ast.Attribute)):
                        continue
                    if not isinstance(getattr(node, "ctx", None), ast.Load):
                        continue
                    if node.lineno <= call_end or _dotted(node) != expr:
                        continue
                    if any(
                        call.lineno <= rb <= node.lineno for rb in rebinds
                    ):
                        continue
                    f = Finding(
                        "donation-safety", path, node.lineno,
                        f"{expr!r} was donated to {callee}() at line "
                        f"{call.lineno} (donated arg {i}) and is read "
                        f"again here without a rebind — donation deletes "
                        f"the device buffer, so this read raises or "
                        f"races freed memory (the InFlight fence "
                        f"class)",
                    )
                    f._lines = (node.lineno, call.lineno)  # type: ignore[attr-defined]
                    findings.append(f)
                    break  # one finding per donated arg per call
    return findings


def _apply_registry_checks(
    visitor: _FileVisitor, config: LintConfig
) -> None:
    """Turn collected fault/metric literal uses into findings against
    the declared registries."""
    if config.known_fault_points is not None:
        known = config.known_fault_points
        for point, line in visitor.fault_uses:
            if point not in known:
                f = Finding(
                    "fault-registry", visitor.path, line,
                    f"fault point {point!r} is not declared in "
                    f"faults.KNOWN_POINTS — a typo'd chaos config would "
                    f"silently inject nothing",
                )
                f._lines = (line,)  # type: ignore[attr-defined]
                visitor.findings.append(f)
    if config.counters is not None and config.gauges is not None:
        for name, kind, line in visitor.metric_uses:
            declared = config.counters if kind == "counter" else config.gauges
            other = config.gauges if kind == "counter" else config.counters
            if name in declared:
                continue
            if name in other:
                msg = (
                    f"metric {name!r} is emitted as a {kind} but declared "
                    f"as the other kind in tpubloom_torch.obs.names"
                )
            else:
                msg = (
                    f"metric {name!r} is not declared in tpubloom_torch.obs.names "
                    f"— every counter/gauge name is registered exactly once"
                )
            f = Finding("metric-registry", visitor.path, line, msg)
            f._lines = (line,)  # type: ignore[attr-defined]
            visitor.findings.append(f)
    if config.phases is not None:
        prefixes = tuple(config.phase_prefixes or ())
        for name, line in visitor.phase_uses:
            if name in config.phases or any(
                name.startswith(p) for p in prefixes
            ):
                continue
            f = Finding(
                "phase-registry", visitor.path, line,
                f"phase {name!r} is not declared in tpubloom_torch.obs.names."
                f"PHASES — the phase vocabulary is central so dashboards, "
                f"bench.py and the slowlog line up",
            )
            f._lines = (line,)  # type: ignore[attr-defined]
            visitor.findings.append(f)
        for head, line in visitor.phase_dynamic_uses:
            if head and any(head.startswith(p) for p in prefixes):
                continue
            f = Finding(
                "phase-registry", visitor.path, line,
                f"dynamic phase name with literal head {head!r} matches "
                f"no declared PHASE_DYNAMIC_PREFIXES entry in "
                f"tpubloom_torch.obs.names — minted phase series need a "
                f"declared shape",
            )
            f._lines = (line,)  # type: ignore[attr-defined]
            visitor.findings.append(f)
    if config.spans is not None:
        sprefixes = tuple(config.span_prefixes or ())
        for name, line in visitor.span_uses:
            if name in config.spans or any(
                name.startswith(p) for p in sprefixes
            ):
                continue
            f = Finding(
                "trace-registry", visitor.path, line,
                f"span {name!r} is not declared in tpubloom_torch.obs.names."
                f"SPANS — the trace vocabulary is central so TraceGet "
                f"trees, /trace and dashboards line up",
            )
            f._lines = (line,)  # type: ignore[attr-defined]
            visitor.findings.append(f)
        for head, line in visitor.span_dynamic_uses:
            if head and any(head.startswith(p) for p in sprefixes):
                continue
            f = Finding(
                "trace-registry", visitor.path, line,
                f"dynamic span name with literal head {head!r} matches "
                f"no declared SPAN_DYNAMIC_PREFIXES entry in "
                f"tpubloom_torch.obs.names — minted span series need a "
                f"declared shape",
            )
            f._lines = (line,)  # type: ignore[attr-defined]
            visitor.findings.append(f)
    if config.ranges is not None:
        rprefixes = tuple(config.range_prefixes or ())
        for name, line in visitor.range_uses:
            short = name[len(RANGE_PREFIX):] if name.startswith(RANGE_PREFIX) else None
            if short is not None and (short in config.ranges or any(
                short.startswith(p) for p in rprefixes
            )):
                continue
            f = Finding(
                "range-registry", visitor.path, line,
                f"profiler range {name!r} is not {RANGE_PREFIX!r} + a name "
                f"declared in tpubloom_torch.obs.names.RANGES — the range "
                f"vocabulary is central so traces and the benchmark's "
                f"readers line up",
            )
            f._lines = (line,)  # type: ignore[attr-defined]
            visitor.findings.append(f)
        for head, line in visitor.range_dynamic_uses:
            short = head[len(RANGE_PREFIX):] if head.startswith(RANGE_PREFIX) else ""
            if short and any(short.startswith(p) for p in rprefixes):
                continue
            f = Finding(
                "range-registry", visitor.path, line,
                f"dynamic profiler range with literal head {head!r} matches "
                f"no declared RANGE_DYNAMIC_PREFIXES entry in "
                f"tpubloom_torch.obs.names — minted ranges need a declared "
                f"shape",
            )
            f._lines = (line,)  # type: ignore[attr-defined]
            visitor.findings.append(f)
    if config.events is not None:
        for kind, line in visitor.event_uses:
            if kind in config.events:
                continue
            f = Finding(
                "trace-registry", visitor.path, line,
                f"flight-recorder event {kind!r} is not declared in "
                f"tpubloom_torch.obs.names.EVENTS — a typo'd kind silently "
                f"mints a series no post-mortem tooling knows",
            )
            f._lines = (line,)  # type: ignore[attr-defined]
            visitor.findings.append(f)


def lint_file(path: str, config: LintConfig) -> tuple:
    """Lint one file; returns (findings, visitor, suppressions). The
    visitor carries the literal collections the tree checks aggregate;
    the suppression table is returned UNRESOLVED for unused-allow
    accounting because tree-level checks (``chaos-coverage``,
    ``replay-safety``) may still claim a file's suppressions after
    every file has been read — :func:`lint_paths` settles them."""
    with open(path, "r", encoding="utf-8") as f:
        source = f.read()
    findings: list = []
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        findings.append(
            Finding("blocking-under-lock", path, e.lineno or 0,
                    f"file does not parse: {e.msg}")
        )
        return findings, None, None
    visitor = _FileVisitor(path, config)
    visitor.visit(tree)
    _apply_registry_checks(visitor, config)
    visitor.findings.extend(check_donation_safety(tree, path))
    sup = _Suppressions(path, source, findings)
    for f in visitor.findings:
        lines = getattr(f, "_lines", (f.line,))
        # claim the suppression BEFORE the disable filter: disabling a
        # check must not orphan its reasoned allows into
        # unused-suppression findings
        if sup.matches(f.check, *lines):
            continue
        if f.check in config.disable:
            continue
        findings.append(f)
    return (
        [f for f in findings if f.check not in config.disable],
        visitor,
        sup,
    )


# -- registry parsing (AST, no heavyweight imports) ---------------------------


def _collection_node(value: ast.AST) -> Optional[ast.AST]:
    """Unwrap ``frozenset({...})`` / ``set([...])`` / ``tuple((...))``
    wrappers down to the literal collection node, if any."""
    if isinstance(value, (ast.Tuple, ast.Set, ast.List)):
        return value
    if (
        isinstance(value, ast.Call)
        and isinstance(value.func, ast.Name)
        and value.func.id in ("frozenset", "set", "tuple", "list")
        and len(value.args) == 1
    ):
        return _collection_node(value.args[0])
    return None


def _parse_string_collection(path: str, target_names: Iterable[str]) -> dict:
    """``{name: [literals...]}`` for module-level assignments of string
    tuples/sets/lists named in ``target_names`` (duplicates preserved;
    ``frozenset({...})``-style wrappers unwrapped)."""
    return {
        name: [v for v, _line in items]
        for name, items in _parse_string_collection_lines(
            path, target_names
        ).items()
    }


def _parse_string_collection_lines(
    path: str, target_names: Iterable[str]
) -> dict:
    """Like :func:`_parse_string_collection` but each entry is
    ``(literal, lineno)`` — tree checks anchor findings (and accept
    suppressions) on the declaration line itself."""
    out: dict = {}
    with open(path, "r", encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    wanted = set(target_names)
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        coll = _collection_node(node.value)
        if coll is None:
            continue
        for t in node.targets:
            if isinstance(t, ast.Name) and t.id in wanted:
                out[t.id] = [
                    (e.value, e.lineno)
                    for e in coll.elts
                    if isinstance(e, ast.Constant) and isinstance(e.value, str)
                ]
    return out


def load_fault_points(repo_root: str) -> frozenset:
    path = _pkg_path(repo_root, "faults", "__init__.py")
    return frozenset(
        _parse_string_collection(path, ("KNOWN_POINTS",)).get(
            "KNOWN_POINTS", ()
        )
    )


def _parse_prefix_heads(path: str, target_name: str) -> tuple:
    """The literal prefix heads of a ``((prefix, why), ...)``-shaped
    module-level assignment (the *_DYNAMIC_PREFIXES declarations)."""
    prefixes = []
    with open(path, "r", encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if isinstance(t, ast.Name) and t.id == target_name:
                coll = _collection_node(node.value)
                for e in (coll.elts if coll is not None else ()):
                    inner = _collection_node(e)
                    if (
                        inner is not None
                        and inner.elts
                        and isinstance(inner.elts[0], ast.Constant)
                        and isinstance(inner.elts[0].value, str)
                    ):
                        prefixes.append(inner.elts[0].value)
    return tuple(prefixes)


def load_phase_names(repo_root: str) -> tuple:
    """(phases, dynamic prefixes) from obs/names.py; empty
    when the catalog is absent (partial fixture trees)."""
    path = _pkg_path(repo_root, "obs", "names.py")
    if not os.path.isfile(path):
        return frozenset(), ()
    decls = _parse_string_collection(path, ("PHASES",))
    phases = frozenset(decls.get("PHASES", ()))
    return phases, _parse_prefix_heads(path, "PHASE_DYNAMIC_PREFIXES")


def load_trace_names(repo_root: str) -> tuple:
    """(spans, span prefixes, events) from obs/names.py;
    empty when the catalog is absent (partial fixture trees)."""
    path = _pkg_path(repo_root, "obs", "names.py")
    if not os.path.isfile(path):
        return frozenset(), (), frozenset()
    decls = _parse_string_collection(path, ("SPANS", "EVENTS"))
    return (
        frozenset(decls.get("SPANS", ())),
        _parse_prefix_heads(path, "SPAN_DYNAMIC_PREFIXES"),
        frozenset(decls.get("EVENTS", ())),
    )


def load_range_names(repo_root: str) -> tuple:
    """(ranges, range prefixes) from obs/names.py; empty when
    the catalog is absent (partial fixture trees)."""
    path = _pkg_path(repo_root, "obs", "names.py")
    if not os.path.isfile(path):
        return frozenset(), ()
    decls = _parse_string_collection(path, ("RANGES",))
    return (frozenset(decls.get("RANGES", ())),
            _parse_prefix_heads(path, "RANGE_DYNAMIC_PREFIXES"))


def load_metric_names(repo_root: str) -> tuple:
    """(counters, gauges, duplicate-findings) from obs/names.py."""
    path = _pkg_path(repo_root, "obs", "names.py")
    decls = _parse_string_collection(path, ("COUNTERS", "GAUGES"))
    counters = decls.get("COUNTERS", [])
    gauges = decls.get("GAUGES", [])
    findings = []
    for kind, names in (("COUNTERS", counters), ("GAUGES", gauges)):
        seen: set = set()
        for n in names:
            if n in seen:
                findings.append(
                    Finding(
                        "metric-registry", path, 0,
                        f"{n!r} is declared twice in {kind} — registered "
                        f"exactly once means once",
                    )
                )
            seen.add(n)
    for n in sorted(set(counters) & set(gauges)):
        findings.append(
            Finding(
                "metric-registry", path, 0,
                f"{n!r} is declared as both a counter and a gauge",
            )
        )
    return frozenset(counters), frozenset(gauges), findings


# -- tree checks --------------------------------------------------------------


def _literal_set(path: str) -> set:
    """Every string constant in a file (cheap containment probe)."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
    except (OSError, SyntaxError):
        return set()
    return {
        n.value
        for n in ast.walk(tree)
        if isinstance(n, ast.Constant) and isinstance(n.value, str)
    }


def _service_handlers(path: str) -> tuple:
    """(method defs on BloomService, keys of the stream behavior maps)."""
    with open(path, "r", encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    handlers: set = set()
    behaviors: set = set()
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == "BloomService":
            handlers = {
                n.name
                for n in node.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            }
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id in (
                    "_STREAM_BEHAVIORS", "_CLIENT_STREAM_BEHAVIORS",
                    "_BIDI_STREAM_BEHAVIORS",
                ):
                    behaviors |= {
                        k.value
                        for k in node.value.keys
                        if isinstance(k, ast.Constant)
                    }
    return handlers, behaviors


#: the golden-wire test of the port's server, relative to the repo root
GOLDEN_TEST = "test_torch_server_golden.py"


def check_protocol_coverage(repo_root: str) -> list:
    """Every METHODS entry: handler + client call + golden test; every
    streaming method: behavior registration + golden test."""
    proto_path = _pkg_path(repo_root, "server", "protocol.py")
    service_path = _pkg_path(repo_root, "server", "service.py")
    if not os.path.isfile(proto_path) or not os.path.isfile(service_path):
        return []  # partial fixture tree: nothing to cross-reference
    decls = _parse_string_collection(
        proto_path,
        (
            "METHODS", "STREAM_METHODS", "CLIENT_STREAM_METHODS",
            "BIDI_STREAM_METHODS",
        ),
    )
    client_path = _pkg_path(repo_root, "server", "client.py")
    golden_path = os.path.join(repo_root, "tests", GOLDEN_TEST)
    handlers, behaviors = _service_handlers(service_path)
    client_lits = _literal_set(client_path)
    golden_lits = _literal_set(golden_path)
    findings = []

    def miss(method: str, what: str) -> None:
        findings.append(
            Finding(
                "protocol-coverage", proto_path, 0,
                f"protocol method {method!r} has no {what}",
            )
        )

    for m in decls.get("METHODS", ()):
        if m not in handlers:
            miss(m, "BloomService handler (def in service.py)")
        if m not in client_lits:
            miss(m, "client call site (literal in client.py)")
        if m not in golden_lits:
            miss(m, f"golden wire test (literal in {GOLDEN_TEST})")
    for m in list(decls.get("STREAM_METHODS", ())) + list(
        decls.get("CLIENT_STREAM_METHODS", ())
    ):
        if m not in behaviors:
            miss(m, "service behavior registration (_*_BEHAVIORS map)")
        if m not in golden_lits:
            miss(m, f"golden wire test (literal in {GOLDEN_TEST})")
    # bidi streams additionally require a Python client call
    # site — unlike ReplStream/ReplAck they are a user-facing surface
    for m in decls.get("BIDI_STREAM_METHODS", ()):
        if m not in behaviors:
            miss(m, "service behavior registration (_*_BEHAVIORS map)")
        if m not in client_lits:
            miss(m, "client call site (literal in client.py)")
        if m not in golden_lits:
            miss(m, f"golden wire test (literal in {GOLDEN_TEST})")
    return findings


#: where the Ruby drivers live, relative to the repo root.
RUBY_DRIVER_DIR = os.path.join(
    "clients", "ruby", "lib", "redis-bloomfilter", "driver"
)

_RUBY_METHODS_RE = re.compile(r"METHODS\s*=\s*%w\[([^\]]*)\]")


def check_ruby_parity(repo_root: str) -> list:
    """Every ``protocol.METHODS`` entry covered by the Ruby drivers: a
    quoted call-site literal in the union of the driver files, plus registry/protocol set equality
    for the base driver's ``METHODS`` constant — so protocol growth
    that forgets the Ruby side fails CI the same way a missing Python
    handler does."""
    proto_path = _pkg_path(repo_root, "server", "protocol.py")
    if not os.path.isfile(proto_path):
        return []  # partial fixture tree
    decls = _parse_string_collection(
        proto_path, ("METHODS", "BIDI_STREAM_METHODS")
    )
    methods = list(decls.get("METHODS", ()))
    bidi = list(decls.get("BIDI_STREAM_METHODS", ()))
    driver_dir = os.path.join(repo_root, RUBY_DRIVER_DIR)
    findings: list = []
    if not methods or not os.path.isdir(driver_dir):
        return findings
    sources: dict[str, str] = {}
    for fn in sorted(os.listdir(driver_dir)):
        if fn.endswith(".rb"):
            path = os.path.join(driver_dir, fn)
            try:
                with open(path, "r", encoding="utf-8") as f:
                    sources[path] = f.read()
            except OSError:
                continue
    if not sources:
        return findings
    all_src = "\n".join(sources.values())
    # only the BASE driver carries the METHODS registry constant the
    # equality check applies to (the cluster driver subclasses it)
    base_path = os.path.join(driver_dir, "jax.rb")
    base_registry = {
        m
        for block in _RUBY_METHODS_RE.findall(sources.get(base_path, ""))
        for m in block.split()
    }
    for m in methods:
        if f'"{m}"' not in all_src and f"'{m}'" not in all_src:
            findings.append(Finding(
                "ruby-parity", base_path, 0,
                f"protocol method {m!r} has no call site in any Ruby "
                f"driver (clients/ruby)",
            ))
        if base_registry and m not in base_registry:
            findings.append(Finding(
                "ruby-parity", base_path, 0,
                f"protocol method {m!r} missing from the Ruby driver's "
                f"METHODS registry",
            ))
    for extra in sorted(base_registry - set(methods)):
        findings.append(Finding(
            "ruby-parity", base_path, 0,
            f"Ruby METHODS registry lists {extra!r}, which is not a "
            f"protocol method — stale registry entry",
        ))
    # bidi stream methods: a call-site literal is required
    # (the registry equality stays METHODS-only — streams dial
    # bidi_streamer paths, not the unary rpc_once table)
    for m in bidi:
        if f'"{m}"' not in all_src and f"'{m}'" not in all_src:
            findings.append(Finding(
                "ruby-parity", base_path, 0,
                f"bidi stream method {m!r} has no call site in any Ruby "
                f"driver (clients/ruby)",
            ))
    return findings


def check_replay_safety(repo_root: str) -> list:
    """Every ``protocol.MUTATING_METHODS`` handler on ``BloomService``
    touches the rid→response dedup cache (``_dedup_get``/``_dedup_put``)
    — the double-apply class: a mutating response that is not
    replay-cached turns a same-rid client retry into a second apply
    (counting filters double-increment, presence replays report the
    batch's own keys as pre-existing). Handlers whose replay provably
    CONVERGES instead carry a reasoned ``# lint: allow(replay-safety)``
    on the ``def`` line — the reason documents the convergence
    argument."""
    proto_path = _pkg_path(repo_root, "server", "protocol.py")
    service_path = _pkg_path(repo_root, "server", "service.py")
    if not os.path.isfile(proto_path) or not os.path.isfile(service_path):
        return []  # partial fixture tree
    mutating = set(
        _parse_string_collection(proto_path, ("MUTATING_METHODS",)).get(
            "MUTATING_METHODS", ()
        )
    )
    findings: list = []
    if not mutating:
        return findings
    with open(service_path, "r", encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=service_path)
    for node in tree.body:
        if not (isinstance(node, ast.ClassDef) and node.name == "BloomService"):
            continue
        for fn in node.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name not in mutating:
                continue
            touches_dedup = any(
                isinstance(c, ast.Call)
                and isinstance(c.func, ast.Attribute)
                and c.func.attr in ("_dedup_get", "_dedup_put")
                for c in ast.walk(fn)
            )
            if touches_dedup:
                continue
            f = Finding(
                "replay-safety", service_path, fn.lineno,
                f"mutating handler {fn.name}() never touches the rid "
                f"dedup cache (_dedup_get/_dedup_put) — a same-rid retry "
                f"of a response that was lost in flight re-applies the "
                f"op (the double-apply class); cache the "
                f"response, or suppress with the convergence argument",
            )
            f._lines = (fn.lineno,)  # type: ignore[attr-defined]
            findings.append(f)
    return findings


#: The port's own harness, where the chaos-coverage check looks for
#: arming sites: the port's test files and its chip script. ``tests/``
#: also holds the reference's tests, which arm the same point names
#: against ``tpubloom`` and so drive none of the port's failure paths.
HARNESS_GLOBS = (os.path.join("tests", "test_torch_*.py"), "chip_smoke.py")


def harness_paths(repo_root: str) -> list:
    """The files of :data:`HARNESS_GLOBS` under ``repo_root``, sorted."""
    return sorted(
        path
        for pattern in HARNESS_GLOBS
        for path in glob.glob(os.path.join(repo_root, pattern))
    )


_FAULT_ENV_RE = re.compile(r"([a-z_]+(?:\.[a-z_]+)+)\s*=")


def _collect_armed_points(paths: list, known: frozenset) -> set:
    """Fault points armed by literal in the given files (or anywhere
    under the given directories): a ``faults.arm("point", ...)`` call, or
    a ``TPUBLOOM_FAULTS``-syntax string constant
    (``"point=policy[,point=policy...]"``)."""
    armed: set = set()
    for path in iter_py_files(paths):
        try:
            with open(path, "r", encoding="utf-8") as f:
                tree = ast.parse(f.read(), filename=path)
        except (OSError, SyntaxError):
            continue
        for node in ast.walk(tree):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "arm"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
            ):
                armed.add(node.args[0].value)
            elif isinstance(node, ast.Constant) and isinstance(
                node.value, str
            ):
                for m in _FAULT_ENV_RE.finditer(node.value):
                    if m.group(1) in known:
                        armed.add(m.group(1))
    return armed


def check_chaos_coverage(repo_root: str) -> list:
    """Every declared fault point is ARMED in at least one file of the
    port's harness: a ``KNOWN_POINTS`` entry nobody ever arms is dead chaos
    surface — the failure path it guards compiles, fires a counter, and
    has never once been driven. Findings anchor on the point's
    declaration line so a reasoned suppression lives next to the
    vocabulary it covers."""
    faults_path = _pkg_path(repo_root, "faults", "__init__.py")
    if not os.path.isfile(faults_path):
        return []  # partial fixture tree
    decls = _parse_string_collection_lines(
        faults_path, ("KNOWN_POINTS",)
    ).get("KNOWN_POINTS", [])
    if not decls:
        return []
    known = frozenset(p for p, _ in decls)
    armed = _collect_armed_points(harness_paths(repo_root), known)
    findings = []
    for point, line in decls:
        if point in armed:
            continue
        f = Finding(
            "chaos-coverage", faults_path, line,
            f"fault point {point!r} is declared but never armed in the "
            f"port's harness (no faults.arm literal, no TPUBLOOM_FAULTS "
            f"string in tests/test_torch_*.py or chip_smoke.py) — dead "
            f"chaos surface: add an armed test or suppress here with the "
            f"reason the path is covered another way",
        )
        f._lines = (line,)  # type: ignore[attr-defined]
        findings.append(f)
    return findings


def iter_py_files(paths: Iterable[str]) -> list:
    out = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = [d for d in dirs if d != "__pycache__"]
            out.extend(
                os.path.join(root, fn) for fn in sorted(files)
                if fn.endswith(".py")
            )
    return out


def _load_suppressions(path: str) -> Optional[_Suppressions]:
    """On-demand suppression table for a file tree checks anchor in but
    the linted path set did not cover (grammar findings dropped — the
    file is not being linted, only consulted)."""
    if not path.endswith(".py") or not os.path.isfile(path):
        return None
    try:
        with open(path, "r", encoding="utf-8") as f:
            return _Suppressions(path, f.read(), [])
    except (OSError, SyntaxError):
        return None


def lint_paths(paths: Iterable[str], config: Optional[LintConfig] = None) -> list:
    config = config or LintConfig()
    repo_root = config.repo_root or _repo_root()
    findings: list = []
    if config.known_fault_points is None:
        config.known_fault_points = load_fault_points(repo_root)
    if config.counters is None or config.gauges is None:
        counters, gauges, dup_findings = load_metric_names(repo_root)
        config.counters = counters
        config.gauges = gauges
        if config.tree_checks:
            findings.extend(dup_findings)
    if config.phases is None:
        config.phases, config.phase_prefixes = load_phase_names(repo_root)
    if config.spans is None or config.events is None:
        spans, span_prefixes, events = load_trace_names(repo_root)
        if config.spans is None:
            config.spans, config.span_prefixes = spans, span_prefixes
        if config.events is None:
            config.events = events
    if config.ranges is None:
        config.ranges, config.range_prefixes = load_range_names(repo_root)

    fault_literal_seen: set = set()
    metric_literal_seen: set = set()
    phase_literal_seen: set = set()
    phase_prefix_seen: set = set()
    span_literal_seen: set = set()
    span_prefix_seen: set = set()
    event_literal_seen: set = set()
    range_literal_seen: set = set()
    range_prefix_seen: set = set()
    fault_registry_path = _pkg_path(repo_root, "faults", "__init__.py")
    names_path = _pkg_path(repo_root, "obs", "names.py")
    #: abspath -> (display path, _Suppressions), settled only after the
    #: tree checks ran; linted_paths bounds unused-allow accounting to
    #: files that actually went through the per-file checks
    sups: dict = {}
    linted_paths: set = set()
    for path in iter_py_files(paths):
        file_findings, visitor, sup = lint_file(path, config)
        findings.extend(file_findings)
        if visitor is None:
            continue
        sups[os.path.abspath(path)] = (path, sup)
        linted_paths.add(os.path.abspath(path))
        if os.path.abspath(path) != os.path.abspath(fault_registry_path):
            fault_literal_seen |= visitor.str_constants
        if os.path.abspath(path) != os.path.abspath(names_path):
            metric_literal_seen |= {n for n, _, _ in visitor.metric_uses}
        phase_literal_seen |= {n for n, _ in visitor.phase_uses}
        phase_prefix_seen |= {h for h, _ in visitor.phase_dynamic_uses if h}
        span_literal_seen |= {n for n, _ in visitor.span_uses}
        span_prefix_seen |= {h for h, _ in visitor.span_dynamic_uses if h}
        event_literal_seen |= {k for k, _ in visitor.event_uses}
        range_literal_seen |= {n[len(RANGE_PREFIX):] for n, _ in visitor.range_uses
                               if n.startswith(RANGE_PREFIX)}
        range_prefix_seen |= {h[len(RANGE_PREFIX):] for h, _ in visitor.range_dynamic_uses
                              if h.startswith(RANGE_PREFIX) and len(h) > len(RANGE_PREFIX)}

    if config.tree_checks:
        tree_findings: list = []
        tree_findings.extend(check_protocol_coverage(repo_root))
        tree_findings.extend(check_ruby_parity(repo_root))
        tree_findings.extend(check_replay_safety(repo_root))
        tree_findings.extend(check_chaos_coverage(repo_root))
        for point in sorted(config.known_fault_points - fault_literal_seen):
            tree_findings.append(
                Finding(
                    "fault-registry", fault_registry_path, 0,
                    f"declared fault point {point!r} is never referenced "
                    f"outside the registry — dead vocabulary",
                )
            )
        # anchored on the declaration line (0 where the catalog is not
        # on disk), so that a reasoned allow lives beside the name
        metric_lines = (
            {
                name: line
                for items in _parse_string_collection_lines(
                    names_path, ("COUNTERS", "GAUGES")
                ).values()
                for name, line in items
            }
            if os.path.isfile(names_path)
            else {}
        )
        for name in sorted(
            (config.counters | config.gauges) - metric_literal_seen
        ):
            f = Finding(
                "metric-registry", names_path, metric_lines.get(name, 0),
                f"declared metric {name!r} is never emitted in the "
                f"linted tree — stale catalog entry",
            )
            f._lines = (f.line,)  # type: ignore[attr-defined]
            tree_findings.append(f)
        for name in sorted(config.phases - phase_literal_seen):
            tree_findings.append(
                Finding(
                    "phase-registry", names_path, 0,
                    f"declared phase {name!r} is never emitted in the "
                    f"linted tree — stale vocabulary entry",
                )
            )
        for prefix in config.phase_prefixes or ():
            if not any(
                h.startswith(prefix) or prefix.startswith(h)
                for h in phase_prefix_seen
            ) and not any(
                n.startswith(prefix) for n in phase_literal_seen
            ):
                tree_findings.append(
                    Finding(
                        "phase-registry", names_path, 0,
                        f"declared dynamic phase prefix {prefix!r} has no "
                        f"emit site in the linted tree — stale "
                        f"vocabulary entry",
                    )
                )
        for name in sorted((config.spans or frozenset()) - span_literal_seen):
            tree_findings.append(
                Finding(
                    "trace-registry", names_path, 0,
                    f"declared span {name!r} is never emitted in the "
                    f"linted tree — stale vocabulary entry",
                )
            )
        for prefix in config.span_prefixes or ():
            if not any(
                h.startswith(prefix) or prefix.startswith(h)
                for h in span_prefix_seen
            ) and not any(
                n.startswith(prefix) for n in span_literal_seen
            ):
                tree_findings.append(
                    Finding(
                        "trace-registry", names_path, 0,
                        f"declared dynamic span prefix {prefix!r} has no "
                        f"emit site in the linted tree — stale "
                        f"vocabulary entry",
                    )
                )
        for name in sorted((config.ranges or frozenset()) - range_literal_seen):
            tree_findings.append(
                Finding(
                    "range-registry", names_path, 0,
                    f"declared profiler range {name!r} is never opened in "
                    f"the linted tree — stale vocabulary entry",
                )
            )
        for prefix in config.range_prefixes or ():
            if not any(
                h.startswith(prefix) or prefix.startswith(h)
                for h in range_prefix_seen
            ) and not any(
                n.startswith(prefix) for n in range_literal_seen
            ):
                tree_findings.append(
                    Finding(
                        "range-registry", names_path, 0,
                        f"declared dynamic range prefix {prefix!r} has no "
                        f"emit site in the linted tree — stale "
                        f"vocabulary entry",
                    )
                )
        for kind in sorted(
            (config.events or frozenset()) - event_literal_seen
        ):
            tree_findings.append(
                Finding(
                    "trace-registry", names_path, 0,
                    f"declared flight-recorder event {kind!r} is never "
                    f"emitted in the linted tree — stale vocabulary "
                    f"entry",
                )
            )
        # tree findings honor inline suppressions at their anchor line
        # (the declaration/def they point at), same grammar as per-file
        for f in tree_findings:
            key = os.path.abspath(f.path)
            entry = sups.get(key)
            if entry is None:
                loaded = _load_suppressions(f.path)
                if loaded is not None:
                    entry = (f.path, loaded)
                    sups[key] = entry
            lines = getattr(f, "_lines", (f.line,))
            # claim BEFORE the disable filter (see lint_file): a
            # disabled check's reasoned allows must not rot into
            # unused-suppression findings
            if entry is not None and entry[1].matches(f.check, *lines):
                continue
            if f.check in config.disable:
                continue
            findings.append(f)
    # unused-allow accounting settles LAST, after tree checks had their
    # chance to claim a file's suppressions — and only for files that
    # actually went through the per-file checks (a merely-consulted
    # file's allows can target checks this run never applied to it)
    for abspath in sorted(linted_paths):
        display, sup = sups[abspath]
        findings.extend(sup.unused(display))
    return [f for f in findings if f.check not in config.disable]


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tpubloom_torch.analysis.lint",
        description="tpubloom_torch project lint: concurrency + registry "
        "invariants",
    )
    parser.add_argument(
        "paths", nargs="*", default=None,
        help="files/directories to lint (default: the tpubloom_torch package)",
    )
    parser.add_argument(
        "--no-tree-checks", action="store_true",
        help="skip the cross-file checks (protocol coverage, reverse "
        "registry checks)",
    )
    parser.add_argument("--json", action="store_true", dest="as_json")
    args = parser.parse_args(argv)
    repo_root = _repo_root()
    paths = args.paths or [os.path.join(repo_root, PACKAGE)]
    # expand once: iter_py_files passes plain files through, so the
    # resolved list is also a valid `paths` for lint_paths
    files = iter_py_files(paths)
    config = LintConfig(tree_checks=not args.no_tree_checks)
    findings = lint_paths(files, config)
    if args.as_json:
        print(json.dumps([f.to_dict() for f in findings], indent=2))
    else:
        for f in findings:
            print(f.format())
        print(
            f"tpubloom_torch.analysis.lint: {len(findings)} finding(s) in "
            f"{len(files)} file(s)"
        )
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
