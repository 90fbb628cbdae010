"""Named lock wrappers + runtime lock-order / held-while-blocking analysis.

A stdlib-only copy of ``tpubloom/utils/locks.py``: the port may not import
``tpubloom`` (its package ``__init__`` imports JAX), and its
:class:`~tpubloom_torch.checkpoint.AsyncCheckpointer` takes the same named
locks and notes the same blocking calls as ``tpubloom``'s, under the same
names and the same ``TPUBLOOM_LOCK_CHECK`` / ``TPUBLOOM_LOCK_CHECK_DIR``
switches.

Once tpubloom became concurrent (op-log appends under filter
locks, commit barriers, ack streams, sentinel elections), and the bug
class that dominated their review was ordering: deadlocks (truncation
sweep re-taking the registry lock), blocking under a lock (barrier
inside the filter lock), and notify-before-log races. Those invariants
were tribal knowledge in CHANGES.md; this module makes them
machine-checked at runtime (the static half lives in
:mod:`tpubloom.analysis.lint`).

Usage — replace bare ``threading`` primitives with NAMED ones::

    self._lock = locks.named_lock("service.registry")
    self._cond = locks.named_condition("repl.oplog")

Names are CLASSES of lock, not instances: every filter's op lock is
``filter.op``. The analysis runs on the name graph, so an ordering
proven between two instances generalizes to all of them — and a
self-edge (``filter.op`` acquired while ``filter.op`` is already held
by the same thread on a *different* instance) is itself a finding: two
threads nesting two filter locks in opposite orders is a deadlock.

Gating: the tracker is armed by the ``TPUBLOOM_LOCK_CHECK`` env var (or
:func:`set_enabled` in tests) **at lock-construction time**. Disarmed —
the normal state — the factories return bare ``threading`` primitives:
the production hot path pays nothing, not even an attribute hop.
Blocking primitives additionally call :func:`note_blocking` at entry;
disarmed that costs one cached-bool check.

What the armed tracker records:

* **acquisition edges** — thread T acquires ``b`` while holding ``a``
  → edge ``a → b`` (with the first acquisition site). A new edge that
  closes a cycle in the name graph is a ``lock-order-cycle`` violation:
  two threads can interleave the two paths into a deadlock.
* **held-while-blocking** — a :meth:`TrackedCondition.wait`/``wait_for``
  while the thread holds any OTHER tracked lock, or a
  :func:`note_blocking` call (gRPC stubs, fsync/checkpoint IO,
  ``wait_acked``) while holding a tracked lock not on the caller's
  ``allow`` list. Allowed holds are recorded as suppressions (with the
  caller's reason) so the report stays auditable.

Reports: :func:`report`/:func:`violations` for in-process asserts (the
chaos suites arm the tracker and assert no violations at teardown); at
process exit a JSON report is written to
``$TPUBLOOM_LOCK_CHECK_DIR/lockcheck-<pid>.json`` (when set) so
subprocess servers in the chaos suites are auditable too, and any
violations are printed to stderr.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import traceback
from typing import Iterable, Optional

ENV_VAR = "TPUBLOOM_LOCK_CHECK"
REPORT_DIR_ENV = "TPUBLOOM_LOCK_CHECK_DIR"

_override: Optional[bool] = None
_env_enabled: Optional[bool] = None


def enabled() -> bool:
    """True iff the tracker is armed (env var, or a test override)."""
    global _env_enabled
    if _override is not None:
        return _override
    if _env_enabled is None:
        _env_enabled = os.environ.get(ENV_VAR, "").strip() not in ("", "0")
    return _env_enabled


def set_enabled(value: Optional[bool]) -> None:
    """Test hook: force the tracker on/off (None = back to the env).
    Only locks CONSTRUCTED while enabled are tracked — arm before
    building the service under test."""
    global _override
    _override = value


def _call_site(skip: int = 3) -> str:
    """``file:line`` of the application frame that triggered a tracker
    event (skipping the tracker's own frames)."""
    for frame in traceback.extract_stack()[-skip - 4 : -skip + 1][::-1]:
        if not frame.filename.endswith("locks.py"):
            return f"{frame.filename}:{frame.lineno}"
    return "?"


class _Tracker:
    """Process-global acquisition-graph recorder (thread-safe; its own
    mutex is a bare ``threading.Lock`` and is never held while an
    application lock is being acquired, so it cannot join a cycle)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._tls = threading.local()
        #: (a, b) -> acquisition count for "b acquired while a held"
        self.edges: dict = {}
        #: (a, b) -> "file:line" of the first time the edge was seen
        self.edge_sites: dict = {}
        self.violations: list = []
        self.suppressed: list = []
        self._seen: set = set()

    # -- per-thread hold stack ------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def held_names(self) -> list:
        """Names of tracked locks the calling thread currently holds
        (outermost first, deduplicated)."""
        out = []
        for name, _oid, _reentrant in self._stack():
            if name not in out:
                out.append(name)
        return out

    def acquiring(self, name: str, oid: int, reentrant: bool) -> None:
        """Called BEFORE the underlying acquire blocks, so the edges (and
        any cycle they close) are recorded even when the acquisition
        deadlocks for real — the exit report then explains the hang."""
        stack = self._stack()
        if not stack:
            return
        site = _call_site()
        with self._mu:
            for held_name, held_oid, _ in stack:
                if held_name == name:
                    if held_oid == oid and reentrant:
                        continue  # RLock/Condition re-entry: fine
                    self._violation(
                        "lock-order-cycle",
                        f"{name!r} acquired while another {name!r} "
                        f"instance is already held — two threads "
                        f"nesting in opposite orders deadlock",
                        site,
                        cycle=[name, name],
                    )
                    continue
                self._add_edge(held_name, name, site)

    def acquired(self, name: str, oid: int, reentrant: bool) -> None:
        self._stack().append((name, oid, reentrant))

    def released(self, name: str, oid: int) -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] == name and stack[i][1] == oid:
                del stack[i]
                return

    # -- graph ---------------------------------------------------------------

    def _add_edge(self, a: str, b: str, site: str) -> None:
        key = (a, b)
        self.edges[key] = self.edges.get(key, 0) + 1
        if key not in self.edge_sites:
            self.edge_sites[key] = site
            cycle = self._find_cycle(b, a)
            if cycle is not None:
                self._violation(
                    "lock-order-cycle",
                    f"acquiring {b!r} while holding {a!r} closes the "
                    f"cycle {' -> '.join(cycle + [cycle[0]])}",
                    site,
                    cycle=cycle,
                )

    def _find_cycle(self, start: str, target: str) -> Optional[list]:
        """Path start -> ... -> target in the edge graph (caller holds
        ``_mu``); the new target->start edge closes it into a cycle."""
        path, seen = [], set()

        def dfs(node: str) -> bool:
            if node == target:
                path.append(node)
                return True
            if node in seen:
                return False
            seen.add(node)
            for (a, b) in self.edges:
                if a == node and dfs(b):
                    path.append(node)
                    return True
            return False

        if dfs(start):
            # path unwinds deepest-first: [target, ..., start] — render
            # the cycle as target -> start -> ... (the new edge closes it)
            return [target] + list(reversed(path))[:-1]
        return None

    # -- blocking checks ------------------------------------------------------

    def waiting(self, name: str, timeout) -> None:
        """A condition named ``name`` is about to wait: holding any OTHER
        tracked lock across the wait is a held-while-blocking violation
        (the wait releases only its own lock). The message carries no
        timeout VALUE: waits in retry loops pass a shrinking remaining
        budget, and a varying repr would defeat the (kind, message)
        dedup and flood the report."""
        others = [h for h in self.held_names() if h != name]
        if others:
            with self._mu:
                self._violation(
                    "held-while-blocking",
                    f"Condition {name!r}.wait() while holding {others}",
                    _call_site(),
                    holding=others,
                )

    def blocking(
        self, op: str, allow: Iterable[str], reason: str
    ) -> None:
        held = self.held_names()
        if not held:
            return
        allow = set(allow)
        bad = [h for h in held if h not in allow]
        with self._mu:
            if bad:
                self._violation(
                    "held-while-blocking",
                    f"blocking op {op!r} while holding {bad}",
                    _call_site(),
                    holding=bad,
                )
            else:
                self.suppressed.append(
                    {
                        "kind": "held-while-blocking",
                        "op": op,
                        "holding": held,
                        "reason": reason,
                        "site": _call_site(),
                    }
                )

    def _violation(self, kind: str, message: str, site: str, **extra) -> None:
        """Record one violation (caller holds ``_mu``), deduplicated by
        (kind, message) so a hot loop reports once, not a million times."""
        key = (kind, message)
        if key in self._seen:
            return
        self._seen.add(key)
        self.violations.append(
            {"kind": kind, "message": message, "site": site, **extra}
        )

    def report(self) -> dict:
        with self._mu:
            return {
                "edges": [
                    {
                        "from": a,
                        "to": b,
                        "count": n,
                        "first_site": self.edge_sites.get((a, b)),
                    }
                    for (a, b), n in sorted(self.edges.items())
                ],
                "violations": list(self.violations),
                "suppressed": list(self.suppressed),
            }

    def reset(self) -> None:
        with self._mu:
            self.edges.clear()
            self.edge_sites.clear()
            self.violations.clear()
            self.suppressed.clear()
            self._seen.clear()


_tracker = _Tracker()
_atexit_registered = False


def _ensure_atexit() -> None:
    global _atexit_registered
    if not _atexit_registered:
        _atexit_registered = True
        atexit.register(_exit_report)


def _exit_report() -> None:
    rep = _tracker.report()
    out_dir = os.environ.get(REPORT_DIR_ENV, "").strip()
    if out_dir:
        try:
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(out_dir, f"lockcheck-{os.getpid()}.json")
            with open(path, "w") as f:
                json.dump(rep, f, indent=2)
        except OSError:
            pass
    if rep["violations"]:
        print(
            f"[tpubloom.locks] {len(rep['violations'])} lock-check "
            f"violation(s):",
            file=sys.stderr,
        )
        for v in rep["violations"]:
            print(f"  {v['kind']}: {v['message']} @ {v['site']}", file=sys.stderr)


# -- wrappers -----------------------------------------------------------------


class TrackedLock:
    """Named non-reentrant mutex feeding the acquisition graph."""

    __slots__ = ("name", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        _ensure_atexit()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        _tracker.acquiring(self.name, id(self), reentrant=False)
        got = self._lock.acquire(blocking, timeout)
        if got:
            _tracker.acquired(self.name, id(self), reentrant=False)
        return got

    def release(self) -> None:
        _tracker.released(self.name, id(self))
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class TrackedRLock:
    """Named re-entrant mutex (same-instance re-entry is not an edge)."""

    __slots__ = ("name", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.RLock()
        _ensure_atexit()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        _tracker.acquiring(self.name, id(self), reentrant=True)
        got = self._lock.acquire(blocking, timeout)
        if got:
            _tracker.acquired(self.name, id(self), reentrant=True)
        return got

    def release(self) -> None:
        _tracker.released(self.name, id(self))
        self._lock.release()

    def __enter__(self) -> "TrackedRLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # threading.Condition(lock=...) compatibility
    def _is_owned(self):
        return self._lock._is_owned()

    def _acquire_restore(self, state):
        self._lock._acquire_restore(state)
        _tracker.acquired(self.name, id(self), reentrant=True)

    def _release_save(self):
        _tracker.released(self.name, id(self))
        return self._lock._release_save()


class TrackedCondition(threading.Condition):
    """Named condition variable: entry/exit feed the graph, and a wait
    while holding any other tracked lock is a held-while-blocking
    violation (the wait releases only this condition's own lock)."""

    def __init__(self, name: str, lock=None):
        super().__init__(lock)
        self.name = name
        #: per-thread wait_for re-entry depth: the stock wait_for loops
        #: over self.wait(), which dispatches back to the override — the
        #: inner waits must not re-report what wait_for already checked
        self._in_wait_for = threading.local()
        _ensure_atexit()

    def __enter__(self):
        _tracker.acquiring(self.name, id(self), reentrant=True)
        result = super().__enter__()
        _tracker.acquired(self.name, id(self), reentrant=True)
        return result

    def __exit__(self, *exc):
        _tracker.released(self.name, id(self))
        return super().__exit__(*exc)

    def acquire(self, *args):
        _tracker.acquiring(self.name, id(self), reentrant=True)
        got = super().acquire(*args)
        if got:
            _tracker.acquired(self.name, id(self), reentrant=True)
        return got

    def release(self):
        _tracker.released(self.name, id(self))
        super().release()

    def wait(self, timeout: Optional[float] = None):
        if not getattr(self._in_wait_for, "depth", 0):
            _tracker.waiting(self.name, timeout)
        return super().wait(timeout)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        _tracker.waiting(self.name, timeout)
        # the stock wait_for loops over self.wait() — flag the thread so
        # those inner dispatches skip the (already done) check
        tls = self._in_wait_for
        tls.depth = getattr(tls, "depth", 0) + 1
        try:
            return super().wait_for(predicate, timeout)
        finally:
            tls.depth -= 1


# -- factories (the public construction API) ----------------------------------


def named_lock(name: str):
    """A mutex named for the analysis; a bare ``threading.Lock`` when
    the tracker is disarmed (zero overhead)."""
    return TrackedLock(name) if enabled() else threading.Lock()


def named_rlock(name: str):
    return TrackedRLock(name) if enabled() else threading.RLock()


def named_condition(name: str, lock=None):
    """A condition variable named for the analysis; bare
    ``threading.Condition`` when disarmed."""
    if enabled():
        return TrackedCondition(name, lock)
    return threading.Condition(lock)


def note_blocking(
    op: str, allow: Iterable[str] = (), reason: str = ""
) -> None:
    """Blocking primitives (quorum waits, checkpoint flush/restore IO,
    RPC stubs) call this at entry: armed, it records a
    held-while-blocking violation when the calling thread holds any
    tracked lock not in ``allow``; holds that ARE allowed must come with
    a non-empty ``reason`` and land in the report's suppressions.
    Disarmed it costs one cached-bool check."""
    if not enabled():
        return
    if allow and not reason:
        raise ValueError(f"note_blocking({op!r}): an allow list needs a reason")
    _tracker.blocking(op, allow, reason)


# -- reporting API ------------------------------------------------------------


def report() -> dict:
    """Edges + violations + suppressions recorded so far."""
    return _tracker.report()


def violations() -> list:
    return list(_tracker.violations)


def reset() -> None:
    """Drop all recorded state (test isolation). Does not detach locks
    already constructed — they keep feeding the (now empty) graph."""
    _tracker.reset()
