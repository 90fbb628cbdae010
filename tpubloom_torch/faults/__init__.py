"""Deterministic fault injection: named fault points and trigger policies.

A stdlib-only copy of ``tpubloom/faults/__init__.py`` (the port may not
import ``tpubloom``), with the same vocabulary, policies, modes, predicates
and ``TPUBLOOM_FAULTS`` syntax, so that one chaos configuration arms both
packages alike. Production code passes through a point with :func:`fire`;
tests and operators arm it with :func:`arm` or the environment. Disarmed
(the normal state) a point costs one dict lookup.

The port fires ``cuckoo.kick`` (a cuckoo insert, before its kernel runs)
and ``cms.update`` (a count-min or top-k update, before its kernel), so a
failed-then-retried batch applies exactly once; ``ckpt.write``,
``ckpt.fsync`` and ``ckpt.restore_read`` in its checkpoint sink;
``shard.insert`` / ``shard.query`` / ``shard.delete`` in its sharded
filter, once per shard a batch routes to, with ``shard=<index>``; and the
server's ``rpc.*``, ``ingest.*`` and ``stream.*`` points; its op log,
replication, cluster, storage and HA planes fire ``repl.*``,
``cluster.*``, ``storage.*`` and ``ha.*`` where ``tpubloom``'s do; and
``initialize_multihost`` fires ``dist.initialize`` before any join. Every
point is armed by literal in the port's own tests (``python -m
tpubloom_torch.analysis`` checks it).

Trigger policies (``policy`` argument / env syntax):

* ``always``            — every pass through the point fires
* ``once``              — exactly one firing, then the fault disarms
* ``nth:N``             — every Nth pass fires (1-indexed: pass N, 2N, ...)
* ``prob:P[:seed=S]``   — each pass fires with probability P from a
  seeded PRNG, so a "random" chaos run replays byte-identically

Modes decide what a firing does: ``raise`` (default) raises
:class:`InjectedFault` from inside the point; ``torn`` is returned to the
caller as a directive, which only points that know how to tear their own
work honor. A ``times=K`` cap bounds any policy to K total firings.

Predicates: a point may fire with context (``fire("shard.insert",
shard=3)``); an armed fault with a predicate (``arm(..., pred={"shard":
3})`` / env ``shard.insert=always:shard=3``) only triggers on passes whose
context matches every item, and passes that do not match do not consume
the policy's budget.

Arming: tests call :func:`arm` / :func:`disarm` / :func:`reset`;
operators set ``TPUBLOOM_FAULTS`` before the process starts, e.g.::

    TPUBLOOM_FAULTS="cuckoo.kick=once,cms.update=prob:0.01:seed=7"

Every firing increments the process-global counters (:mod:`tpubloom_torch.
obs.counters`) ``faults_injected`` and ``fault_<point>`` (dots become
underscores).
"""

from __future__ import annotations

import os
import random
import threading
from typing import Optional

from tpubloom_torch.obs import counters as _counters
from tpubloom_torch.utils import locks

ENV_VAR = "TPUBLOOM_FAULTS"

#: The registered fault-point names. ``arm`` rejects unknown points so a
#: typo'd chaos config fails loudly instead of silently injecting nothing.
KNOWN_POINTS = {
    "ckpt.write",
    "ckpt.fsync",
    "ckpt.restore_read",
    "rpc.pre_handle",
    "rpc.post_handle",
    "repl.append",
    "repl.stream_send",
    "repl.apply",
    "repl.reappend",
    "repl.ack",
    "repl.ack_recv",
    "ha.promote",
    "ha.vote",
    "cluster.migrate_send",
    "cluster.migrate_apply",
    "ingest.coalesce",
    "ingest.flush",
    "stream.recv",
    "stream.ack",
    "cuckoo.kick",
    "cms.update",
    "storage.evict",
    "storage.hydrate",
    "shard.insert",
    "shard.query",
    "shard.delete",
    "dist.initialize",
}

MODES = ("raise", "torn")

_lock = locks.named_lock("faults.registry")
_armed: dict[str, "_Fault"] = {}
_env_loaded = False


class InjectedFault(RuntimeError):
    """What an armed ``mode="raise"`` fault point raises.

    Deliberately a plain RuntimeError subclass: production error paths
    must treat it like any real I/O or handler failure — code that
    special-cases InjectedFault is testing the test, not the system.
    """

    def __init__(self, point: str):
        super().__init__(f"injected fault at {point!r}")
        self.point = point


def register_point(name: str) -> None:
    """Extend the vocabulary (subsystems grown later add theirs here)."""
    with _lock:
        KNOWN_POINTS.add(name)


class _Fault:
    """One armed fault: policy + mode + remaining-firings budget."""

    __slots__ = ("point", "policy", "mode", "times", "pred", "_passes",
                 "_nth", "_prob", "_rng", "fired")

    def __init__(
        self,
        point: str,
        policy: str,
        mode: str,
        times: Optional[int],
        pred: Optional[dict] = None,
    ):
        self.point = point
        self.policy = policy
        self.mode = mode
        self.times = times
        self.pred = pred or {}
        self._passes = 0
        self.fired = 0
        self._nth = 0
        self._prob = 0.0
        self._rng: Optional[random.Random] = None
        if policy == "always":
            pass
        elif policy == "once":
            self.times = 1
        elif policy.startswith("nth:"):
            self._nth = int(policy.split(":", 1)[1])
            if self._nth < 1:
                raise ValueError(f"nth policy needs N >= 1, got {self._nth}")
        elif policy.startswith("prob:"):
            parts = policy.split(":")
            self._prob = float(parts[1])
            if not 0.0 <= self._prob <= 1.0:
                raise ValueError(f"prob policy needs 0 <= P <= 1, got {self._prob}")
            seed = 0
            for p in parts[2:]:
                if p.startswith("seed="):
                    seed = int(p[len("seed="):])
            self._rng = random.Random(seed)
        else:
            raise ValueError(
                f"unknown fault policy {policy!r} "
                "(want always | once | nth:N | prob:P[:seed=S])"
            )

    def matches(self, ctx: dict) -> bool:
        """True iff every predicate item equals the pass context (string
        comparison, so ``shard=3`` from the env matches ``shard=3`` the
        int). A pass that doesn't match doesn't consume the budget."""
        return all(
            str(ctx.get(key)) == str(want) for key, want in self.pred.items()
        )

    def should_fire(self) -> bool:
        """One pass through the point; True iff the fault triggers now."""
        if self.times is not None and self.fired >= self.times:
            return False
        self._passes += 1
        if self._nth:
            hit = self._passes % self._nth == 0
        elif self._rng is not None:
            hit = self._rng.random() < self._prob
        else:  # always / once
            hit = True
        if hit:
            self.fired += 1
        return hit

    def describe(self) -> dict:
        return {
            "point": self.point,
            "policy": self.policy,
            "mode": self.mode,
            "times": self.times,
            "pred": dict(self.pred),
            "passes": self._passes,
            "fired": self.fired,
        }


def arm(
    point: str,
    policy: str = "always",
    *,
    mode: str = "raise",
    times: Optional[int] = None,
    pred: Optional[dict] = None,
) -> None:
    """Arm ``point`` with a trigger policy (replacing any previous arm).
    ``pred`` restricts firing to passes whose :func:`fire` context
    matches every item (e.g. ``pred={"shard": 2}``)."""
    if point not in KNOWN_POINTS:
        raise ValueError(
            f"unknown fault point {point!r} (known: {sorted(KNOWN_POINTS)})"
        )
    if mode not in MODES:
        raise ValueError(f"unknown fault mode {mode!r} (want one of {MODES})")
    fault = _Fault(point, policy, mode, times, pred)
    with _lock:
        _armed[point] = fault


def disarm(point: str) -> bool:
    """Disarm one point; True if it was armed."""
    with _lock:
        return _armed.pop(point, None) is not None


def reset() -> None:
    """Disarm everything (test isolation; also forgets env-var arming)."""
    global _env_loaded
    with _lock:
        _armed.clear()
        _env_loaded = True  # an explicit reset overrides the env config


def active() -> list[dict]:
    """Describe every armed fault (policy, mode, pass/fire counts)."""
    with _lock:
        return [f.describe() for f in _armed.values()]


def is_armed(point: str) -> bool:
    """True iff a fault is currently armed at ``point`` — lets callers
    skip expensive context computation (e.g. host-side shard routing)
    on the normal, disarmed path."""
    if not _env_loaded:
        load_env()
    return point in _armed


def fire(point: str, **ctx) -> Optional[str]:
    """Production-code hook: pass through fault point ``point``.

    Disarmed (or armed-but-not-triggering): returns None, and the caller
    proceeds normally. Triggering with ``mode="raise"``: raises
    :class:`InjectedFault`. Triggering with a directive mode (``torn``):
    returns the mode string — the caller implements the directive (and
    callers that don't know the directive treat it as None, which keeps
    directive faults safe to arm against any point). ``ctx`` carries
    pass context matched against the armed fault's predicate
    (``fire("shard.insert", shard=2)``).
    """
    if not _env_loaded:
        load_env()
    fault = _armed.get(point)
    if fault is None:
        return None
    with _lock:
        if (
            _armed.get(point) is not fault
            or not fault.matches(ctx)
            or not fault.should_fire()
        ):
            return None
    _counters.incr("faults_injected")
    _counters.incr("fault_" + point.replace(".", "_"))
    if fault.mode == "raise":
        raise InjectedFault(point)
    return fault.mode


def load_env(force: bool = False) -> None:
    """Parse ``TPUBLOOM_FAULTS`` once (idempotent; the first ``fire`` of
    the process also calls this — the server calls it eagerly at startup
    so armed faults are logged before traffic arrives). ``force``
    re-parses even after a previous load/reset (tests).

    Syntax: comma-separated ``point=policy[:mode=M][:times=K][:key=V...]``
    items; the policy may itself carry colons (``nth:3``,
    ``prob:0.1:seed=7``); any other ``key=V`` part becomes a predicate
    item (``shard.insert=once:shard=2``).
    """
    global _env_loaded
    with _lock:
        if _env_loaded and not force:
            return
        _env_loaded = True
    spec = os.environ.get(ENV_VAR, "").strip()
    if not spec:
        return
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        point, _, rest = item.partition("=")
        mode, times, policy_parts = "raise", None, []
        pred: dict = {}
        for part in rest.split(":"):
            if part.startswith("mode="):
                mode = part[len("mode="):]
            elif part.startswith("times="):
                times = int(part[len("times="):])
            elif part.startswith("seed=") or "=" not in part:
                # seed= belongs to the prob policy; bare parts are policy
                policy_parts.append(part)
            else:
                key, _, val = part.partition("=")
                pred[key] = val
        arm(point.strip(), ":".join(policy_parts) or "always",
            mode=mode, times=times, pred=pred or None)
