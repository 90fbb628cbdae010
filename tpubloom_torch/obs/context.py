"""Thread-local request context + phase timers: the port's copy of
``tpubloom/obs/context.py``, so that the port's filters and server emit
the same phase spans and child trace spans without importing it.

The server opens a :func:`request` around every RPC; lower layers
(``filter.py`` packing/launch, protocol decode/encode) wrap their work
in :func:`phase` spans. Phases accumulate on the innermost active
context; with no context active a span is a no-op ``yield``, so the
library hot path outside the server pays one truthy check per span.

Phase vocabulary (declared in :data:`tpubloom_torch.obs.names.PHASES` /
:data:`tpubloom_torch.obs.names.PHASE_DYNAMIC_PREFIXES`):

* ``decode``    — wire bytes -> request dict (msgpack)
* ``host_prep`` — key packing + batch padding on the host
* ``h2d``       — staging packed arrays onto the device
* ``kernel``    — MUTATING device work (launch + completion fence):
  inserts, deletes, fused test-and-insert
* ``kernel_query`` — READ-ONLY device work (membership queries), split
  from ``kernel`` so the read path's device time is trackable on its own
* ``d2h``       — device results -> host arrays
* ``encode``    — response dict -> wire bytes

Sharded filters additionally emit ``kernel_shard<i>`` spans on the
direct (per-request) path: per-slot time-to-completion of one launch,
measured from the fence start (the straggler slot is the widest span).

PyTorch launches return before the device finishes, so the h2d/kernel
boundary is approximate; the completion fence inside ``kernel`` makes
the SUM honest.
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
from typing import Iterator, Optional

_tls = threading.local()

#: Set by :func:`tpubloom_torch.obs.trace.configure`: when the
#: trace ring is armed, fresh request contexts carry an event buffer so
#: phase timers double as child spans; disarmed (the default) they
#: carry None and the hot path pays one falsy check per phase.
_trace_capture = False


def set_trace_capture(on: bool) -> None:
    global _trace_capture
    _trace_capture = bool(on)


def new_rid() -> str:
    """16-hex-char request id; cheap, collision-safe at slowlog scale."""
    return "%016x" % random.getrandbits(64)


class RequestContext:
    """Per-request accumulator: id, batch size, phase durations — plus,
    with tracing armed, the buffered child-span events and the capture
    decision :mod:`tpubloom_torch.obs.trace` commits at finish."""

    __slots__ = (
        "method", "rid", "batch", "summary", "phases", "started_at",
        "trace_events", "trace_armed", "trace_span", "trace_parent",
        "trace_forced",
    )

    def __init__(self, method: str, rid: Optional[str] = None):
        self.method = method
        self.rid = rid or new_rid()
        self.batch = 0
        self.summary = ""
        self.phases: dict[str, float] = {}
        self.started_at = time.time()
        #: (name, wall start, duration, attrs, is_phase) child events,
        #: or None when tracing is off (zero per-phase overhead)
        self.trace_events: Optional[list] = [] if _trace_capture else None
        self.trace_armed = False
        self.trace_span: Optional[str] = None
        self.trace_parent: Optional[str] = None
        #: the wire trace field forced capture (forced
        #: requests spill their tree to the crash-forensics black box)
        self.trace_forced = False

    def add_phase(self, name: str, seconds: float) -> None:
        # += : a phase may run more than once per request (e.g. kernel
        # twice for the query-then-insert presence fallback)
        self.phases[name] = self.phases.get(name, 0.0) + seconds


def current() -> Optional[RequestContext]:
    return getattr(_tls, "ctx", None)


def current_rid() -> Optional[str]:
    ctx = current()
    return ctx.rid if ctx is not None else None


@contextlib.contextmanager
def request(method: str, rid: Optional[str] = None) -> Iterator[RequestContext]:
    """Install a fresh RequestContext for this thread (re-entrant: the
    previous context is restored on exit, so nested server calls don't
    cross-contaminate phases)."""
    ctx = RequestContext(method, rid)
    prev = current()
    _tls.ctx = ctx
    try:
        yield ctx
    finally:
        _tls.ctx = prev


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Time a named phase into the active request context (no-op without
    one)."""
    ctx = current()
    if ctx is None:
        yield
        return
    events = ctx.trace_events
    w0 = time.time() if events is not None else 0.0
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        ctx.add_phase(name, dt)
        if events is not None:
            # the phase timer doubles as a child span —
            # committed as phase.<name> under the request's root span
            # when the request is captured (trace.commit_children)
            events.append((name, w0, dt, None, True))
