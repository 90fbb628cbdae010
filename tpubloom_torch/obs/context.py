"""Thread-local request context, phase timers and profiler ranges: the
port's copy of ``tpubloom/obs/context.py``, so that the port's filters
and server emit the same phase spans and child trace spans without
importing it, and its one span on the profiler's clock.

The server opens a :func:`request` around every RPC; lower layers
(``filter.py`` packing/launch, protocol decode/encode) wrap their work
in :func:`phase` spans. Phases accumulate on the innermost active
context; with no context active and no profiler recording a span does
nothing but those two checks.

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

PyTorch launches return before the device finishes, so on the host
clock the h2d/kernel boundary is approximate; the completion fence
inside ``kernel`` makes the SUM honest. On the profiler's clock it is
exact: each phase is also a range (below), and the trace links every
copy and kernel on the card to the range that launched it.

Profiler ranges: :class:`Range` opens a ``RecordFunction`` range (as
``record_function`` does, through torch's fast C++ path) while
``torch.profiler`` records on the calling thread (:func:`recording`),
which the profiler's trace puts on one timeline with the card's
kernels, copies and memsets, and does nothing otherwise. The port's
ranges are named ``tpubloom_torch.<name>``, ``<name>`` declared in
:data:`tpubloom_torch.obs.names.RANGES` /
:data:`~tpubloom_torch.obs.names.RANGE_DYNAMIC_PREFIXES`:

* ``filter.<method>`` — a filter's entry points (``filter.py``);
* ``sweep.<wrapper>`` — a kernel wrapper's call (``ops/sweep.py``),
  whose own time is its tensor checks, with the children ``sweep.plan``
  (the kernel's choice and scratch plan, the library lookup),
  ``sweep.alloc`` (the verdicts and scratch) and ``sweep.enqueue`` (the
  device guard, the stream and the call into the C entry, which
  launches every device operation of the call);
* ``phase.<name>`` — every :func:`phase`, with or without a request.

A hot path tests :func:`recording` once a call and, while it is False,
takes a path without ranges: one flag read, no object allocated.
"""

from __future__ import annotations

import contextlib
import random
import sys
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


def phase(name: str) -> "_Phase":
    """Time a named phase into the active request context (no-op without
    one), under the range ``tpubloom_torch.phase.<name>`` while the
    profiler records."""
    return _Phase(name)


class _Phase:
    """:func:`phase`'s timer. The range opens before the clock starts and
    closes after it stops, so that its cost stays out of the phase."""

    __slots__ = ("name", "_range", "_ctx", "_events", "_w0", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        self._range = (Range(f"tpubloom_torch.phase.{self.name}").__enter__()
                       if recording() else None)
        ctx = self._ctx = current()
        if ctx is not None:
            self._events = ctx.trace_events
            self._w0 = time.time() if self._events is not None else 0.0
            self._t0 = time.perf_counter()

    def __exit__(self, *exc) -> None:
        ctx = self._ctx
        if ctx is not None:
            dt = time.perf_counter() - self._t0
            ctx.add_phase(self.name, dt)
            if self._events is not None:
                # the phase timer doubles as a child span —
                # committed as phase.<name> under the request's root span
                # when the request is captured (trace.commit_children)
                self._events.append((self.name, self._w0, dt, None, True))
        if self._range is not None:
            self._range.__exit__()


def recording() -> bool:
    """Whether ``torch.profiler`` records on this thread: torch's own flag
    (``torch._C._autograd._profiler_enabled``), bound at the first call
    once torch is loaded; False before, since no profiler runs without
    torch."""
    return _profiler_enabled()


def _profiler_enabled() -> bool:
    global _profiler_enabled
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    _profiler_enabled = torch._C._autograd._profiler_enabled
    return _profiler_enabled()


class Range:
    """A profiler range named ``name`` (a ``RecordFunction``, as
    ``record_function`` opens): opened on entry while the profiler records
    on this thread, closed on exit; without the profiler nothing.
    :meth:`child` switches the one range open under it."""

    __slots__ = ("name", "_record", "_child")

    def __init__(self, name: str):
        self.name = name
        self._record = self._child = None

    def __enter__(self) -> "Range":
        if recording():
            self._record = _open(self.name)
        return self

    def __exit__(self, *exc) -> None:
        if self._record is not None:
            self.child(None)
            self._record.__exit__(None, None, None)
            self._record = None

    def child(self, name: Optional[str]) -> None:
        """Close the range open under this one, if any, and open ``name``
        in its place (None: no child). Nothing where this range did not
        open."""
        if self._child is not None:
            self._child.__exit__(None, None, None)
            self._child = None
        if name is not None and self._record is not None:
            self._child = _open(name)


def _open(name: str):
    import torch

    # the RecordFunction that record_function opens too, made in C++
    # without its Python object and dispatcher calls: ~2 us a range with
    # the profiler on, against ~15 (CPU host); the trace files it as a cpu_op
    record = torch._C._profiler._RecordFunctionFast(name)
    record.__enter__()
    return record
