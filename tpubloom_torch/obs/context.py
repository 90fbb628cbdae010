"""Thread-local request context + phase timers.

A stdlib-only copy of ``tpubloom/obs/context.py``, so the port's filter
emits the same phase spans as ``tpubloom.filter`` without importing it.

The server opens a :func:`request` around every RPC; lower layers
(``filter.py`` packing/dispatch, protocol decode/encode) wrap their work
in :func:`phase` spans. Phases accumulate on the innermost active
context; with no context active a span is a no-op ``yield``, so the
library hot path outside the server pays one truthy check per span.

Phase vocabulary (the same names as ``tpubloom.obs.names.PHASES``):

* ``decode``    — wire bytes -> request dict (msgpack)
* ``host_prep`` — key packing + batch padding on the host
* ``h2d``       — staging packed arrays onto the device
* ``kernel``    — MUTATING device work (launch + completion fence):
  inserts, test-and-insert
* ``kernel_query`` — READ-ONLY device work (membership queries)
* ``d2h``       — device results -> host arrays
* ``encode``    — response dict -> wire bytes

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


def new_rid() -> str:
    """16-hex-char request id; cheap, collision-safe at slowlog scale."""
    return "%016x" % random.getrandbits(64)


class RequestContext:
    """Per-request accumulator: id and phase durations. (tpubloom's
    context also buffers trace events for its trace layer, which the
    port does not have yet.)"""

    __slots__ = ("method", "rid", "phases", "started_at")

    def __init__(self, method: str, rid: Optional[str] = None):
        self.method = method
        self.rid = rid or new_rid()
        self.phases: dict[str, float] = {}
        self.started_at = time.time()

    def add_phase(self, name: str, seconds: float) -> None:
        # += : a phase may run more than once per request
        self.phases[name] = self.phases.get(name, 0.0) + seconds


def current() -> Optional[RequestContext]:
    return getattr(_tls, "ctx", None)


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
    t0 = time.perf_counter()
    try:
        yield
    finally:
        ctx.add_phase(name, time.perf_counter() - t0)
