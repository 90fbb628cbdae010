"""Distributed request tracing — follow one rid everywhere.

The stack spans cluster hops, coalesced flushes, commit barriers,
replica appliers and storage hydrations, but until this module the
observability story was per-node and per-phase: a slow write was a rid
in one node's slowlog plus disconnected histograms. This is the
Dapper-style span model adapted to the rid machinery the repo already
has:

* **trace_id = the client rid.** Every hop of one logical call already
  shares a rid (retries, MOVED/ASK follow-ups, migration re-drives,
  op-log records, the dedup cache) — so the rid IS the trace id, and no
  new correlation token crosses the wire.
* **spans** are plain dicts ``{rid, span, parent, name, start,
  duration_s, attrs, links}`` — msgpack-ready for the ``TraceGet`` RPC
  and JSON-ready for the ``/trace?rid=`` HTTP view. Names come from the
  declared vocabulary in :data:`tpubloom_torch.obs.names.SPANS` /
  :data:`tpubloom_torch.obs.names.SPAN_DYNAMIC_PREFIXES` (the lint's
  ``trace-registry`` check closes both directions, exactly like
  ``phase-registry``).
* **links** make N-to-1 batching explainable: the ingest coalescer's
  flush span carries ``links=[{rid, span}, ...]`` naming every parked
  request it merged, and the ring indexes the reverse direction — so
  ``TraceGet(rid)`` returns the request's own spans PLUS any flush span
  that linked it PLUS that flush trace's children (kernel phases,
  barrier) and, assembled cross-node, the replica applies of the merged
  record.

Sampling (the ``--trace-sample`` knob):

* ``configure(sample=None)`` (the default) is **fully off**: request
  contexts carry no event buffer, clients stamp no wire field, every
  helper is a truthy-check no-op — the hot path pays nothing.
* ``configure(sample=R)`` arms the ring. The per-rid decision is
  **deterministic** (``crc32(rid)/2^32 < R``), so every node that sees
  the same rid — server, replicas, migration targets — makes the SAME
  decision with no coordination and no extra wire bytes.
* a request may force capture via the wire field ``trace = {"forced":
  true, "span": <parent span id>}`` (what a sampled client stamps, and
  what the coalescer stamps into merged op-log records so replicas
  capture the apply regardless of their own rate), and
  **slowlog-worthy requests are always captured** when the ring is
  armed — the tail you would chase in SLOWLOG always has its tree.

Per-request child spans ride the existing :mod:`tpubloom_torch.obs.context`
machinery for free: when the ring is armed, phase timers also append
``(name, start, duration)`` events to the thread-local context, and
:func:`finish_request` commits them as ``phase.<name>`` children of the
request's root ``rpc.<Method>`` span. :func:`span` is the explicit
context-manager twin for non-phase children (``storage.hydrate``,
``barrier.wait``, ``cluster.forward``...). Both are lock-free appends —
the ring's own lock (``obs.trace``) is only taken at commit time, on
paths that hold no other lock, so tracing adds no lock-order edges.
"""

from __future__ import annotations

import contextlib
import random
import time
import zlib
from collections import OrderedDict
from typing import Iterator, Optional

from tpubloom_torch.obs import blackbox as obs_blackbox
from tpubloom_torch.obs import context as obs_context
from tpubloom_torch.obs import counters as obs_counters
from tpubloom_torch.utils import locks

#: None = tracing fully off (the default); a float in [0, 1] arms the
#: ring at that deterministic per-rid sample rate (0.0 = capture only
#: forced and slowlog-worthy requests).
_sample: Optional[float] = None

#: Bounded per-node span buffer (total spans across traces).
DEFAULT_CAPACITY_SPANS = 4096


def new_span_id() -> str:
    """8-hex span id; collision-safe within one trace."""
    return "%08x" % random.getrandbits(32)


class TraceRing:
    """Bounded per-node ring of spans, indexed by trace id and by the
    rids a span LINKS (the flush-span reverse index). Oldest trace
    evicted first once the total span budget is exceeded."""

    def __init__(self, max_spans: int = DEFAULT_CAPACITY_SPANS):
        self.max_spans = int(max_spans)
        self._lock = locks.named_lock("obs.trace")
        #: trace id -> [span dicts], insertion-ordered for eviction
        self._traces: "OrderedDict[str, list]" = OrderedDict()
        #: linked rid -> {trace ids whose spans link it}
        self._links: dict = {}
        self._nspans = 0

    def record(self, span: dict) -> None:
        with self._lock:
            tid = span["rid"]
            lst = self._traces.get(tid)
            if lst is None:
                lst = self._traces[tid] = []
            lst.append(span)
            self._nspans += 1
            for link in span.get("links") or ():
                lr = link.get("rid")
                if lr:
                    self._links.setdefault(lr, set()).add(tid)
            while self._nspans > self.max_spans:
                if len(self._traces) > 1:
                    _, evicted = self._traces.popitem(last=False)
                else:
                    # a single trace id over the whole budget (a caller
                    # reusing one rid across many forced calls) must
                    # still be bounded: trim its oldest spans. The link
                    # index drops the trimmed spans' entries — a
                    # surviving same-trace span linking the same rid
                    # loses its reverse index, acceptable for this
                    # pathological shape
                    only = next(iter(self._traces.values()))
                    excess = self._nspans - self.max_spans
                    evicted = only[:excess]
                    del only[:excess]
                self._nspans -= len(evicted)
                for s in evicted:
                    for link in s.get("links") or ():
                        tids = self._links.get(link.get("rid"))
                        if tids is not None:
                            tids.discard(s["rid"])
                            if not tids:
                                self._links.pop(link.get("rid"), None)
            nspans = self._nspans
        # counters OUTSIDE the ring lock: obs.trace stays edge-free
        obs_counters.incr("trace_spans_recorded")
        obs_counters.set_gauge("trace_buffer_spans", float(nspans))

    def get(self, rid: str, follow_links: bool = True) -> list:
        """Spans of ``rid``'s trace, plus (one link hop) every trace
        holding a span that LINKS ``rid`` — the coalescer's flush trace
        with its kernel-phase/barrier children rides along."""
        with self._lock:
            out = [dict(s) for s in self._traces.get(rid, ())]
            if follow_links:
                for tid in sorted(self._links.get(rid, ())):
                    if tid != rid:
                        out.extend(dict(s) for s in self._traces.get(tid, ()))
        return out

    def stats(self) -> dict:
        with self._lock:
            return {"spans": self._nspans, "traces": len(self._traces)}

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()
            self._links.clear()
            self._nspans = 0


_ring = TraceRing()


def configure(
    sample: Optional[float], capacity: Optional[int] = None
) -> None:
    """Arm (or disarm, ``sample=None``) process-wide tracing. Arming
    also turns on per-request child-event capture in
    :mod:`tpubloom_torch.obs.context` (disarmed contexts carry no buffer)."""
    global _sample
    _sample = None if sample is None else max(0.0, min(1.0, float(sample)))
    if capacity is not None:
        _ring.max_spans = int(capacity)
    obs_context.set_trace_capture(_sample is not None)


def ensure_enabled() -> None:
    """Arm the ring at sample 0.0 iff currently off — what a traced
    CLIENT needs (it forces capture per call by its own rate and must
    never lower a rate the server half of the process configured)."""
    if _sample is None:
        configure(0.0)


def enabled() -> bool:
    return _sample is not None


def sample_rate() -> Optional[float]:
    return _sample


def hit(rid: str, rate: Optional[float] = None) -> bool:
    """Deterministic per-rid sampling decision — the same everywhere a
    rid travels, with no coordination (crc32 is stable across processes
    and platforms)."""
    r = _sample if rate is None else rate
    if not r:
        return False
    if r >= 1.0:
        return True
    h = zlib.crc32(rid.encode("utf-8", "replace")) & 0xFFFFFFFF
    return h / 2**32 < r


def record_span(
    name: str,
    *,
    rid: str,
    start: float,
    duration_s: float,
    span: Optional[str] = None,
    parent: Optional[str] = None,
    attrs: Optional[dict] = None,
    links: Optional[list] = None,
    spill: bool = False,
) -> str:
    """Record one finished span into the ring (no-op when tracing is
    off); returns the span id. ``attrs`` values must be msgpack-safe
    scalars (the caller casts). ``spill=True`` (forced or slowlog-
    worthy spans) additionally writes the span through to
    the crash-forensics black box's mapped trace ring, so the spans
    explaining a crash survive the crash; the spill is lock-free and a
    no-op when the black box is disarmed."""
    sid = span or new_span_id()
    if _sample is None:
        return sid
    s: dict = {
        "rid": rid,
        "span": sid,
        "parent": parent,
        "name": name,
        "start": float(start),
        "duration_s": float(duration_s),
    }
    if attrs:
        s["attrs"] = attrs
    if links:
        s["links"] = links
    _ring.record(s)
    if spill:
        obs_blackbox.spill_span(s)
    return sid


def get_trace(rid: str) -> list:
    if _sample is None or not rid:
        return []
    return _ring.get(rid)


def buffer_stats() -> dict:
    return _ring.stats()


# -- request plumbing (the obs.context integration) ---------------------------


def arm_request(rctx, *, forced: bool = False, parent=None) -> bool:
    """Decide capture for one request context (wrapper, post-decode):
    forced (the wire ``trace`` field) or the deterministic rid sample.
    Slowlog-worthy requests are additionally captured at finish even
    when this says no — see :func:`finish_request`."""
    if _sample is None:
        return False
    rctx.trace_parent = parent if isinstance(parent, str) else None
    rctx.trace_forced = bool(forced)
    if forced or hit(rctx.rid):
        rctx.trace_armed = True
        rctx.trace_span = new_span_id()
    return rctx.trace_armed


def request_armed() -> bool:
    """True when the ACTIVE request context is being captured — what
    ``_log_op`` checks to stamp ``trace={"forced": true}`` into the
    record so replicas capture the apply too."""
    ctx = obs_context.current()
    return ctx is not None and getattr(ctx, "trace_armed", False)


def request_ref() -> Optional[tuple]:
    """``(rid, root span id)`` of the active captured request, else
    None — what a parked coalescer entry remembers so the flush span
    can LINK it."""
    ctx = obs_context.current()
    if ctx is None or not getattr(ctx, "trace_armed", False):
        return None
    return (ctx.rid, ctx.trace_span)


@contextlib.contextmanager
def span(name: str, **attrs) -> Iterator[None]:
    """Explicit child span of the active request (no-op without an
    armed context): lock-free append, committed under the request's
    root span at finish."""
    ctx = obs_context.current()
    if ctx is None or ctx.trace_events is None:
        yield
        return
    w0 = time.time()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        ctx.trace_events.append(
            (name, w0, time.perf_counter() - t0, attrs or None, False)
        )


def commit_children(rctx, root: str, *, spill: bool = False) -> None:
    """Commit the context's buffered child events under ``root`` —
    phase timers become ``phase.<name>`` spans, explicit spans keep
    their own names. ``spill`` rides through to :func:`record_span`
    (a forced/slowlog-worthy request's WHOLE tree goes to the
    black box, not just its root)."""
    for name, w0, dt, attrs, is_phase in rctx.trace_events or ():
        if is_phase:
            record_span(
                f"phase.{name}",
                rid=rctx.rid, parent=root, start=w0,
                duration_s=dt, attrs=attrs, spill=spill,
            )
        else:
            # explicit trace.span() children: the name was validated at
            # its own call site by the trace-registry check
            record_span(
                name,
                rid=rctx.rid, parent=root, start=w0,
                duration_s=dt, attrs=attrs, spill=spill,
            )


def finish_request(
    rctx, duration_s: float, *, attrs: Optional[dict] = None,
    slow: bool = False,
) -> Optional[str]:
    """Commit one finished request: the root ``rpc.<Method>`` span plus
    every buffered child. Captured when the request was armed OR when
    it is slowlog-worthy (``slow``) — the slow tail always traces."""
    if _sample is None:
        return None
    if not (rctx.trace_armed or slow):
        return None
    if rctx.trace_armed:
        obs_counters.incr("trace_requests_sampled")
    # black-box spill: the forced and slowlog-worthy trees
    # are exactly the ones a crash post-mortem wants on disk
    spill = slow or getattr(rctx, "trace_forced", False)
    root = rctx.trace_span or new_span_id()
    record_span(
        f"rpc.{rctx.method}",
        rid=rctx.rid,
        span=root,
        parent=rctx.trace_parent,
        start=rctx.started_at,
        duration_s=duration_s,
        attrs=attrs,
        spill=spill,
    )
    commit_children(rctx, root, spill=spill)
    return root


def assemble(spans: list, rid: Optional[str] = None) -> dict:
    """Client-side tree assembly over a merged span set: ``{span id ->
    [child span ids]}`` via parent edges AND link edges (a flush span
    adopts the requests it links as tree neighbors), plus the connected
    components — ONE component is the acceptance shape for a healthy
    single-call trace.

    With ``rid`` given (the seam): a
    multi-hop redirect chain — MOVED/ASK follow-ups, migration
    re-drives — leaves one PARENTLESS ``client.hop`` root per hop, so
    one logical call used to assemble as a forest. When more than one
    root belongs to ``rid``'s own trace, a shared synthetic root
    (``client.call``, marked ``attrs.synthesized``) adopts them, their
    components merge, and the logical call renders as ONE tree. The
    synthetic span is returned under ``"synthetic"`` (never recorded
    into any ring — it exists only in assembled views, which is why it
    is not part of the emitted-span registry)."""
    by_id = {s["span"]: s for s in spans}
    parent: dict = {}
    neighbors: dict = {s["span"]: set() for s in spans}
    for s in spans:
        p = s.get("parent")
        if p in by_id:
            parent[s["span"]] = p
            neighbors[s["span"]].add(p)
            neighbors[p].add(s["span"])
        for link in s.get("links") or ():
            target = link.get("span")
            if target in by_id:
                neighbors[s["span"]].add(target)
                neighbors[target].add(s["span"])
    components = []
    seen: set = set()
    for sid in by_id:
        if sid in seen:
            continue
        comp, stack = set(), [sid]
        while stack:
            cur = stack.pop()
            if cur in comp:
                continue
            comp.add(cur)
            stack.extend(neighbors[cur] - comp)
        seen |= comp
        components.append(sorted(comp))
    roots = [sid for sid in by_id if sid not in parent]
    out = {"roots": roots, "components": components, "parent": parent}
    if rid is not None:
        orphans = [s for s in roots if by_id[s].get("rid") == rid]
        if len(orphans) > 1:
            synth_id = new_span_id()
            starts = [float(by_id[s].get("start") or 0.0) for s in orphans]
            ends = [
                float(by_id[s].get("start") or 0.0)
                + float(by_id[s].get("duration_s") or 0.0)
                for s in orphans
            ]
            synthetic = {
                "rid": rid,
                "span": synth_id,
                "parent": None,
                "name": "client.call",
                "start": min(starts),
                "duration_s": max(ends) - min(starts),
                "attrs": {"synthesized": True, "hops": len(orphans)},
            }
            adopted = set(orphans)
            for s in orphans:
                parent[s] = synth_id
            merged, rest = {synth_id}, []
            for comp in components:
                if adopted & set(comp):
                    merged.update(comp)
                else:
                    rest.append(comp)
            out["components"] = rest + [sorted(merged)]
            out["roots"] = [synth_id] + [s for s in roots if s not in adopted]
            out["synthetic"] = synthetic
    return out


def reset_for_tests() -> None:
    """Disarm + clear + restore the default capacity — test isolation
    only."""
    configure(None, capacity=DEFAULT_CAPACITY_SPANS)
    _ring.clear()
