"""Streaming ingest plane: persistent bidi RPCs feeding the
coalescer.

The device sweeps tens of millions of keys per second, but every
data-plane call used to be one unary RPC — per-call HTTP/2 stream
setup, header parse, thread-pool hop. ``InsertStream``/``QueryStream``
amortize the transport the way the ingest coalescer
amortizes device launches: one long-lived stream carries seq-stamped
``keys_fixed`` frames straight into the coalescer's parked queues, and
pipelined ack frames return per-frame verdicts (presence slices, hits,
``repl_seq``, quorum results from the one-barrier-per-flush path).
Wire shapes are specified on :data:`tpubloom_torch.server.protocol.
BIDI_STREAM_METHODS`.

Threading model (per stream): the gRPC handler thread is the ACK
PUMP — it drains a per-stream outbound queue of encoded ack frames
(yielding each to gRPC) until a sentinel arrives. A spawned RECEIVER
thread consumes the request iterator: each data frame passes the exact
unary-wrapper semantic gates (READONLY, LOG_WRITE_FAILED, STALE_EPOCH,
cluster MOVED/ASK — in that order), then parks into the coalescer via
:meth:`IngestCoalescer.submit_nowait`; the flush's completion callback
(dispatcher/completer thread, outside every lock) builds the ack and
enqueues it. Frames the coalescer cannot take (migration forwards,
coalescer stopped, no keys) run the direct path inline on the receiver
thread — handler + commit barrier + dual-write forward, exactly the
unary order. Acks are therefore NOT necessarily in frame order; each
echoes its frame's ``seq``.

Flow control: admission's in-flight cap never sees stream frames —
credit is the stream-shaped replacement. Every ack carries a fresh
``credit`` grant derived from the coalescer's parked-key headroom
(:meth:`IngestCoalescer.parked_budget_left`, the signal behind the
``ingest_parked_current`` gauge), floored at 1 so the window can
always drain (a zero grant with no outstanding frame would have no ack
to ride back on). An over-budget server PARKS the stream — the
receiver thread blocks in the coalescer's bounded-park backpressure,
gRPC/TCP flow control pushes back on the sender — instead of shedding
admitted work.

Exactly-once replay: a client whose stream died mid-flight reconnects
and re-sends only its unacked frames under their ORIGINAL rids. The
rid→response dedup cache answers any frame whose first
flight already applied; the coalesced merged records' ``parts``
(:meth:`IngestCoalescer._log_parts`) re-seed that cache on
crash replay, so the guarantee holds across a SIGKILL — chaos-proven
on a counting filter in ``tests/test_streams.py``.

Fault points: ``stream.recv`` fires in the receiver per data frame
(before any effect — a killed stream replays safely); ``stream.ack``
fires in the ack pump per ack frame (after the effect — the case the
rid-dedup replay contract must absorb).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Optional

from tpubloom_torch import faults
from tpubloom_torch.cluster import migrate as cluster_migrate
from tpubloom_torch.cluster import node as cluster_node
from tpubloom_torch.obs import context as obs
from tpubloom_torch.obs import counters as obs_counters
from tpubloom_torch.obs import flight as obs_flight
from tpubloom_torch.obs import trace as obs_trace
from tpubloom_torch.server import protocol
from tpubloom_torch.utils import locks

log = logging.getLogger("tpubloom.server")

#: stream method -> the unary method whose semantics each frame carries
FRAME_METHODS = {
    "InsertStream": "InsertBatch",
    "QueryStream": "QueryBatch",
}

#: largest credit window any ack grants: bounds per-stream server-side
#: state (unacked frames a replay may re-send) and keeps one stream
#: from monopolizing the parked-key budget
MAX_WINDOW = 32

#: process-wide connected-stream count behind the
#: ``stream_connected_current`` gauge (updated OUTSIDE the lock — the
#: registry lock stays a leaf with no declared edges)
_registry_lock = locks.named_lock("stream.registry")
_connected = 0


def _track_connected(delta: int) -> None:
    global _connected
    with _registry_lock:
        _connected += delta
        n = _connected
    obs_counters.set_gauge("stream_connected_current", n)


def credit_grant(service) -> int:
    """Fresh per-ack credit: the coalescer's parked-key headroom in
    flush-quantum units, capped at :data:`MAX_WINDOW`, floored at 1
    (the stream must always be able to drain — backpressure is the
    bounded park, not a dead window)."""
    co = service._coalescer
    if co is None or not co.running:
        return MAX_WINDOW
    quantum = max(1, co.config.max_keys // 8)
    grant = co.parked_budget_left() // quantum
    if grant < MAX_WINDOW:
        obs_counters.incr("stream_credit_throttles")
    return max(1, min(MAX_WINDOW, grant))


class _Stream:
    """State of one live bidi stream: the outbound ack queue the
    handler thread pumps, and the count of frames parked in the
    coalescer whose completion callbacks have not fired yet."""

    def __init__(self, service, method: str):
        self.service = service
        self.method = method  # the unary frame method
        self.outq: "queue.Queue" = queue.Queue()
        self.cond = locks.named_condition("stream.state")
        self.pending = 0
        #: last credit grant sent on any outbound frame — the baseline
        #: the idle pump compares against before pushing a server-
        #: initiated shrink frame (benign cross-thread race: a stale
        #: read only costs one redundant frame or skips one)
        self.last_credit = MAX_WINDOW

    def enqueue_ack(self, seq, resp: dict) -> None:
        """Build + encode one ack OUTSIDE every lock (credit reads the
        coalescer's queue condition) and hand it to the ack pump."""
        grant = credit_grant(self.service)
        self.last_credit = grant
        frame = {
            "kind": "ack",
            "seq": seq,
            "credit": grant,
            "resp": resp,
        }
        self.outq.put(protocol.encode(frame))

    def frame_done(self, seq, resp: dict) -> None:
        self.enqueue_ack(seq, resp)
        with self.cond:
            self.pending -= 1
            self.cond.notify_all()

    def drain_pending(self, timeout: float = 120.0) -> None:
        """Receiver-side: input exhausted — wait for every parked
        frame's callback before the pump's sentinel goes out."""
        deadline = time.monotonic() + timeout
        with self.cond:
            while self.pending > 0 and time.monotonic() < deadline:
                self.cond.wait(timeout=0.1)
            if self.pending > 0:
                log.error(
                    "stream drain: %d frame(s) still parked after %.0fs",
                    self.pending, timeout,
                )


def _error_resp(e: protocol.BloomServiceError) -> dict:
    return protocol.error_response(e.code, e.message, e.details)


def _check_frame(service, method: str, req: dict) -> Optional[dict]:
    """The unary wrapper's pre-handler gates, per frame and in the
    same order (READONLY → LOG_WRITE_FAILED → STALE_EPOCH → cluster
    slot check). Admission shed is deliberately ABSENT: frames are
    credit-governed, and an admitted stream parks instead of shedding.
    Returns an error response to ack, or None to proceed."""
    if service.read_only and method in protocol.MUTATING_METHODS:
        service.metrics.count("readonly_rejected")
        return protocol.error_response(
            "READONLY",
            f"{method} rejected: this server is a read-only replica — "
            f"send writes to the primary",
            details=(
                {"primary": service.primary_address}
                if service.primary_address
                else None
            ),
        )
    if (
        service.oplog_error is not None
        and method in protocol.MUTATING_METHODS
    ):
        service.metrics.count("log_failstop_rejected")
        return protocol.error_response(
            "LOG_WRITE_FAILED",
            f"{method} rejected: op log append failed "
            f"({service.oplog_error}); writes are stopped until the log "
            f"is writable and the server restarts",
        )
    req_epoch = req.get("epoch")
    if (
        req_epoch is not None
        and method in protocol.MUTATING_METHODS
        and int(req_epoch) < service.epoch
    ):
        service.metrics.count("stale_epoch_rejected")
        return protocol.error_response(
            "STALE_EPOCH",
            f"request epoch {req_epoch} predates the current topology "
            f"epoch {service.epoch} — refresh your topology",
            details={"epoch": service.epoch},
        )
    name = req.get("name")
    if (
        service.cluster is not None
        and isinstance(name, str)
        and method in cluster_node.KEYED_METHODS
    ):
        try:
            service.cluster.check(
                name,
                asking=bool(req.get("asking")),
                exists=service.has_filter(name),
                primary_address=(
                    service.primary_address if service.read_only else None
                ),
            )
        except protocol.BloomServiceError as e:
            return _error_resp(e)
    return None


def _direct_frame(service, method: str, req: dict) -> dict:
    """The unary post-handler path for frames the coalescer cannot
    park (stopped, migration forward, keyless): handler + commit
    barrier + dual-write forward, on the receiver thread."""
    handler = getattr(service, method)
    try:
        resp = handler(req)
        coalesced_done = isinstance(resp, dict) and bool(
            resp.pop("_coalesced", False)
        )
        if (
            not coalesced_done
            and method in protocol.MUTATING_METHODS
            and resp.get("ok")
        ):
            with obs_trace.span("barrier.wait"):
                resp = service.commit_barrier(req, resp)
            if service.cluster is not None:
                resp = cluster_migrate.forward_op(service, method, req, resp)
        return resp
    except protocol.BloomServiceError as e:
        return _error_resp(e)
    except Exception as e:  # noqa: BLE001 — surface, don't kill the stream
        log.exception("stream frame %s failed", method)
        return protocol.error_response(
            "INTERNAL", f"{type(e).__name__}: {e}"
        )


def _handle_frame(service, stream: _Stream, req: dict) -> None:
    """Process one decoded data frame on the receiver thread: gates,
    dedup, then park-or-direct. Always produces exactly one ack
    (immediately, or from the park's completion callback)."""
    method = stream.method
    seq = req.get("seq")
    rid = req.get("rid")
    if not isinstance(rid, str) or not rid:
        rid = obs.new_rid()
        req["rid"] = rid
    service.metrics.count("stream_frames_total")
    err = _check_frame(service, method, req)
    if err is not None:
        stream.enqueue_ack(seq, err)
        return
    # the frame's own request context: arms capture when
    # the client forced it (or the server-side sample hits), so the
    # flush span LINKS this frame's root and `_log_op` on the direct
    # path stamps the record with the frame rid
    with obs.request(method, rid=rid) as rctx:
        tmeta = req.get("trace")
        if not isinstance(tmeta, dict):
            tmeta = None
        obs_trace.arm_request(
            rctx,
            forced=bool(tmeta and tmeta.get("forced")),
            parent=tmeta.get("span") if tmeta else None,
        )
        w0, t0 = time.time(), time.perf_counter()
        parked = False
        try:
            replay_unsafe = False
            if method == "InsertBatch":
                mf = service._get(req["name"])
                replay_unsafe = service._insert_replay_unsafe(
                    mf, bool(req.get("return_presence"))
                )
            if replay_unsafe:
                cached = service._dedup_get(rid)
                if cached is not None:
                    # replayed frame whose first flight applied: answer
                    # from cache, re-waiting the barrier on the SAME
                    # record (direct-path dedup parity)
                    service.metrics.count("stream_frame_dedup_hits")
                    obs_flight.note(
                        "stream", phase="replay", method=method,
                        rid=rid, seq=int(seq) if seq is not None else -1,
                    )
                    try:
                        resp = service.commit_barrier(req, dict(cached))
                        if service.cluster is not None and resp.get("ok"):
                            resp = cluster_migrate.forward_op(
                                service, method, req, resp
                            )
                        stream.enqueue_ack(seq, resp)
                    except protocol.BloomServiceError as e:
                        stream.enqueue_ack(seq, _error_resp(e))
                    return
            if service._coalesce_eligible(req, method):
                with stream.cond:
                    stream.pending += 1
                co = service._coalescer
                parked = co.submit_nowait(
                    method, req, replay_unsafe=replay_unsafe,
                    callback=lambda entry, s=seq: _entry_ack(
                        stream, s, entry
                    ),
                )
                if not parked:
                    with stream.cond:
                        stream.pending -= 1
            if not parked:
                stream.enqueue_ack(seq, _direct_frame(service, method, req))
        except protocol.BloomServiceError as e:
            stream.enqueue_ack(seq, _error_resp(e))
        finally:
            if rctx.trace_armed:
                obs_trace.record_span(
                    "ingest.stream_recv",
                    rid=rid,
                    span=rctx.trace_span,
                    parent=rctx.trace_parent,
                    start=w0,
                    duration_s=time.perf_counter() - t0,
                    attrs={
                        "method": method,
                        "seq": int(seq) if seq is not None else -1,
                        "parked": parked,
                    },
                )


def _entry_ack(stream: _Stream, seq, entry) -> None:
    """Completion callback of a parked frame (dispatcher/completer
    thread, outside every coalescer/filter lock): demuxed verdict →
    ack frame."""
    if entry.error is not None:
        e = entry.error
        if isinstance(e, protocol.BloomServiceError):
            resp = _error_resp(e)
        else:
            resp = protocol.error_response(
                "INTERNAL", f"{type(e).__name__}: {e}"
            )
    else:
        resp = dict(entry.resp)
        resp.pop("_coalesced", None)
    stream.frame_done(seq, resp)


def _receiver(service, stream: _Stream, request_iterator,
              failure: list) -> None:
    """Consume the stream's data frames until the client half-closes
    (drain + sentinel) or the transport/fault path breaks (record the
    error, sentinel — the pump re-raises it to fail the RPC so the
    client reconnects and replays)."""
    try:
        for raw in request_iterator:
            faults.fire("stream.recv")
            try:
                req = protocol.decode(raw)
            except Exception:  # noqa: BLE001 — one bad frame, one error ack
                stream.enqueue_ack(None, protocol.error_response(
                    "INVALID_ARGUMENT", "undecodable stream frame"
                ))
                continue
            _handle_frame(service, stream, req)
        stream.drain_pending()
    except BaseException as e:  # noqa: BLE001 — the pump must wake
        log.debug("stream receiver ended: %r", e)
        failure.append(e)
    finally:
        stream.outq.put(None)


#: how long the ack pump idles on an empty outbound queue before
#: re-reading the coalescer's headroom — bounds how stale a client's
#: credit window can get while it sends nothing
IDLE_CREDIT_POLL_S = 0.25


def _run_stream(service, method_name: str, request_iterator, context):
    """One bidi stream's lifetime: hello (initial credit), receiver
    thread, ack pump, teardown accounting.

    The ack pump doubles as the idle credit refresher:
    acks piggyback fresh grants, but an IDLE stream has no
    ack to ride — its client would happily burst a stale fat window
    into a coalescer other streams have since filled. So when the
    outbound queue stays empty for :data:`IDLE_CREDIT_POLL_S`, the pump
    re-reads :func:`credit_grant` and pushes a server-initiated
    ``{"kind": "credit"}`` frame IF the grant shrank (grow-only changes
    wait for the next ack — only shrinks are urgent)."""
    stream = _Stream(service, FRAME_METHODS[method_name])
    _track_connected(+1)
    obs_flight.note("stream", phase="connect", method=method_name)
    failure: list = []
    receiver = threading.Thread(
        target=_receiver,
        args=(service, stream, request_iterator, failure),
        name=f"tpubloom-{method_name}",
        daemon=True,
    )
    try:
        stream.last_credit = credit_grant(service)
        yield protocol.encode(
            {"kind": "hello", "credit": stream.last_credit}
        )
        receiver.start()
        while True:
            try:
                item = stream.outq.get(timeout=IDLE_CREDIT_POLL_S)
            except queue.Empty:
                fresh = credit_grant(service)
                if fresh < stream.last_credit:
                    stream.last_credit = fresh
                    obs_counters.incr("stream_credit_shrinks")
                    yield protocol.encode(
                        {"kind": "credit", "credit": fresh}
                    )
                continue
            if item is None:
                break
            faults.fire("stream.ack")
            service.metrics.count("stream_acks_total")
            yield item
        if failure:
            obs_flight.note(
                "stream", phase="kill", method=method_name,
                error=repr(failure[0]),
            )
            raise failure[0]
    finally:
        _track_connected(-1)


def insert_stream(service, request_iterator, context):
    """``InsertStream`` behavior: InsertBatch-semantics frames (presence
    fusion, durability quorums, counting/scalable dedup) over one
    persistent stream."""
    yield from _run_stream(service, "InsertStream", request_iterator, context)


def query_stream(service, request_iterator, context):
    """``QueryStream`` behavior: QueryBatch-semantics frames — reads
    ride the same coalesced flush path, acks carry packed hit bitmaps."""
    yield from _run_stream(service, "QueryStream", request_iterator, context)
