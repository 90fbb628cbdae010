"""Cross-connection micro-batching ingestion scheduler.

The device sweeps tens of millions of keys per second, but the host
front-end feeds it one gRPC request at a time: per-request decode, lock,
jit dispatch and — under synchronous replication — one commit barrier
per write. This module closes that gap with the Redis-pipelining move
applied server-side: concurrent ``InsertBatch``/``QueryBatch``/
``DeleteBatch``/``Clear`` RPCs
**park** in a bounded per-(filter, op) coalescing queue, a single
dispatcher thread flushes each queue on size/bytes/deadline
(``--coalesce-max-keys`` / ``--coalesce-max-wait-us``), runs the fused
kernel ONCE over the merged keys, and demultiplexes per-request results
(presence slices, ``repl_seq``) back to the parked handler threads.

What one flush amortizes:

* **one device launch** over the merged batch instead of N jit
  dispatches (and the merged batch hits the kernels' throughput regime
  instead of their fixed-overhead regime);
* **one op-log append** — the flush commits as a single merged record,
  so crash replay and replica streaming see one apply;
* **one commit barrier** — ``wait_acked`` runs once on the flush's seq
  at the STRONGEST quorum any parked request demanded; per-request
  verdicts are then read off the achieved count (a request that asked
  for less durability than the flush achieved succeeds even when a
  stricter sibling times out). N quorum writes, one WAIT — exactly the
  pipelining follow-up.

Semantics preserved (regression-tested in ``tests/test_ingest.py``):

* READONLY / STALE_EPOCH / MOVED / ASK / shed all run in the RPC
  wrapper BEFORE the handler parks anything — coalescing never bypasses
  an admission or routing decision;
* per-request **rid-dedup**: replay-unsafe inserts check the dedup
  cache before parking and every parked request's demuxed response is
  cached under its own rid (seq-stamped), so client retries replay from
  cache exactly as on the direct path;
* **migration windows fall back to the direct path**: a flush checks
  the dual-write forward target under the filter's op lock (the same
  lock ``MigrateSlot`` arms forwards under) and, when armed, re-drives
  each parked request through the ordinary per-request handler + its
  own barrier + forward — a merged record would make N requests share
  one ``src_seq`` and the target's exactly-once gate would drop all but
  the first forward. Requests already carrying ``asking``/``src_seq``
  (forwards themselves) never park at all.

Double buffering (with :class:`tpubloom_torch.ops.sweep.InFlight`):
an insert flush is launched UNFENCED under the op lock; while its
kernel runs, the dispatcher stages the next flush's host_prep/H2D, then
fences the previous flush and completes its waiters — the host feed and
the device overlap instead of ping-ponging. The handle ``launch_insert``
returns is a CUDA event (None on the CPU, whose work is done on return):
``InFlight.take`` synchronizes it, so no waiter is acked before its
kernel ends, and a kernel fault surfacing there fails the flush's
waiters. A query flush copies its verdicts to the host under ``d2h``
(the copy is its fence).

Fault points: ``ingest.coalesce`` fires in ``submit`` before a request
parks (nothing applied — safe to retry); ``ingest.flush`` fires in the
dispatcher before a flush applies (ditto).

Lock ranks (declared in :mod:`tpubloom.analysis.lock_order`): the queue
condition is ``ingest.queue`` and is a LEAF apart from gauge updates —
the dispatcher drops it before touching any filter/registry/log lock.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

import numpy as np

from tpubloom_torch import faults
from tpubloom_torch.obs import context as obs
from tpubloom_torch.obs import counters as obs_counters
from tpubloom_torch.obs import trace as obs_trace
from tpubloom_torch.ops.sweep import InFlight
from tpubloom_torch.sketch import registry as sketch_registry
from tpubloom_torch.utils import locks

log = logging.getLogger("tpubloom.server")


class _EvictedRace(Exception):
    """The flush's resolved ``_Managed`` was paged out between lookup
    and lock — the dispatcher re-resolves (hydrating if
    needed) and retries the flush against the live filter."""


def _check_live(mf) -> None:
    """First statement under every flush's op lock: a flag set means
    the storage tier evicted this object — mutating it would write to
    detached device arrays the eviction blob missed."""
    if getattr(mf, "evicted", False):
        raise _EvictedRace


class CoalesceConfig:
    """Flush policy knobs. A group flushes when its parked keys reach
    ``max_keys``, its parked payload reaches ``max_bytes``, or its
    oldest request has waited ``max_wait_us`` — whichever first.
    ``max_parked_keys`` bounds the queue: submitters block (bounded,
    natural backpressure — the caller thread was going to wait for its
    response anyway) until the dispatcher drains."""

    def __init__(
        self,
        max_keys: int = 8192,
        max_wait_us: int = 500,
        max_bytes: int = 8 * 1024 * 1024,
        max_parked_keys: Optional[int] = None,
    ):
        self.max_keys = int(max_keys)
        self.max_wait_us = int(max_wait_us)
        self.max_bytes = int(max_bytes)
        self.max_parked_keys = int(
            max_parked_keys if max_parked_keys is not None else 8 * max_keys
        )


class _Entry:
    __slots__ = (
        "req", "rid", "nkeys", "nbytes", "rows", "keys",
        "want_presence", "replay_unsafe", "min_replicas",
        "timeout_ms", "enq_t", "event", "resp", "error", "trace",
        "callback",
    )

    def __init__(self, req: dict, *, rows, keys, replay_unsafe: bool):
        self.req = req
        self.rid = req.get("rid")
        #: (rid, root span id) when the parking request is traced —
        #: what the flush span LINKS so N-to-1 batching stays
        #: explainable; None on the untraced hot path
        self.trace = obs_trace.request_ref()
        self.rows = rows          # np.uint8[n, width] (fixed encoding) or None
        self.keys = keys          # list of key bytes/str, or None
        self.nkeys = int(rows.shape[0]) if rows is not None else len(keys)
        self.nbytes = (
            int(rows.nbytes) if rows is not None
            else sum(len(k) for k in keys)
        )
        self.want_presence = bool(req.get("return_presence"))
        self.replay_unsafe = replay_unsafe
        self.min_replicas = int(req.get("min_replicas") or 0)
        self.timeout_ms = req.get("min_replicas_timeout_ms")
        self.enq_t = time.monotonic()
        self.event = threading.Event()
        self.resp: Optional[dict] = None
        self.error: Optional[BaseException] = None
        #: streaming ingest: set by :meth:`submit_nowait` —
        #: fires on the completing thread (dispatcher/completer, always
        #: OUTSIDE coalescer and filter locks) instead of a parked
        #: handler thread waking on the event
        self.callback = None

    def complete(self, resp: Optional[dict] = None,
                 error: Optional[BaseException] = None) -> None:
        self.resp, self.error = resp, error
        self.event.set()
        cb = self.callback
        if cb is not None:
            try:
                cb(self)
            except Exception:  # noqa: BLE001 — a bad ack sink must not
                # fail the flush's OTHER waiters (the stream may have
                # disconnected between park and completion)
                log.exception("ingest completion callback failed")


class IngestCoalescer:
    """Per-filter request coalescing + the single dispatcher thread."""

    def __init__(self, service, config: Optional[CoalesceConfig] = None):
        self._service = service
        self.config = config or CoalesceConfig()
        #: (filter name, "insert"|"query") -> [entries]
        self._groups: dict = {}
        self._parked_keys = 0
        self._cond = locks.named_condition("ingest.queue")
        self._stop = False
        self._flushing = 0
        self._urgent = 0
        self._thread: Optional[threading.Thread] = None
        self._in_dispatch = threading.local()
        self._inflight = InFlight()
        #: barrier-bearing finalizes run HERE, not on the dispatcher: a
        #: quorum wait can block up to its budget, and head-of-line
        #: blocking every other filter's flushes (including pure reads)
        #: behind one filter's replication round trip would undo the
        #: scheduler's point. Barrier-less finalizes (the common async
        #: case) stay inline — they are just demux.
        import queue

        self._completions: "queue.Queue" = queue.Queue(maxsize=4)
        self._completing = 0
        self._completer: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "IngestCoalescer":
        self._thread = threading.Thread(
            target=self._run, name="tpubloom-ingest", daemon=True
        )
        self._thread.start()
        self._completer = threading.Thread(
            target=self._completion_loop,
            name="tpubloom-ingest-complete",
            daemon=True,
        )
        self._completer.start()
        return self

    @property
    def running(self) -> bool:
        return self._thread is not None and not self._stop

    def in_dispatcher(self) -> bool:
        """True on the dispatcher thread — the migration-window fallback
        re-enters the ordinary handlers and must not park again."""
        return bool(getattr(self._in_dispatch, "active", False))

    def close(self, timeout: float = 30.0) -> None:
        """Flush everything parked, stop the dispatcher + completer,
        join both. Parked requests complete normally (drain semantics —
        their clients were admitted before the drain began)."""
        thread = self._thread
        if thread is None:
            return
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        thread.join(timeout=timeout)
        self._thread = None
        completer = self._completer
        if completer is not None:
            self._completions.put(None)  # sentinel after the last flush
            completer.join(timeout=timeout)
            self._completer = None

    def drain_parked(self, timeout: float = 30.0) -> None:
        """Block until every currently-parked request has completed —
        the demotion barrier's coalescer leg (see
        :func:`tpubloom.ha.promotion.become_replica`: parked writes
        passed the READONLY fence but hold NO filter lock, so the
        take-every-lock-once barrier alone would not wait for them).
        Polls rather than waiting on the condition: the caller holds
        ``service.promote``, and a condition wait under a foreign lock
        is exactly what the lock tracker flags."""
        deadline = time.monotonic() + timeout
        with self._cond:
            self._urgent += 1
            self._cond.notify_all()
        try:
            while time.monotonic() < deadline:
                with self._cond:
                    if (
                        not self._groups
                        and not self._flushing
                        and not self._completing
                        and not self._inflight.pending
                    ):
                        return
                time.sleep(0.002)
            log.warning("ingest drain_parked: %.0fs deadline hit", timeout)
        finally:
            with self._cond:
                self._urgent -= 1

    # -- producer side -------------------------------------------------------

    #: method -> per-filter queue kind: each kind flushes as its own
    #: op-pure launch + merged log record (queries, inserts,
    #: deletes and clears)
    _KINDS = {
        "InsertBatch": "insert",
        "QueryBatch": "query",
        "DeleteBatch": "delete",
        "Clear": "clear",
    }

    def _make_entry(self, method: str, req: dict,
                    replay_unsafe: bool) -> _Entry:
        from tpubloom_torch.server import protocol

        rows = keys = None
        kind = self._KINDS[method]
        fx = protocol.fixed_keys(req)
        if fx is not None:
            data, width, n = fx
            rows = np.frombuffer(data, np.uint8).reshape(n, width)
        else:
            # Clear carries no keys — it parks as an empty entry and the
            # flush applies ONE clear for the whole parked run
            keys = req.get("keys") if kind != "clear" else []
            if keys is None:
                keys = []
        return _Entry(req, rows=rows, keys=keys, replay_unsafe=replay_unsafe)

    def _park(self, entry: _Entry, name: str, kind: str) -> bool:
        """Queue one entry under the bounded-park budget; False when
        the coalescer is stopped/stopping."""
        with self._cond:
            if self._stop:
                return False
            # bounded queue: block (briefly, repeatedly) until there is
            # room — the dispatcher drains continuously, so this is
            # backpressure, not a deadlock risk (and the timeout keeps
            # the wait bounded for the runtime lock tracker)
            while (
                self._parked_keys + entry.nkeys > self.config.max_parked_keys
                and self._parked_keys > 0
                and not self._stop
            ):
                self._cond.wait(timeout=0.05)
            if self._stop:
                return False
            self._groups.setdefault((name, kind), []).append(entry)
            self._parked_keys += entry.nkeys
            obs_counters.set_gauge("ingest_parked_current", self._parked_keys)
            self._cond.notify_all()
        return True

    def parked_budget_left(self) -> int:
        """Headroom under ``max_parked_keys`` right now — the signal
        the streaming plane's credit grants follow."""
        with self._cond:
            return max(0, self.config.max_parked_keys - self._parked_keys)

    def submit(self, method: str, req: dict, *,
               replay_unsafe: bool = False) -> Optional[dict]:
        """Park one request until its flush completes; returns the
        demuxed response (or raises its error). Returns **None** when
        the coalescer is stopped/stopping — the handler falls back to
        the direct path instead of parking on a dead queue."""
        from tpubloom_torch.server import protocol

        faults.fire("ingest.coalesce")
        kind = self._KINDS[method]
        entry = self._make_entry(method, req, replay_unsafe)
        name = req["name"]
        if not self._park(entry, name, kind):
            return None
        budget = self._entry_budget(entry)
        with obs_trace.span("ingest.park", filter=name, op=kind):
            done = entry.event.wait(timeout=budget)
        if not done:
            raise protocol.BloomServiceError(
                "INTERNAL",
                f"coalesced {method} did not complete within {budget:.0f}s",
            )
        if entry.error is not None:
            raise entry.error
        return entry.resp

    def submit_nowait(self, method: str, req: dict, *,
                      replay_unsafe: bool = False, callback) -> bool:
        """Park one request WITHOUT waiting for its flush (the
        streaming ingest plane): ``callback(entry)`` fires on
        the completing thread — outside every coalescer/filter lock —
        once the flush demuxed this entry's verdict into ``entry.resp``
        / ``entry.error``. Returns False when the coalescer is
        stopped/stopping (the caller drives the direct path instead).

        The bounded-park backpressure still applies to the CALLING
        thread: a stream's receiver blocking here until the dispatcher
        drains is exactly how an over-budget server parks the stream
        (gRPC/TCP flow control pushes back on the sender) instead of
        shedding it."""
        faults.fire("ingest.coalesce")
        kind = self._KINDS[method]
        entry = self._make_entry(method, req, replay_unsafe)
        entry.callback = callback
        return self._park(entry, req["name"], kind)

    def _entry_budget(self, entry: _Entry) -> float:
        """Generous completion budget: flush deadline + the longest
        barrier the flush could run + margin. A hang past this is a bug
        (the dispatcher completes entries even on flush errors)."""
        barrier_ms = max(
            int(entry.timeout_ms or 0),
            self._service.min_replicas_max_lag_ms or 0,
            1000,
        )
        return self.config.max_wait_us / 1e6 + barrier_ms / 1000.0 + 60.0

    # -- dispatcher ----------------------------------------------------------

    def _run(self) -> None:
        self._in_dispatch.active = True
        stopping = False
        while not stopping:
            with self._cond:
                batch = self._pop_ripe_locked()
                if batch is None:
                    if self._stop and not self._groups:
                        stopping = True
                    elif not self._inflight.pending:
                        # nothing ripe and nothing in flight: sleep
                        # until the oldest entry's deadline or a submit
                        timeout = self._wait_locked()
                        self._cond.wait(
                            timeout=1.0 if timeout is None
                            else max(timeout, 0.0005)
                        )
                        batch = self._pop_ripe_locked()
                if batch is not None:
                    self._flushing += 1
            if batch is None:
                # the gap gave the in-flight kernel its overlap window —
                # fence it and complete its waiters (outside all locks)
                self.flush_inflight()
                continue
            (name, kind), entries = batch
            try:
                self._flush(name, kind, entries)
            except BaseException as e:  # noqa: BLE001 — waiters must wake
                from tpubloom_torch.server import protocol

                log.exception("ingest flush for %r failed", name)
                err = (
                    e if isinstance(e, protocol.BloomServiceError)
                    else protocol.BloomServiceError(
                        "INTERNAL", f"ingest flush failed: {e!r}"
                    )
                )
                for entry in entries:
                    if not entry.event.is_set():
                        entry.complete(error=err)
            finally:
                with self._cond:
                    self._flushing -= 1
                    self._cond.notify_all()
        self.flush_inflight()

    def _wait_locked(self) -> Optional[float]:
        """Seconds until the oldest parked entry ripens (None = idle)."""
        if not self._groups:
            return None
        oldest = min(
            entries[0].enq_t for entries in self._groups.values() if entries
        )
        return max(
            0.0, oldest + self.config.max_wait_us / 1e6 - time.monotonic()
        )

    def _pop_ripe_locked(self):
        """Pop the ripest group (size/bytes/deadline), or None."""
        now = time.monotonic()
        ripe_key = None
        for key, entries in self._groups.items():
            if not entries:
                continue
            nkeys = sum(e.nkeys for e in entries)
            nbytes = sum(e.nbytes for e in entries)
            if (
                self._urgent
                or self._stop
                or nkeys >= self.config.max_keys
                or nbytes >= self.config.max_bytes
                or now - entries[0].enq_t >= self.config.max_wait_us / 1e6
            ):
                ripe_key = key
                break
        if ripe_key is None:
            return None
        entries = self._groups.pop(ripe_key)
        self._parked_keys -= sum(e.nkeys for e in entries)
        obs_counters.set_gauge("ingest_parked_current", self._parked_keys)
        return ripe_key, entries

    # -- flush ---------------------------------------------------------------

    def _flush(self, name: str, kind: str, entries: list) -> None:
        """One flush, optionally traced: when any parked
        request is captured, the flush runs under ITS OWN trace id —
        the ``ingest.flush`` root span LINKS every traced request's
        root span, the request context it opens turns the kernel
        phases (host_prep/h2d/kernel) into the flush span's children,
        and the merged op-log record is minted under the flush rid
        (``_log_op`` reads ``obs.current_rid()``), so replica applies
        of the merged record join the same trace. Untraced flushes
        take the exact untraced path."""
        refs = [e.trace for e in entries if e.trace is not None]
        if not (obs_trace.enabled() and refs):
            return self._flush_inner(name, kind, entries, None)
        frid = obs.new_rid()
        froot = obs_trace.new_span_id()
        with obs.request(f"ingest.{kind}", rid=frid) as rctx:
            rctx.trace_armed = True
            rctx.trace_span = froot
            try:
                return self._flush_inner(name, kind, entries, (frid, froot))
            finally:
                obs_trace.record_span(
                    "ingest.flush",
                    rid=frid,
                    span=froot,
                    start=rctx.started_at,
                    duration_s=max(0.0, time.time() - rctx.started_at),
                    attrs={
                        "filter": name,
                        "op": kind,
                        "requests": len(entries),
                        "keys": int(sum(e.nkeys for e in entries)),
                    },
                    links=[{"rid": r, "span": s} for r, s in refs],
                )
                obs_trace.commit_children(rctx, froot)

    def _flush_inner(
        self, name: str, kind: str, entries: list, ftrace
    ) -> None:
        from tpubloom_torch.server import protocol

        service = self._service
        faults.fire("ingest.flush")
        try:
            mf = service._get(name)
        except protocol.BloomServiceError as e:
            for entry in entries:
                entry.complete(error=e)
            return
        service.metrics.count("ingest_flushes")
        service.metrics.count("ingest_requests_coalesced", len(entries))
        total_keys = sum(e.nkeys for e in entries)
        service.metrics.count("ingest_keys_coalesced", total_keys)
        if kind in ("query", "delete", "clear"):
            if kind == "query":
                service.metrics.count("ingest_query_flushes")
            elif kind == "delete":
                service.metrics.count("ingest_delete_flushes")
            else:
                service.metrics.count("ingest_clear_flushes")
            self._retry_evicted(name, mf, {
                "query": lambda m: self._flush_query(m, entries),
                "delete": lambda m: self._flush_delete(
                    name, m, entries, ftrace
                ),
                "clear": lambda m: self._flush_clear(
                    name, m, entries, ftrace
                ),
            }[kind])
            return
        # op-sorted flushes: ONE presence-wanting
        # request used to drag every flush-mate through the fused
        # test-and-insert kernel, which on tpubloom's TPU ran slower than
        # the insert-only one. Sort the parked run instead — plain
        # inserts ride the insert-only launch, presence requests ride
        # the fused one. Two launches + two merged log records, but
        # each at its op's best rate; the mix counters say how often
        # the split actually pays.
        plain = [e for e in entries if not e.want_presence]
        pres = [e for e in entries if e.want_presence]
        # the launch-mix counters: plain + fused launches sum to all
        # insert launches, split counts the parked runs that got sorted
        # into both — so the op-sort lever's reach is derivable
        if plain and pres:
            service.metrics.count("ingest_split_flushes")
        if plain:
            service.metrics.count("ingest_plain_flushes")
        if pres:
            service.metrics.count("ingest_fused_flushes")
        for part in (plain, pres):
            if not part:
                continue
            # error containment PER PART: by the time the second part
            # runs, the first part's writes may already be applied,
            # logged, and parked on the completer awaiting their
            # barrier verdict — letting a second-part failure propagate
            # to the run loop's catch would error-complete THOSE
            # entries too (a generic INTERNAL on an applied+logged
            # write invites a fresh-rid client retry = double apply).
            # Each part owns exactly its own waiters.
            try:
                self._retry_evicted(
                    name, mf,
                    lambda m: self._flush_insert(name, m, part, ftrace),
                )
            except BaseException as e:  # noqa: BLE001 — waiters must wake
                log.exception("ingest flush part for %r failed", name)
                err = (
                    e if isinstance(e, protocol.BloomServiceError)
                    else protocol.BloomServiceError(
                        "INTERNAL", f"ingest flush failed: {e!r}"
                    )
                )
                for entry in part:
                    if not entry.event.is_set():
                        entry.complete(error=err)

    def _retry_evicted(self, name: str, mf, fn):
        """Run one flush body, re-resolving across eviction races:
        ``_check_live`` raises FIRST under every flush's op
        lock, before anything applies, so the retry is clean — the
        re-resolve hydrates the live filter and the body re-runs."""
        from tpubloom_torch.server import protocol

        for _ in range(4):
            try:
                return fn(mf)
            except _EvictedRace:
                mf = self._service._get(name)
        raise protocol.BloomServiceError(
            "INTERNAL",
            f"flush for {name!r} kept racing evictions — giving up",
        )

    @staticmethod
    def _log_parts(logged: dict, entries: list) -> None:
        """Stamp the merged record with its replay-unsafe constituents:
        ``parts = [[rid, nkeys], ...]``. A merged record
        used to carry only the FLUSH rid, so a restart (or a promoted
        replica) could not answer a parked request's own rid from the
        dedup cache — a client replaying an applied-but-unacked
        counting insert after a crash would double-apply. Replaying the
        record now re-seeds one dedup entry per part
        (:meth:`BloomService.apply_record`)."""
        parts = [
            [e.rid, e.nkeys]
            for e in entries if e.replay_unsafe and e.rid
        ]
        if parts:
            logged["parts"] = parts

    @staticmethod
    def _demote_wide_rows(mf, rows, keys):
        """Fixed-width keys WIDER than the filter's key_len cannot take
        the packed path — materialize the list so ``key_policy``
        applies (digest/error), exactly as on the direct path's
        ``_packed_ok`` fallback."""
        if rows is None:
            return rows, keys
        key_len = getattr(getattr(mf.filter, "config", None), "key_len", None)
        if key_len is not None and rows.shape[1] > key_len:
            return None, _rows_to_list(rows)
        return rows, keys

    @staticmethod
    def _merge(entries: list):
        """Merged keys for one flush: ``(rows, keys)`` — a single
        ``uint8[N, W]`` array when every entry shipped fixed-width keys
        of one width (zero-copy concat), else one materialized list."""
        widths = {
            e.rows.shape[1] for e in entries if e.rows is not None
        }
        if len(widths) == 1 and all(e.rows is not None for e in entries):
            if len(entries) == 1:
                return entries[0].rows, None
            return np.concatenate([e.rows for e in entries]), None
        merged: list = []
        for e in entries:
            merged.extend(_keys_of(e))
        return None, merged

    def _flush_query(self, mf, entries: list) -> None:
        rows, keys = self._demote_wide_rows(mf, *self._merge(entries))
        # stage OUTSIDE the op lock where the filter supports it — the
        # host prep/H2D of this flush overlaps the previous flush's
        # in-flight kernel (double buffering)
        staged = None
        if self._service._staged_ok(mf):
            staged = mf.filter.stage_batch(keys, rows=rows)
        with mf.lock:
            _check_live(mf)
            if staged is not None:
                hits_dev, n = mf.filter.launch_query(staged)
                # the padded verdicts stay on the filter's device (the
                # card's tensor has no numpy view): the copy is the fence
                # + D2H, the slice drops the padding
                with obs.phase("d2h"):
                    hits = hits_dev.cpu().numpy()[:n]
            else:
                hits = np.asarray(
                    mf.filter.include_batch(
                        keys if keys is not None else _rows_to_list(rows)
                    )
                )
        self._service.metrics.count("keys_queried", sum(e.nkeys for e in entries))
        off = 0
        for entry in entries:
            span = hits[off: off + entry.nkeys]
            off += entry.nkeys
            entry.complete(resp={
                "ok": True,
                "hits": np.packbits(span).tobytes(),
                "n": entry.nkeys,
                "_coalesced": True,
            })

    def _flush_insert(self, name: str, mf, entries: list, ftrace=None) -> None:
        service = self._service
        rows, keys = self._demote_wide_rows(mf, *self._merge(entries))
        want_presence = any(e.want_presence for e in entries)
        supports_staged = not want_presence and service._staged_ok(mf)
        staged = (
            mf.filter.stage_batch(keys, rows=rows) if supports_staged else None
        )
        # fence + settle the PREVIOUS flush before this one's (donating)
        # launch — its kernel had our whole staging window to run, and a
        # barrier-bearing completion hops to the completer thread, so
        # neither blocks the dispatcher.
        self._settle(*self._inflight.take())
        presence = None
        with mf.lock:
            _check_live(mf)
            if service.cluster is not None and (
                service.cluster.forward_target(name) is not None
            ):
                # dual-write window: a merged record would make N
                # requests share ONE src_seq and the target's gate would
                # drop every forward but the first — fall back to the
                # per-request direct path (checked under the SAME lock
                # MigrateSlot arms forwards under, so a snapshot taken
                # after this hold covers everything we would apply)
                fallback = True
            else:
                fallback = False
                if staged is not None:
                    out = mf.filter.launch_insert(staged)
                elif want_presence:
                    klist = keys if keys is not None else _rows_to_list(rows)
                    if mf.supports_presence:
                        presence = mf.filter.insert_batch(
                            klist, return_presence=True
                        )
                    else:
                        presence = mf.filter.include_batch(klist)
                        mf.filter.insert_batch(klist)
                    out = None
                else:
                    klist = keys if keys is not None else _rows_to_list(rows)
                    mf.filter.insert_batch(klist)
                    out = None
                # honest-FULL verdicts: cuckoo inserts can
                # reject; collect the per-key flags under the lock —
                # they are per-launch state the NEXT flush would clobber
                # (for a staged launch this fences it early; cuckoo's
                # kick chain is sequential anyway, and honesty beats
                # overlap). Rejected keys still ride the logged record:
                # the kernels are deterministic, so a replica / crash
                # replay rejects the exact same keys.
                full = None
                taker = getattr(mf.filter, "take_insert_flags", None)
                if taker is not None:
                    flags = taker()
                    if flags is not None and not flags.all():
                        full = ~np.asarray(flags, dtype=bool)
                        if out is not None:
                            out = None  # already fenced by the flag read
                # ONE op-log append covers the whole flush (log before
                # notify — the ordering rule)
                logged: dict = {"name": name}
                if rows is not None:
                    logged["keys_fixed"] = {
                        "data": rows.tobytes(),
                        "width": int(rows.shape[1]),
                        "n": int(rows.shape[0]),
                    }
                else:
                    logged["keys"] = keys
                self._log_parts(logged, entries)
                seq = service._log_op("InsertBatch", logged, mf)
                if mf.checkpointer:
                    mf.checkpointer.notify_inserts(
                        sum(e.nkeys for e in entries)
                    )
        if fallback:
            self._fallback_direct(entries)
            return
        service.metrics.count(
            "keys_inserted", sum(e.nkeys for e in entries)
        )
        if presence is not None:
            presence = np.asarray(presence)  # fence + D2H, outside the lock

        def finalize():
            self._finalize_insert(entries, seq, presence, ftrace, full=full)

        payload = (entries, finalize, self._needs_barrier(entries, seq))
        if out is not None:
            # double buffering: park the launched (unfenced) kernel;
            # the NEXT flush's staging (or the run loop's idle check)
            # overlaps it, then settles us
            self._inflight.put(out, payload)
        else:
            self._settle(payload, None)

    def _flush_delete(self, name: str, mf, entries: list, ftrace=None) -> None:
        """Delete-only flush (the seam): ONE
        ``delete_batch`` launch over the merged keys + ONE op-log append
        + ONE commit barrier, demuxed per request exactly like inserts.
        Deletes are always replay-unsafe (a replayed decrement double-
        applies), so every entry's demuxed response is dedup-cached
        under its rid by the shared finalize."""
        service = self._service
        rows, keys = self._demote_wide_rows(mf, *self._merge(entries))
        # fence + settle any in-flight insert flush BEFORE the (donating)
        # delete launch consumes its output buffer — a real kernel error
        # must fail the INSERT's waiters, not surface as this delete's
        self._settle(*self._inflight.take())
        with mf.lock:
            _check_live(mf)
            if service.cluster is not None and (
                service.cluster.forward_target(name) is not None
            ):
                # dual-write window: per-request seqs keep the target's
                # exactly-once gate sound — same fallback as inserts
                fallback = True
            else:
                fallback = False
                klist = keys if keys is not None else _rows_to_list(rows)
                dout = mf.filter.delete_batch(klist)
                deleted = None
                if dout is not None and sketch_registry.is_sketch(
                    mf.filter.config
                ):
                    # cuckoo per-key "a stored copy existed" verdicts,
                    # demuxed back to each parked request like presence
                    deleted = np.asarray(dout, dtype=bool)
                logged: dict = {"name": name}
                if rows is not None:
                    logged["keys_fixed"] = {
                        "data": rows.tobytes(),
                        "width": int(rows.shape[1]),
                        "n": int(rows.shape[0]),
                    }
                else:
                    logged["keys"] = keys
                self._log_parts(logged, entries)
                seq = service._log_op("DeleteBatch", logged, mf)
        if fallback:
            self._fallback_direct(entries, method="DeleteBatch")
            return
        service.metrics.count("keys_deleted", sum(e.nkeys for e in entries))

        def finalize():
            self._finalize_insert(entries, seq, None, ftrace, deleted=deleted)

        self._settle((entries, finalize, self._needs_barrier(entries, seq)), None)

    def _flush_clear(self, name: str, mf, entries: list, ftrace=None) -> None:
        """Clear-only flush: the whole parked run collapses to ONE
        ``clear()`` + ONE op-log append + ONE barrier (clears are
        idempotent, so N concurrent clears ARE one clear — no dedup
        caching needed and no per-request payload to demux)."""
        service = self._service
        self._settle(*self._inflight.take())  # see _flush_delete
        with mf.lock:
            _check_live(mf)
            if service.cluster is not None and (
                service.cluster.forward_target(name) is not None
            ):
                fallback = True
            else:
                fallback = False
                mf.filter.clear()
                seq = service._log_op("Clear", {"name": name}, mf)
        if fallback:
            self._fallback_direct(entries, method="Clear")
            return

        def finalize():
            self._finalize_insert(entries, seq, None, ftrace)

        self._settle((entries, finalize, self._needs_barrier(entries, seq)), None)

    def _needs_barrier(self, entries, seq) -> bool:
        if seq is None:
            return False
        return max(
            [self._service.min_replicas_to_write]
            + [e.min_replicas for e in entries]
        ) > 0

    def _settle(self, payload, fence_err) -> None:
        """Complete one fenced flush. A REAL fence error (device/kernel
        failure — the benign donated-buffer case is filtered by
        :meth:`InFlight.take`) fails every waiter instead of acking
        writes that never landed. Otherwise the finalize runs inline
        when it is pure demux, and hops to the completer thread when it
        carries a commit barrier — a quorum wait must never head-of-
        line-block other filters' flushes on the dispatcher."""
        if payload is None:
            return
        entries, finalize, barrier = payload
        if fence_err is not None:
            from tpubloom_torch.server import protocol

            log.error("ingest flush kernel failed: %r", fence_err)
            err = protocol.BloomServiceError(
                "INTERNAL", f"coalesced flush kernel failed: {fence_err!r}"
            )
            for entry in entries:
                if not entry.event.is_set():
                    entry.complete(error=err)
            return
        if barrier:
            with self._cond:
                self._completing += 1
            self._completions.put(finalize)  # bounded — backpressure
        else:
            finalize()

    def _completion_loop(self) -> None:
        while True:
            fn = self._completions.get()
            if fn is None:
                return
            try:
                fn()  # _finalize_insert is self-protective
            finally:
                with self._cond:
                    self._completing -= 1
                    self._cond.notify_all()

    def flush_inflight(self) -> None:
        """Fence + settle any parked double-buffered flush (dispatcher
        thread only — the run loop calls this when the queues go idle)."""
        payload, err = self._inflight.take()
        if payload is None:
            return
        self._settle(payload, err)
        with self._cond:
            self._cond.notify_all()

    def _finalize_insert(
        self, entries, seq, presence, ftrace=None, full=None, deleted=None
    ) -> None:
        """Demux one applied flush back to its parked requests: dedup
        caching, presence/full/deleted slices, and ONE commit barrier
        whose achieved count settles every request's own quorum.
        Self-protective: any unexpected error completes EVERY
        still-parked entry (a finalize may run from the double-buffer
        path, outside the run loop's per-flush catch — waiters must
        never hang)."""
        from tpubloom_torch.server import protocol

        try:
            self._finalize_insert_inner(
                entries, seq, presence, ftrace, full=full, deleted=deleted
            )
        except BaseException as e:  # noqa: BLE001 — waiters must wake
            log.exception("ingest finalize failed")
            err = (
                e if isinstance(e, protocol.BloomServiceError)
                else protocol.BloomServiceError(
                    "INTERNAL", f"ingest finalize failed: {e!r}"
                )
            )
            for entry in entries:
                if not entry.event.is_set():
                    entry.complete(error=err)

    def _finalize_insert_inner(
        self, entries, seq, presence, ftrace=None, full=None, deleted=None
    ) -> None:
        from tpubloom_torch.server import protocol

        service = self._service
        acked, barrier_error = self._flush_barrier(entries, seq, ftrace)
        off = 0
        for entry in entries:
            resp: dict = {"ok": True, "n": entry.nkeys}
            if seq is not None:
                resp["repl_seq"] = seq
            if entry.want_presence and presence is not None:
                span = presence[off: off + entry.nkeys]
                resp["presence"] = np.packbits(span).tobytes()
            if full is not None:
                span = full[off: off + entry.nkeys]
                if span.any():  # same shape as the direct path: "full"
                    # is present iff this request had rejected keys
                    resp["full"] = np.packbits(span).tobytes()
            if deleted is not None:
                resp["deleted"] = np.packbits(
                    deleted[off: off + entry.nkeys]
                ).tobytes()
            off += entry.nkeys
            if entry.replay_unsafe:
                # cache the CLEAN response (no barrier verdict): a
                # same-rid retry replays it through the wrapper, which
                # re-waits on the same record — direct-path parity
                service._dedup_put(entry.rid, dict(resp))
            needed = max(service.min_replicas_to_write, entry.min_replicas)
            if needed > 0:
                if seq is None and service.oplog is None:
                    entry.complete(error=protocol.BloomServiceError(
                        "NOT_ENOUGH_REPLICAS",
                        f"min_replicas={needed} requires replication "
                        f"(start the server with --repl-log-dir)",
                        details={"acked": 0, "needed": needed,
                                 "applied": True},
                    ))
                    continue
                if seq is not None and acked < needed:
                    details = {
                        "acked": acked, "needed": needed, "seq": seq,
                        "applied": True, "coalesced": len(entries),
                    }
                    if barrier_error is not None:
                        details.setdefault(
                            "timeout_ms",
                            barrier_error.details.get("timeout_ms"),
                        )
                    entry.complete(error=protocol.BloomServiceError(
                        "NOT_ENOUGH_REPLICAS",
                        f"only {acked}/{needed} replica(s) acked seq "
                        f"{seq} for this coalesced flush — the write "
                        f"applied, only its quorum ack is missing",
                        details=details,
                    ))
                    continue
                resp["acked_replicas"] = acked
            resp["_coalesced"] = True
            entry.complete(resp=resp)

    def _flush_barrier(self, entries, seq, ftrace=None):
        """ONE ``wait_acked`` for the whole flush, at the strongest
        quorum any entry demanded and the longest budget any entry
        brought; returns ``(achieved ack count, barrier error or
        None)``. With the flush traced, the barrier records its own
        ``barrier.wait`` span under the flush root (it runs on the
        completer thread, after the flush context is gone)."""
        from tpubloom_torch.server import protocol

        service = self._service
        needed = max(
            [service.min_replicas_to_write]
            + [e.min_replicas for e in entries]
        )
        if needed <= 0 or seq is None:
            return 0, None
        budgets = [int(e.timeout_ms) for e in entries
                   if e.timeout_ms is not None]
        barrier_req: dict = {"min_replicas": needed}
        if budgets:
            barrier_req["min_replicas_timeout_ms"] = max(budgets)
        w0, t0 = time.time(), time.perf_counter()
        try:
            try:
                resp = service.commit_barrier(barrier_req, {"repl_seq": seq})
                return int(resp.get("acked_replicas") or 0), None
            except protocol.BloomServiceError as e:
                if e.code != "NOT_ENOUGH_REPLICAS":
                    raise
                acked = int(e.details.get("acked") or 0)
                # the fail-fast (fewer connected than the max quorum)
                # path reports 0 — weaker per-entry quorums may still
                # be met
                max_age = (service.min_replicas_max_lag_ms or 0) / 1000.0
                acked = max(
                    acked,
                    service.repl_sessions.count_acked(seq, max_age=max_age),
                )
                return acked, e
        finally:
            if ftrace is not None:
                obs_trace.record_span(
                    "barrier.wait",
                    rid=ftrace[0],
                    parent=ftrace[1],
                    start=w0,
                    duration_s=time.perf_counter() - t0,
                    attrs={"seq": int(seq), "needed": int(needed)},
                )

    def _fallback_direct(self, entries: list, method: str = "InsertBatch") -> None:
        """Migration-window fallback: re-drive each parked request
        through the ordinary handler + its OWN barrier and dual-write
        forward — per-request seqs keep the target's exactly-once gate
        sound. Rare (only while a slot is mid-handoff), so the lost
        amortization is acceptable."""
        from tpubloom_torch.cluster import migrate as cluster_migrate
        from tpubloom_torch.server import protocol

        service = self._service
        handler = getattr(service, method)
        service.metrics.count("ingest_fallback_direct", len(entries))
        for entry in entries:
            try:
                resp = handler(entry.req)
                if resp.get("ok"):
                    resp = service.commit_barrier(entry.req, resp)
                    resp = cluster_migrate.forward_op(
                        service, method, entry.req, resp
                    )
                resp = dict(resp)
                resp["_coalesced"] = True
                entry.complete(resp=resp)
            except protocol.BloomServiceError as e:
                entry.complete(error=e)
            except BaseException as e:  # noqa: BLE001 — waiter must wake
                entry.complete(error=protocol.BloomServiceError(
                    "INTERNAL", f"ingest fallback failed: {e!r}"
                ))


def _keys_of(entry: _Entry) -> list:
    if entry.keys is not None:
        return list(entry.keys)
    return _rows_to_list(entry.rows)


def _rows_to_list(rows: np.ndarray) -> list:
    return [rows[i].tobytes() for i in range(rows.shape[0])]
