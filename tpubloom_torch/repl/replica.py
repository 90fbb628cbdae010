"""Replica side: consume a primary's ``ReplStream`` and apply it.

``python -m tpubloom_torch.server --replica-of host:port`` runs the normal
server read-only (writes get ``READONLY``, Redis parity) with one
:class:`ReplicaApplier` thread behind it:

* **sync** — first contact sends no cursor → full resync (snapshot blobs
  install via :meth:`BloomService.install_snapshot`, then the log tail);
  reconnects send the last fully-applied seq → partial resync when the
  primary still has the tail, a fresh full resync otherwise.
* **idempotent apply** — every record is gated twice: the stream-global
  cursor (records at or below it are never re-requested) and the
  per-filter ``applied_seq`` (a record already contained in an installed
  snapshot is skipped, counted in ``repl_records_skipped``). Killing the
  stream mid-batch and reconnecting therefore re-applies nothing — the
  chaos suite pins this with the ``repl.stream_send``/``repl.apply``
  fault points.
* **lag** — ``repl_lag_seq`` (head seq from records/heartbeats minus the
  applied cursor) and ``repl_lag_seconds`` (apply-time minus the
  record's primary commit time; 0 when caught up on a heartbeat).
* **liveness** — transport errors back off exponentially
  (``repl_reconnects``); the link state lands in Health via
  :meth:`status` (``link: connected/connecting/lost``).
* **acks** — alongside the sync stream the applier keeps a
  client-streaming ``ReplAck`` RPC open (:class:`_AckSender`), echoing
  the session id from the sync frame with every applied cursor
  (coalesced latest-wins + periodic re-ack). This is the upstream half
  of the primary's ``WAIT`` / ``min-replicas-to-write`` durability
  gate; fault point ``repl.ack`` drops individual frames (ack loss).
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
import zlib
from typing import Optional

import grpc
import msgpack

from tpubloom_torch import faults
from tpubloom_torch.obs import blackbox as obs_blackbox
from tpubloom_torch.obs import counters as _counters
from tpubloom_torch.obs import trace as obs_trace
from tpubloom_torch.server import protocol
from tpubloom_torch.utils import crcjson
from tpubloom_torch.utils import locks

log = logging.getLogger("tpubloom.repl")


class FullResyncNeeded(Exception):
    """Raised by the apply path when a record's effect cannot be derived
    from the stream alone — e.g. a ``CreateFilter`` that bootstrapped
    state from a checkpoint the replica does not have, or a chained
    replica's local log refusing a gapped re-append. The applier drops
    its cursor and reconnects: the full-resync snapshot carries the
    state the record could not."""

    def __init__(self, name: str, reason: Optional[str] = None):
        super().__init__(
            reason
            or f"record for filter {name!r} references state only a full "
            f"resync can transfer"
        )
        self.name = name


class ReplicaStateStore:
    """Replica-side persistence of the replication cursor:
    ``<dir>/repl_cursor.json`` holds the last fully-applied
    seq + the primary log identity it belongs to, CRC32C-checked so a
    torn write reads as "no cursor" (→ full resync — the safe
    direction) rather than a bogus resume point. With it, a replica
    restart bootstraps from its local checkpoints and PARTIAL-resyncs
    instead of always paying a full one."""

    CURSOR_FILE = "repl_cursor.json"

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, self.CURSOR_FILE)

    def load(self) -> Optional[dict]:
        """``{"cursor": int, "log_id": str}`` or None (absent/corrupt)."""
        data = crcjson.load(self.path, ("cursor", "log_id"))
        if data is None:
            return None
        try:
            return {"cursor": int(data["cursor"]), "log_id": data["log_id"]}
        except (ValueError, TypeError):
            return None

    def store(self, cursor: int, log_id: Optional[str]) -> None:
        if log_id is None:
            return
        crcjson.store(self.path, {"cursor": int(cursor), "log_id": log_id})

    def clear(self) -> None:
        try:
            os.unlink(self.path)
        except OSError:
            pass


def bootstrap_from_local(service, state_store: Optional[ReplicaStateStore]):
    """Restart path of a replica with local durability: rebuild state
    from the creation manifest + local checkpoints (chained replicas:
    the caller already ran ``replay_oplog``) and return the
    ``(cursor, log_id)`` to resume the stream from — or ``(None, None)``
    when only a full resync is safe.

    The resume cursor is the MIN over restored filters of the op seq
    their restored bytes cover: every record at or below it is contained
    in some filter's restored state (per-filter ``repl_seq`` gates skip
    the overlap above it), so nothing is lost and nothing double-applies.
    """
    saved = state_store.load() if state_store is not None else None
    if saved is None or not saved.get("log_id"):
        return None, None
    if service.oplog is not None:
        # chained replica: replay already drove the local log over the
        # restored checkpoints — state coverage IS the log head
        return service.oplog.last_seq, saved["log_id"]
    manifest = service._manifest_read() or {}
    if not manifest:
        # empty filter set at the persisted cursor is exactly the state
        return saved["cursor"], saved["log_id"]
    seqs = []
    for name, create_req in manifest.items():
        try:
            service.CreateFilter(
                {**create_req, "exist_ok": True, "restore": True}
            )
        except Exception:
            log.exception(
                "replica bootstrap: re-creating filter %r failed — "
                "falling back to a full resync", name,
            )
            return None, None
        mf = service._filters.get(name)
        if mf is None or mf.applied_seq <= 0:
            # no restorable checkpoint for this filter: its state cannot
            # be rebuilt locally, only a full resync carries it
            return None, None
        seqs.append(mf.applied_seq)
    cursor = min(seqs)
    _counters.incr("repl_bootstrap_partial_resyncs")
    log.info(
        "replica bootstrap: %d filter(s) restored locally; resuming the "
        "stream from seq %d", len(seqs), cursor,
    )
    return cursor, saved["log_id"]


class _AckSender:
    """Replica→primary acknowledgement stream: feeds the
    client-streaming ``ReplAck`` RPC with ``{"sid", "seq"}`` frames.

    Coalescing is latest-wins: the applier calls :meth:`update` per
    applied record, the generator ships whatever the newest cursor is
    when gRPC drains it — a fast apply loop costs one frame per drain,
    not one per record. An idle stream re-sends the current cursor
    every ``reack_s`` seconds, which (a) keeps the primary's ack
    freshness view live and (b) heals any frame lost in flight (the
    ``repl.ack`` fault point drops frames exactly there, so a chaos run
    recovers the moment it disarms).
    """

    def __init__(self, channel, sid: int, *, reack_s: float = 0.5):
        self.sid = sid
        self.reack_s = reack_s
        self._cond = locks.named_condition("repl.ack_sender")
        self._seq: Optional[int] = None
        self._sent: Optional[int] = None
        self._closed = False
        multi = channel.stream_unary(
            protocol.method_path("ReplAck"),
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b,
        )
        self._future = multi.future(self._frames(), timeout=None)

    @property
    def broken(self) -> bool:
        """True once the RPC ended (server killed the ack stream, e.g.
        an injected ``repl.ack_recv``) — the applier re-opens it."""
        return self._future.done() and not self._closed

    def update(self, seq: int) -> None:
        with self._cond:
            if self._seq is None or seq > self._seq:
                self._seq = seq
                self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._future.cancel()

    def _frames(self):
        while True:
            with self._cond:
                if self._closed:
                    return
                if self._seq is None or self._seq == self._sent:
                    self._cond.wait(self.reack_s)
                if self._closed:
                    return
                seq = self._seq
                if seq is None:
                    continue
                self._sent = seq
            try:
                # ack-loss injection: a firing drops THIS frame only —
                # the seq stays marked sent, and the periodic re-ack
                # path retries it after reack_s (heals once disarmed)
                faults.fire("repl.ack")
            except faults.InjectedFault:
                _counters.incr("repl_acks_dropped")
                continue
            _counters.incr("repl_acks_sent")
            yield protocol.encode({"sid": self.sid, "seq": seq})


class ReplicaApplier:
    """Background thread that keeps a local (read-only) service in sync
    with a primary."""

    #: applied records between throttled cursor persists (the gates make
    #: a stale persisted cursor merely re-stream records, never re-apply)
    PERSIST_EVERY = 64

    def __init__(
        self,
        service,
        primary_address: str,
        *,
        reconnect_base: float = 0.2,
        reconnect_max: float = 5.0,
        state_store: Optional[ReplicaStateStore] = None,
        listen_address: Optional[str] = None,
        initial_cursor: Optional[int] = None,
        initial_log_id: Optional[str] = None,
    ):
        self.service = service
        self.primary_address = primary_address
        self.reconnect_base = reconnect_base
        self.reconnect_max = reconnect_max
        #: replica-side cursor persistence
        self.state_store = state_store
        #: this replica's announced serving address (sentinel discovery)
        self.listen_address = listen_address
        #: last op seq fully applied (the reconnect cursor); None until
        #: the first successful sync
        self.cursor: Optional[int] = initial_cursor
        #: the primary log identity the cursor belongs to (Redis replid
        #: parity) — echoed on reconnect; a primary whose log identity
        #: changed (rewound/recreated) answers with a full resync
        self.log_id: Optional[str] = initial_log_id
        self.head_seq = 0
        self.link = "connecting"
        self.full_syncs = 0
        self.partial_syncs = 0
        self.records_applied = 0
        self.records_skipped = 0
        self.last_sync_kind: Optional[str] = None
        self._since_persist = 0
        self._stop = threading.Event()
        self._call = None
        self._call_lock = locks.named_lock("repl.applier_call")
        #: live ReplAck sender (sync-repl); rebuilt per sync
        self._ack: Optional[_AckSender] = None
        self._channel = None
        self._thread = threading.Thread(
            target=self._run, name="tpubloom-replica", daemon=True
        )
        service.replica_applier = self
        service.primary_address = primary_address
        #: from here on the local op log (if any) is fed by reappend —
        #: handler-side appends would mint conflicting seqs
        service._stream_fed = True
        # crash-forensics black box: replicas used
        # to arm the rings only when the server ENTRYPOINT had a
        # log/ckpt dir to pass along — an in-process chaos replica
        # (test_repl / test_sync_repl) carries a state store but never
        # runs that entrypoint, so its post-mortem rings did not exist.
        # Arm from whatever durable dir this replica already owns; the
        # box is process-global, so never steal one another configure()
        # claimed (the replica's records still land in THAT ring), and
        # only stamp node identity on the ring we armed ourselves —
        # overwriting a co-hosted primary's meta would misattribute its
        # post-mortem timeline.
        state_dir = None
        if state_store is not None:
            state_dir = state_store.directory
        elif service.oplog is not None:
            state_dir = getattr(service.oplog, "directory", None)
        if state_dir is not None and not obs_blackbox.enabled():
            obs_blackbox.configure(
                state_dir,
                node={
                    k: v
                    for k, v in {
                        "role": "replica",
                        "addr": listen_address,
                        "primary": primary_address,
                    }.items()
                    if v is not None
                },
            )

    def start(self) -> "ReplicaApplier":
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        with self._call_lock:
            if self._call is not None:
                self._call.cancel()
            if self._ack is not None:
                self._ack.close()
                self._ack = None
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)
        self._persist_cursor(force=True)

    def _persist_cursor(self, force: bool = False) -> None:
        """Throttled write of the resume point (every PERSIST_EVERY
        applied records + every sync transition + on stop): staler only
        costs re-streamed records — the seq gates absorb them."""
        if self.state_store is None or self.cursor is None:
            return
        self._since_persist += 1
        if force or self._since_persist >= self.PERSIST_EVERY:
            self._since_persist = 0
            try:
                self.state_store.store(self.cursor, self.log_id)
            except OSError:
                log.exception("repl cursor persist failed (non-fatal)")

    def status(self) -> dict:
        return {
            "primary": self.primary_address,
            "link": self.link,
            "cursor": self.cursor,
            "log_id": self.log_id,
            "head_seq": self.head_seq,
            "lag_seq": max(0, self.head_seq - (self.cursor or 0)),
            "full_syncs": self.full_syncs,
            "partial_syncs": self.partial_syncs,
            "records_applied": self.records_applied,
            "records_skipped": self.records_skipped,
            "sync_repl": self._ack is not None and not self._ack.broken,
        }

    def wait_caught_up(self, timeout: float = 30.0, poll: float = 0.02) -> bool:
        """Test/operator helper: block until lag_seq == 0 after at least
        one successful sync. NOTE: ``head_seq`` is the newest seq the
        *replica has heard of* — a write committed on the primary a
        moment ago may not be in it yet; to wait for a specific write
        use :meth:`wait_for_seq` with the primary's log seq."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if (
                self.cursor is not None
                and self.link == "connected"
                and self.head_seq <= self.cursor
            ):
                return True
            time.sleep(poll)
        return False

    def wait_for_seq(self, seq: int, timeout: float = 30.0, poll: float = 0.02) -> bool:
        """Block until the replica has applied (or skipped as already
        contained) every record up to ``seq`` — the read-your-writes
        barrier: pass the primary's log seq after a write."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.cursor is not None and self.cursor >= seq:
                return True
            time.sleep(poll)
        return False

    # -- stream loop ---------------------------------------------------------

    def _run(self) -> None:
        attempt = 0
        while not self._stop.is_set():
            channel = grpc.insecure_channel(
                self.primary_address,
                options=[
                    ("grpc.max_receive_message_length", 256 * 1024 * 1024),
                ],
            )
            self._channel = channel
            stream_call = channel.unary_stream(
                protocol.method_path("ReplStream"),
                request_serializer=lambda b: b,
                response_deserializer=lambda b: b,
            )
            req: dict = {"caps": ["batch-zlib"]}
            if self.listen_address:
                req["listen"] = self.listen_address
            if self.cursor is not None:
                req["cursor"] = self.cursor
                req["log_id"] = self.log_id
            try:
                self.link = "connecting"
                call = stream_call(protocol.encode(req), timeout=None)
                with self._call_lock:
                    self._call = call
                for raw in call:
                    attempt = 0  # any delivered message resets backoff
                    self._handle(protocol.decode(raw))
                    if self._stop.is_set():
                        break
            except FullResyncNeeded as e:
                log.info(
                    "replication: %s — dropping cursor for a full resync", e
                )
                self.cursor = None
                attempt = 0
            except grpc.RpcError as e:
                if not self._stop.is_set():
                    code = getattr(e, "code", lambda: None)()
                    log.warning(
                        "replication stream to %s lost (%s); reconnecting",
                        self.primary_address, code,
                    )
            except Exception:
                log.exception("replication apply failed; reconnecting")
                # a replica that cannot apply what
                # its primary sent is a fail-stop in miniature — freeze
                # both black-box rings NOW, before minutes of reconnect
                # churn lap the records that explain the bad apply
                obs_blackbox.snapshot_rings("replica-failstop")
            finally:
                with self._call_lock:
                    self._call = None
                    # the ack stream rides this channel — tear it down
                    # with the sync stream; the next sync re-opens it
                    # under its fresh session id
                    if self._ack is not None:
                        self._ack.close()
                        self._ack = None
                channel.close()
                self._channel = None
            if self._stop.is_set():
                break
            self.link = "lost"
            _counters.incr("repl_reconnects")
            delay = min(
                self.reconnect_max, self.reconnect_base * (2 ** attempt)
            ) * (0.5 + random.random())
            attempt += 1
            self._stop.wait(delay)
        self.link = "stopped"

    def _handle(self, msg: dict) -> None:
        kind = msg.get("kind")
        if kind == "full_sync_begin":
            self.link = "syncing"
            self.last_sync_kind = "full"
            self.full_syncs += 1
            self.head_seq = msg["seq"]
            self._sync_filters = list(msg.get("filters", ()))
        elif kind == "snapshot":
            self.service.install_snapshot(
                msg["name"], msg["blob"], msg["applied_seq"]
            )
        elif kind == "full_sync_end":
            # drop local filters the primary no longer has — a full
            # resync is a state reset, not a merge
            self.service.retain_only(self._sync_filters)
            self.cursor = msg["cursor"]
            self.log_id = msg.get("log_id")
            if self.service.oplog is not None:
                # chained: the local log's history is no longer a prefix
                # of anything real — wipe it, restart the seq space at
                # the resync cursor, rotate its identity so downstream
                # cursors full-resync too (their state reset with ours)
                self.service.oplog.reset_to(self.cursor)
            self._adopt_epoch(msg)
            # gauge before link flips: wait_caught_up gates on
            # link == "connected", and callers read repl_lag_seq the
            # moment it returns — _start_ack below can take a while
            _counters.set_gauge(
                "repl_lag_seq", max(0, self.head_seq - (self.cursor or 0))
            )
            self.link = "connected"
            self._persist_cursor(force=True)
            self._start_ack(msg)
        elif kind == "partial_sync":
            self.last_sync_kind = "partial"
            self.partial_syncs += 1
            self.cursor = msg["cursor"]
            self.log_id = msg.get("log_id")
            self._adopt_epoch(msg)
            _counters.set_gauge(
                "repl_lag_seq", max(0, self.head_seq - (self.cursor or 0))
            )
            self.link = "connected"
            self._persist_cursor(force=True)
            self._start_ack(msg)
        elif kind == "record":
            self._handle_record(msg)
        elif kind == "records":
            # coalesced+compressed frame (negotiated "batch-zlib" cap)
            records = msgpack.unpackb(
                zlib.decompress(msg["z"]), raw=False
            )
            _counters.incr("repl_batched_frames_received")
            for rec in records:
                self._handle_record(rec)
        elif kind == "heartbeat":
            self.head_seq = max(self.head_seq, msg["seq"])
            self._adopt_epoch(msg)
            if self.cursor is not None and self.head_seq <= self.cursor:
                _counters.set_gauge("repl_lag_seconds", 0.0)
            with self._call_lock:
                if self._ack is not None and self._ack.broken:
                    # the primary (or an injected repl.ack_recv) killed
                    # the ack stream: re-open it under the same session
                    # and re-send the current cursor
                    _counters.incr("repl_ack_stream_reopened")
                    sid = self._ack.sid
                    self._ack.close()
                    self._ack = None
                    if self._channel is not None:
                        self._ack = _AckSender(self._channel, sid)
                        if self.cursor is not None:
                            self._ack.update(self.cursor)
        elif kind == "error":
            raise protocol.BloomServiceError(
                msg.get("code", "UNKNOWN"), msg.get("message", "")
            )
        _counters.set_gauge(
            "repl_lag_seq", max(0, self.head_seq - (self.cursor or 0))
        )

    def _start_ack(self, msg: dict) -> None:
        """(Re)open the ReplAck stream for the session id the sync frame
        announced; primaries predating sync-repl send no ``sid`` and get
        no acks (they have no barrier to feed either)."""
        sid = msg.get("sid")
        with self._call_lock:
            if self._ack is not None:
                self._ack.close()
                self._ack = None
            if sid is None or self._channel is None:
                return
            self._ack = _AckSender(self._channel, int(sid))
            if self.cursor is not None:
                # the sync point itself is applied state — ack it now so
                # a quorum blocked on pre-sync records unblocks without
                # waiting for the next record
                self._ack.update(self.cursor)

    def _adopt_epoch(self, msg: dict) -> None:
        """Sync/heartbeat frames carry the primary's topology epoch —
        replicas learn it passively, so a bare replica still fences
        stale ``Promote``/``ReplicaOf`` requests correctly."""
        epoch = msg.get("epoch")
        if epoch:
            self.service.adopt_epoch(int(epoch))

    def _handle_record(self, rec: dict) -> None:
        """One op record: re-append to the local log first when chained
        (write-ahead — replay is idempotent, a logged-but-unapplied
        record is healed by the seq gates at restart), then apply."""
        if self.service.oplog is not None:
            try:
                self.service.reappend_record(rec)
            except ValueError as e:
                # seq gap against the local log: only a full resync can
                # restore a coherent prefix — never paper over a gap
                raise FullResyncNeeded("<oplog>", reason=str(e))
        # distributed tracing: the apply is stamped with the
        # ORIGIN rid — the same trace id the client's hop, the server's
        # handler and the coalescer's flush used — so a cross-node
        # assembly shows where the record landed. Captured when the
        # record carries the forced flag (_log_op stamps it for sampled
        # requests and traced flushes), this node's own deterministic
        # rid sample hits, or — same rule the
        # server wrapper applies — the apply turns out SLOWLOG-WORTHY:
        # an unsampled record whose apply would enter this replica's
        # slowlog gets its span anyway, so the slow tail of the apply
        # path traces like the slow tail of the serve path. Timing runs
        # whenever the ring is armed, because the slow decision needs
        # the duration first.
        measured = obs_trace.enabled() and bool(rec.get("rid"))
        forced = False
        captured = False
        parent = None
        if measured:
            req_trace = (rec.get("req") or {}).get("trace")
            if isinstance(req_trace, dict):
                forced = bool(req_trace.get("forced"))
                captured = forced
                p = req_trace.get("span")
                parent = p if isinstance(p, str) else None
            else:
                captured = obs_trace.hit(rec["rid"])
        w0 = time.time() if measured else 0.0
        t0 = time.perf_counter() if measured else 0.0
        applied = self.service.apply_record(rec)
        if measured:
            duration_s = time.perf_counter() - t0
            # the probe (a slowlog lock round trip) only matters when
            # the record is not already captured
            slow = not captured and self.service.slowlog.would_record(
                duration_s
            )
            if captured or slow:
                obs_trace.record_span(
                    "repl.apply",
                    rid=rec["rid"],
                    parent=parent,
                    start=w0,
                    duration_s=duration_s,
                    attrs={
                        "seq": int(rec["seq"]),
                        "method": rec.get("method"),
                        "filter": (rec.get("req") or {}).get("name"),
                        "applied": bool(applied),
                    },
                    # forced and slowlog-worthy applies persist to the
                    # black box — a replica killed mid-apply
                    # leaves the spans that explain what it was doing
                    spill=forced or slow,
                )
        if applied:
            self.records_applied += 1
            _counters.incr("repl_records_applied")
        else:
            self.records_skipped += 1
            _counters.incr("repl_records_skipped")
        self.head_seq = max(self.head_seq, rec["seq"])
        # gauge BEFORE the cursor advance: wait_caught_up polls the
        # cursor from another thread, and callers assert repl_lag_seq
        # the moment it flips — the gauge must already agree
        _counters.set_gauge(
            "repl_lag_seq", max(0, self.head_seq - rec["seq"])
        )
        self.cursor = rec["seq"]
        ack = self._ack
        if ack is not None:
            ack.update(rec["seq"])
        self._persist_cursor()
        _counters.set_gauge(
            "repl_lag_seconds", max(0.0, time.time() - rec.get("ts", 0))
        )
