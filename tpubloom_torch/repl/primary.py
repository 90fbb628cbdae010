"""Primary side of the replication protocol (PSYNC parity).

A replica opens the server-streaming ``ReplStream`` RPC with a cursor
(the last op seq it fully applied; absent on first contact). The
primary answers the way Redis PSYNC does:

* **full resync** — cursor absent, or the checkpoint-keyed log
  truncation has already dropped the records past it: the primary
  snapshots every live filter (checkpoint-format blobs, each stamped
  with the op seq its bytes cover) and streams them, then tails the log
  from the oldest snapshot seq. The per-filter ``applied_seq`` stamps
  make the handoff race-free: a record the snapshot already contains is
  skipped by the replica's seq gate, not re-applied.
* **partial resync** — cursor still inside the log: ack and stream the
  tail (the Redis repl-backlog case).

Either way the stream then follows the live log (:meth:`OpLog.wait_for`)
and idles with heartbeats carrying the head seq, which is what the
replica's ``repl_lag_seq`` gauge measures against.

The :class:`ReplicaSessions` hub tracks connected streams (gauge
``repl_connected_replicas``; per-session cursors feed
``repl_max_replica_lag_seq`` and bound log truncation so a merely-slow
replica is not forced into a full resync).

Synchronous replication: the sync frames carry the session id
(``sid``), and the replica opens a companion client-streaming
``ReplAck`` RPC echoing it with every applied cursor
(:func:`repl_ack`). :meth:`ReplicaSessions.ack` folds the frames into
per-replica **acked** cursors, and :meth:`ReplicaSessions.wait_acked`
is the blocking primitive behind both the ``Wait`` RPC (Redis ``WAIT``
parity) and the ``min-replicas-to-write`` commit barrier — waiters
count replicas whose acked seq is at or past a record's seq, with the
currently-blocked count exported as the ``wait_blocked_current`` gauge
and per-replica acked seqs as ``repl_acked_seq{replica}``.

Fault point ``repl.stream_send`` fires before every snapshot/record
send — the chaos suite kills a stream mid-batch with it and proves the
reconnect replays nothing twice. ``repl.ack_recv`` fires per received
ack frame (a firing kills the ack stream; the replica re-opens it).
"""

from __future__ import annotations

import itertools
import threading
import time
import zlib

import msgpack

from tpubloom_torch import faults
from tpubloom_torch.obs import counters as _counters
from tpubloom_torch.utils import locks as _locks

#: How often an idle stream emits a heartbeat (seconds).
DEFAULT_HEARTBEAT_S = 0.5

#: Max records per poll round before re-checking liveness/cancellation.
STREAM_BATCH = 256

#: Capability flag a replica sends to opt into coalesced+compressed
#: record frames (WAN links). Negotiated: the
#: primary only batches when the replica advertised it AND the server
#: was started with ``--repl-batch-bytes``.
CAP_BATCH_ZLIB = "batch-zlib"


class ReplicaSessions:
    """Connected-replica registry: addresses, cursors, acked seqs, lag
    gauges, and the wait-for-quorum primitive."""

    def __init__(self):
        self._cond = _locks.named_condition("repl.sessions")
        self._ids = itertools.count()
        self._sessions: dict[int, dict] = {}
        self._waiters = 0

    def register(self, peer: str, listen: str | None = None) -> int:
        """``listen`` is the replica's ANNOUNCED serving address (its
        gRPC listener, not the ephemeral peer port) — what sentinels
        discover replicas by, Redis ``replica-announce-ip/port`` parity."""
        with self._cond:
            sid = next(self._ids)
            self._sessions[sid] = {
                "sid": sid,
                "peer": peer,
                "listen": listen,
                "cursor": 0,
                #: newest op seq the replica has ACKNOWLEDGED as applied
                #: (via ReplAck) — what Wait/min-replicas block on; the
                #: stream-side cursor only says what was SENT to it
                "acked": 0,
                #: monotonic time of the last ack FRAME (idle re-acks
                #: refresh it) — the commit barrier's freshness gate:
                #: an old-enough acked_at means the replica
                #: stopped talking, and its acked cursor is history, not
                #: durability
                "acked_at": 0.0,
                "connected_at": time.time(),
            }
            n = len(self._sessions)
        _counters.set_gauge("repl_connected_replicas", n)
        return sid

    def update(self, sid: int, cursor: int, head: int) -> None:
        with self._cond:
            sess = self._sessions.get(sid)
            if sess is not None:
                sess["cursor"] = cursor
            lags = [head - s["cursor"] for s in self._sessions.values()]
        _counters.set_gauge(
            "repl_max_replica_lag_seq", max(lags) if lags else 0
        )

    def ack(self, sid: int, seq: int) -> None:
        """Fold one ReplAck frame in: the replica behind session ``sid``
        has fully applied every record up to ``seq``. Monotone per
        session (a late/reordered frame never rewinds), and every
        advance wakes the quorum waiters."""
        with self._cond:
            sess = self._sessions.get(sid)
            if sess is None:
                return  # stream already reconnected under a new sid
            sess["acked_at"] = time.monotonic()
            if seq > sess["acked"]:
                sess["acked"] = seq
                self._cond.notify_all()
            elif self._waiters:
                # the seq did not advance but the FRESHNESS did (an idle
                # re-ack): an age-gated quorum waiter may be satisfiable
                # by exactly this refresh
                self._cond.notify_all()

    def count(self) -> int:
        with self._cond:
            return len(self._sessions)

    def _acked_locked(self, seq: int, max_age) -> int:
        """Count under the condition: acked cursor at/past ``seq``, and —
        with ``max_age`` (seconds) — an ack frame within that window.
        Redis ``min-replicas-max-lag`` parity: lag is time since the
        last REPLCONF ACK, so a replica that acked the seq long ago and
        then went silent does not count toward a freshness-gated quorum."""
        now = time.monotonic() if max_age is not None else 0.0
        return sum(
            1
            for s in self._sessions.values()
            if s["acked"] >= seq
            and (max_age is None or now - s["acked_at"] <= max_age)
        )

    def count_acked(self, seq: int, *, max_age=None) -> int:
        """Replicas whose acked cursor is at or past ``seq`` (optionally
        only those whose last ack frame is ``max_age``-fresh; ``<= 0``
        disables the gate, Redis ``min-replicas-max-lag 0`` parity)."""
        if max_age is not None and max_age <= 0:
            max_age = None
        with self._cond:
            return self._acked_locked(seq, max_age)

    def wait_acked(
        self,
        seq: int,
        needed: int,
        timeout: float,
        *,
        require_connected: int = 0,
        max_age=None,
    ) -> int:
        """Block until at least ``needed`` replicas have acked ``seq``
        (or ``timeout`` elapses); returns the count actually acked —
        Redis WAIT semantics, the caller decides whether falling short
        is an error. ``needed <= 0`` returns the current count
        immediately. Blocked waiters are the ``wait_blocked_current``
        gauge.

        ``require_connected`` is the commit barrier's mid-wait
        attainability check: once fewer than that many replicas are even
        CONNECTED the quorum cannot complete this round, so return the
        current count immediately instead of sleeping out the timeout
        (``unregister`` wakes waiters exactly for this). The Wait RPC
        passes 0 — a replica may reconnect within its window, and Redis
        WAIT rides out the full timeout.

        ``max_age`` (seconds) additionally requires each counted
        replica's last ack FRAME to be that fresh — the commit barrier
        passes its lag budget here so a replica that acked once and went
        silent cannot keep satisfying durability quorums forever.
        ``max_age <= 0`` means NO freshness gate (Redis
        ``min-replicas-max-lag 0`` semantics: the check is disabled, not
        infinitely strict — and a 0 gate would also busy-spin the
        wait loop below)."""
        _locks.note_blocking("repl.wait_acked")
        if max_age is not None and max_age <= 0:
            max_age = None
        deadline = time.monotonic() + max(0.0, timeout)
        with self._cond:
            count = self._acked_locked(seq, max_age)
            if needed <= 0 or count >= needed:
                return count
            self._waiters += 1
            _counters.set_gauge("wait_blocked_current", self._waiters)
            try:
                while True:
                    count = self._acked_locked(seq, max_age)
                    remaining = deadline - time.monotonic()
                    if (
                        count >= needed
                        or remaining <= 0
                        or len(self._sessions) < require_connected
                    ):
                        return count
                    # with an age gate, a quorum member can go STALE
                    # mid-wait without any notify — cap the sleep so the
                    # loop re-evaluates freshness on its own clock
                    if max_age is not None:
                        remaining = min(remaining, max_age / 2.0)
                    self._cond.wait(remaining)
            finally:
                self._waiters -= 1
                _counters.set_gauge("wait_blocked_current", self._waiters)

    def unregister(self, sid: int) -> None:
        with self._cond:
            self._sessions.pop(sid, None)
            n = len(self._sessions)
            # a vanished replica can no longer ack: re-evaluate quorums
            # now rather than at their timeout
            self._cond.notify_all()
        _counters.set_gauge("repl_connected_replicas", n)
        if not n:
            _counters.set_gauge("repl_max_replica_lag_seq", 0)

    def min_cursor(self) -> int | None:
        """Slowest connected replica's cursor (None when no replicas) —
        log truncation stays behind it so live streams never lose their
        tail mid-flight."""
        with self._cond:
            if not self._sessions:
                return None
            return min(s["cursor"] for s in self._sessions.values())

    def describe(self) -> list:
        with self._cond:
            return [dict(s) for s in self._sessions.values()]


def _batched_frames(records: list, batch_bytes: int):
    """Coalesce records into ``{"kind": "records", "z": <zlib level-1 of
    a msgpack record list>, ...}`` frames of roughly ``batch_bytes`` of
    raw payload each (one oversized record still ships alone). Level 1:
    op records are msgpack maps full of repeated keys and key bytes —
    cheap compression wins most of what's winnable, and the stream stays
    CPU-light."""
    group: list = []
    group_bytes = 0
    for r in records:
        size = len(msgpack.packb(r, use_bin_type=True))
        if group and group_bytes + size > batch_bytes:
            yield _pack_group(group)
            group, group_bytes = [], 0
        group.append(r)
        group_bytes += size
    if group:
        yield _pack_group(group)


def _pack_group(group: list) -> dict:
    raw = msgpack.packb(group, use_bin_type=True)
    z = zlib.compress(raw, 1)
    _counters.incr("repl_stream_batched_frames")
    _counters.incr("repl_stream_batched_bytes_raw", len(raw))
    _counters.incr("repl_stream_batched_bytes_wire", len(z))
    return {
        "kind": "records",
        "z": z,
        "count": len(group),
        "first_seq": group[0]["seq"],
        "last_seq": group[-1]["seq"],
    }


def repl_stream(service, req: dict, context, *, heartbeat_s: float = DEFAULT_HEARTBEAT_S):
    """Generator behind the ``ReplStream`` RPC (dicts; the server layer
    msgpack-encodes each one)."""
    oplog = service.oplog
    if oplog is None:
        yield {
            "kind": "error",
            "code": "UNSUPPORTED",
            "message": "this server has no op log (start it with "
            "--repl-log-dir to serve replicas)",
        }
        return
    sessions: ReplicaSessions = service.repl_sessions
    cursor = req.get("cursor")
    caps = set(req.get("caps") or ())
    batch_bytes = getattr(service, "repl_batch_bytes", None)
    use_batch = bool(batch_bytes) and CAP_BATCH_ZLIB in caps
    sid = sessions.register(
        getattr(context, "peer", lambda: "?")(), listen=req.get("listen")
    )
    try:
        # a cursor is only resumable against the SAME log identity
        # (Redis replid parity): a rewound/recreated log reuses seq
        # numbers, so a stale-id cursor would silently swallow records.
        # Post-failover, the promoted node's ALIAS (replid2 parity)
        # extends "same identity" to the old primary's id up to the
        # promotion point — survivors partial-resync instead of paying
        # a full resync.
        if cursor is None or not oplog.resumable(cursor, req.get("log_id")):
            _counters.incr("repl_full_resyncs")
            names, snaps, plan_seq = service.snapshot_plan()
            yield {
                "kind": "full_sync_begin",
                "filters": names,
                "seq": oplog.last_seq,
                "log_id": oplog.log_id,
            }
            seqs = [plan_seq]
            for name, blob, applied_seq in snaps:
                faults.fire("repl.stream_send")
                yield {
                    "kind": "snapshot",
                    "name": name,
                    "blob": blob,
                    "applied_seq": applied_seq,
                }
                seqs.append(applied_seq)
            # tail from the oldest snapshot point, clamped to the log
            # head AT PLAN TIME: a create committed after the plan froze
            # is not in `names`, so its record must be streamed — while
            # records a snapshot already contains are skipped by the
            # replica's per-filter gate
            cursor = min(seqs)
            yield {
                "kind": "full_sync_end",
                "cursor": cursor,
                "log_id": oplog.log_id,
                "epoch": getattr(service, "epoch", 0),
                # the replica echoes the session id on its ReplAck
                # frames — how acks land on THIS session's acked cursor
                "sid": sid,
            }
        else:
            _counters.incr("repl_partial_resyncs")
            yield {
                "kind": "partial_sync",
                "cursor": cursor,
                "log_id": oplog.log_id,
                "epoch": getattr(service, "epoch", 0),
                "sid": sid,
            }
        sessions.update(sid, cursor, oplog.last_seq)
        follower = oplog.follower(cursor)
        stream_log_id = oplog.log_id
        while context.is_active() and not service.draining:
            if oplog.log_id != stream_log_id:
                # the log identity rotated UNDER this stream (a chained
                # upstream full-resynced and reset its log): the
                # subscriber's cursor belongs to the old identity — end
                # the stream so its reconnect re-handshakes (and pays
                # the full resync the reset implies)
                _counters.incr("repl_stream_cut_identity_rotated")
                return
            batch = follower.next_batch(STREAM_BATCH)
            if use_batch and len(batch) > 1:
                for frame in _batched_frames(batch, batch_bytes):
                    faults.fire("repl.stream_send")
                    yield frame
                _counters.incr("repl_records_streamed", len(batch))
            else:
                for rec in batch:
                    faults.fire("repl.stream_send")
                    yield {"kind": "record", **rec}
                    _counters.incr("repl_records_streamed")
            cursor = follower.cursor
            sessions.update(sid, cursor, oplog.last_seq)
            if not batch and not oplog.wait_for(
                cursor + 1, timeout=heartbeat_s
            ):
                yield {
                    "kind": "heartbeat",
                    "seq": oplog.last_seq,
                    "ts": time.time(),
                    "epoch": getattr(service, "epoch", 0),
                }
    finally:
        sessions.unregister(sid)


def repl_ack(service, request_iterator, context):
    """Behavior behind the client-streaming ``ReplAck`` RPC:
    consume ``{"sid", "seq"}`` frames from one replica for the lifetime
    of its ack stream, folding each into the matching session's acked
    cursor. Returns the single response dict once the stream ends.

    Fault point ``repl.ack_recv`` fires per frame; a firing propagates
    out of the handler — gRPC fails the RPC, the replica notices the
    dead ack stream at its next heartbeat and re-opens it (re-sending
    its current cursor, so no ack is permanently lost)."""
    from tpubloom_torch.server import protocol

    frames = 0
    for raw in request_iterator:
        faults.fire("repl.ack_recv")
        try:
            frame = protocol.decode(raw)
        except Exception:
            _counters.incr("repl_ack_decode_errors")
            continue
        sid, seq = frame.get("sid"), frame.get("seq")
        if sid is None or seq is None:
            continue
        frames += 1
        # counted per FRAME (idle re-acks included) so the pair
        # sent-vs-received stays comparable: a growing gap means real
        # ack loss, not the monotone-advance filter in ack()
        _counters.incr("repl_acks_received")
        service.repl_sessions.ack(int(sid), int(seq))
    return {"ok": True, "frames": frames}
