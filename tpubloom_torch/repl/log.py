"""Append-only op log — the AOF-parity durability + replication backbone.

The reference gem inherits Redis's durability story: every mutating
command lands in the AOF, a restart replays it, and the same byte stream
feeds primary→replica links. This is that machinery for tpubloom:

* **append** — one CRC32C-framed record per committed mutating RPC
  (:mod:`tpubloom_torch.repl.record`), written+flushed under the log lock so a
  concurrent reader never observes a half-record except at a crash-torn
  tail. Default fsync policy is the OS page cache (Redis
  ``appendfsync no`` parity; pass ``fsync=True`` for ``always``).
* **segments** — the log rolls into ``oplog.<first_seq>.seg`` files
  every ``segment_bytes``; checkpoint-keyed truncation
  (:meth:`OpLog.truncate_to`) drops whole segments whose every record is
  already covered by a landed checkpoint generation on every filter —
  the log only ever holds the replay *tail*, like an AOF after rewrite.
* **recovery** — on open, every segment is scanned through the record
  CRCs; a torn tail (crash mid-append) is truncated back to the last
  intact record (``aof-load-truncated yes`` parity) and counted in
  ``repl_log_torn_tail_truncated``. Corruption in a *non*-tail position
  drops everything from that point (a gap must not be replayed past).
* **tailing** — :meth:`wait_for` blocks stream generators until a seq
  exists; appends notify. Readers (:meth:`read_from`) re-open segment
  files read-only, so slow replicas never hold the append lock.

Fault point ``repl.append`` (:mod:`tpubloom_torch.faults`) fires inside the
append lock, before any bytes are written.
"""

from __future__ import annotations

import logging
import os
import re
import threading
import time
from typing import Iterator, Optional

from tpubloom_torch import faults
from tpubloom_torch.obs import counters as _counters
from tpubloom_torch.repl import record as rec
from tpubloom_torch.utils import locks

log = logging.getLogger("tpubloom.repl")

_SEG_RE = re.compile(r"^oplog\.(?P<start>\d{20})\.seg$")

DEFAULT_SEGMENT_BYTES = 4 << 20


class OpLog:
    """Segmented append-only log of mutating ops; thread-safe."""

    def __init__(
        self,
        directory: str,
        *,
        segment_bytes: int = DEFAULT_SEGMENT_BYTES,
        fsync: bool = False,
        start_seq: int = 0,
    ):
        """``start_seq`` seeds an EMPTY log's sequence space (promotion:
        a replica adopting the op log opens a fresh log at its applied
        seq so downstream cursors stay meaningful); ignored when the
        directory already holds records."""
        self.directory = directory
        self.segment_bytes = segment_bytes
        self.fsync = fsync
        os.makedirs(directory, exist_ok=True)
        self._cond = locks.named_condition("repl.oplog")
        self._fh = None
        self._size = 0
        self._bytes = 0
        self._closed = False
        #: [(start_seq, path)] oldest→newest; the last one is active
        self._segments: list[tuple[int, str]] = []
        self.last_seq = 0
        rewound = self._recover()
        if not self._segments and start_seq > self.last_seq:
            self.last_seq = start_seq
        self._bytes = sum(
            os.path.getsize(p) for _, p in self._segments if os.path.exists(p)
        )
        #: replication identity (Redis replid parity): replicas pin their
        #: cursor to this id, and a mismatch forces a full resync. The id
        #: persists across clean restarts but ROTATES whenever recovery
        #: had to truncate/drop records — the seq space rewound, so an
        #: old cursor would silently swallow new records.
        self.log_id = self._load_log_id(rotate=rewound)
        #: PSYNC2-parity secondary identity (Redis replid2): after a
        #: promotion, cursors pinned to the PREVIOUS primary's log id are
        #: still resumable up to ``alias_upto`` — the promoted node's log
        #: holds the same records in the same seq space up to that point.
        self.alias_id: Optional[str] = None
        self.alias_upto = 0
        if rewound:
            self._drop_alias()
        else:
            self._load_alias()
        self._update_gauges()

    def _load_log_id(self, rotate: bool) -> str:
        import secrets

        path = os.path.join(self.directory, "oplog.id")
        if not rotate:
            try:
                with open(path) as f:
                    existing = f.read().strip()
                if existing:
                    return existing
            except OSError:
                pass
        new_id = secrets.token_hex(16)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(new_id)
        os.replace(tmp, path)
        return new_id

    # -- identity alias (failover continuity, Redis replid2 parity) ----------

    def _alias_path(self) -> str:
        return os.path.join(self.directory, "oplog.alias.json")

    def _load_alias(self) -> None:
        import json

        try:
            with open(self._alias_path()) as f:
                data = json.load(f)
            self.alias_id = data["log_id"] or None
            self.alias_upto = int(data["upto"])
        except (OSError, ValueError, KeyError, TypeError):
            self.alias_id, self.alias_upto = None, 0

    def _drop_alias(self) -> None:
        self.alias_id, self.alias_upto = None, 0
        try:
            os.unlink(self._alias_path())
        except OSError:
            pass

    def set_alias(self, log_id: Optional[str], upto: int) -> None:
        """Remember that this log's records up to ``upto`` are identical
        to log identity ``log_id`` (the upstream a promoted replica was
        following) — cursors pinned to that id partial-resync instead of
        paying a full resync after failover."""
        import json

        if not log_id:
            return
        self.alias_id, self.alias_upto = log_id, int(upto)
        tmp = self._alias_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"log_id": log_id, "upto": int(upto)}, f)
        os.replace(tmp, self._alias_path())

    def resumable(self, cursor: int, log_id: Optional[str]) -> bool:
        """True iff a replica at ``(cursor, log_id)`` can partial-resync
        from this log: the identity matches (directly, or through the
        post-promotion alias within its validity window) AND every record
        past the cursor is still on disk."""
        with self._cond:
            if log_id == self.log_id:
                pass
            elif (
                self.alias_id is not None
                and log_id == self.alias_id
                and cursor <= self.alias_upto
            ):
                pass
            else:
                return False
        return self.has_cursor(cursor)

    # -- recovery ------------------------------------------------------------

    def _seg_path(self, start_seq: int) -> str:
        return os.path.join(self.directory, f"oplog.{start_seq:020d}.seg")

    def _recover(self) -> bool:
        """Scan + repair all segments; True iff any records were lost
        (torn tail truncated / corrupt tail dropped) — i.e. the seq
        space rewound and the log identity must rotate."""
        rewound = False
        found = sorted(
            (int(m.group("start")), os.path.join(self.directory, fn))
            for fn in os.listdir(self.directory)
            if (m := _SEG_RE.match(fn))
        )
        for i, (start, path) in enumerate(found):
            with open(path, "rb") as f:
                buf = f.read()
            records, valid_len, clean = rec.scan_buffer(buf)
            if not clean:
                rewound = True
                if i == len(found) - 1:
                    # crash-torn tail of the newest segment: drop the
                    # partial record, keep everything before it
                    log.warning(
                        "op log %s: torn tail, truncating %d -> %d bytes",
                        path, len(buf), valid_len,
                    )
                    _counters.incr("repl_log_torn_tail_truncated")
                    with open(path, "r+b") as f:
                        f.truncate(valid_len)
                else:
                    # mid-log corruption: records past the gap cannot be
                    # replayed safely — drop this tail and every later
                    # segment (bounded loss, never a silent gap)
                    log.error(
                        "op log %s: corrupt mid-log at byte %d; dropping "
                        "the tail and %d later segment(s)",
                        path, valid_len, len(found) - i - 1,
                    )
                    _counters.incr("repl_log_corrupt_dropped")
                    with open(path, "r+b") as f:
                        f.truncate(valid_len)
                    for _, later in found[i + 1 :]:
                        os.unlink(later)
                    found = found[: i + 1]
            self._segments.append((start, path))
            if records:
                self.last_seq = records[-1]["seq"]
            else:
                self.last_seq = max(self.last_seq, start - 1)
            if not clean:
                break
        if self._segments:
            active = self._segments[-1][1]
            self._size = os.path.getsize(active)
            self._fh = open(active, "ab")
        return rewound

    # -- write side ----------------------------------------------------------

    def append(self, method: str, req: dict, rid: Optional[str] = None) -> int:
        """Commit one op to the log; returns its seq. Raises if the log
        is closed or an armed ``repl.append`` fault fires."""
        with self._cond:
            if self._closed:
                raise RuntimeError("op log is closed")
            faults.fire("repl.append")
            seq = self.last_seq + 1
            frame = rec.encode_record(
                {
                    "seq": seq,
                    "method": method,
                    "rid": rid,
                    "req": req,
                    "ts": time.time(),
                }
            )
            if self._fh is None or self._size >= self.segment_bytes:
                self._roll(seq)
            self._fh.write(frame)
            self._fh.flush()  # lint: allow(blocking-under-lock): append IO under the log lock IS the commit protocol — readers may only ever observe whole records
            if self.fsync:
                os.fsync(self._fh.fileno())  # lint: allow(blocking-under-lock): appendfsync-always parity — durability before visibility is the point of the flag
            self._size += len(frame)
            self._bytes += len(frame)
            self.last_seq = seq
            self._cond.notify_all()
            self._update_gauges_locked()
        return seq

    def append_record(self, record: dict) -> bool:
        """Re-append one already-sequenced record VERBATIM (chained
        replicas: the upstream's seq space IS this log's seq space, which
        is what makes promoting a mid-chain node cheap). Returns False
        when the record is already in the log (partial-resync overlap);
        raises on a sequence gap — the caller must full-resync, a gap
        must never be papered over."""
        with self._cond:
            if self._closed:
                raise RuntimeError("op log is closed")
            seq = int(record["seq"])
            if seq <= self.last_seq:
                return False
            if seq != self.last_seq + 1:
                raise ValueError(
                    f"op log gap: re-append of seq {seq} onto last_seq "
                    f"{self.last_seq}"
                )
            frame = rec.encode_record(record)
            if self._fh is None or self._size >= self.segment_bytes:
                self._roll(seq)
            self._fh.write(frame)
            self._fh.flush()  # lint: allow(blocking-under-lock): append IO under the log lock IS the commit protocol — readers may only ever observe whole records
            if self.fsync:
                os.fsync(self._fh.fileno())  # lint: allow(blocking-under-lock): appendfsync-always parity — durability before visibility is the point of the flag
            self._size += len(frame)
            self._bytes += len(frame)
            self.last_seq = seq
            self._cond.notify_all()
            self._update_gauges_locked()
        return True

    def reset_to(self, seq: int) -> None:
        """Full-resync state reset: drop EVERY record, restart the seq
        space at ``seq``, and rotate the identity (this log's history is
        no longer a prefix of anything a downstream cursor could have
        followed)."""
        import secrets

        with self._cond:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            for _, path in self._segments:
                try:
                    os.unlink(path)
                except OSError:
                    pass
            self._segments = []
            self._size = 0
            self._bytes = 0
            self.last_seq = int(seq)
            self.log_id = secrets.token_hex(16)
            tmp = os.path.join(self.directory, "oplog.id.tmp")
            with open(tmp, "w") as f:
                f.write(self.log_id)
            os.replace(tmp, os.path.join(self.directory, "oplog.id"))
            self._drop_alias()
            self._cond.notify_all()
            self._update_gauges_locked()

    def _roll(self, start_seq: int) -> None:
        """Start a new segment whose first record will be ``start_seq``
        (caller holds the lock)."""
        if self._fh is not None:
            self._fh.close()
        path = self._seg_path(start_seq)
        self._fh = open(path, "ab")
        self._size = 0
        self._segments.append((start_seq, path))

    # -- read side -----------------------------------------------------------

    @property
    def first_seq(self) -> int:
        """Oldest seq still available (== next seq when the log is
        empty/fully truncated). A cursor C supports a partial resync iff
        ``C + 1 >= first_seq``."""
        with self._cond:
            if self._segments:
                return self._segments[0][0]
            return self.last_seq + 1

    def has_cursor(self, cursor: int) -> bool:
        """True iff every record after ``cursor`` is still in the log."""
        return cursor + 1 >= self.first_seq

    def read_from(
        self, cursor: int, limit: Optional[int] = None
    ) -> Iterator[dict]:
        """Yield records with ``seq > cursor`` in order (up to ``limit``).

        Reads from snapshot state via fresh read-only handles; appends
        running concurrently are either seen whole (append flushes under
        the lock) or not at all — a racing partial tail just ends the
        scan early and the next poll picks it up."""
        with self._cond:
            segments = list(self._segments)
        yielded = 0
        for i, (start, path) in enumerate(segments):
            nxt = segments[i + 1][0] if i + 1 < len(segments) else None
            if nxt is not None and nxt <= cursor + 1:
                continue  # every record in this segment is <= cursor
            try:
                with open(path, "rb") as f:
                    buf = f.read()
            except FileNotFoundError:
                continue  # truncated underneath us — records were <= safe seq
            records, _, _ = rec.scan_buffer(buf)
            for r in records:
                if r["seq"] <= cursor:
                    continue
                yield r
                yielded += 1
                if limit is not None and yielded >= limit:
                    return

    def wait_for(self, seq: int, timeout: Optional[float] = None) -> bool:
        """Block until ``last_seq >= seq`` (or the log closes); True iff
        the seq exists."""
        with self._cond:
            self._cond.wait_for(
                lambda: self.last_seq >= seq or self._closed, timeout
            )
            return self.last_seq >= seq

    # -- retention -----------------------------------------------------------

    def truncate_to(self, seq: int) -> int:
        """Drop whole segments whose every record has ``seq <=`` the given
        safe point (never the active segment); returns segments removed.

        The safe point is checkpoint-keyed by the caller: the min, over
        all filters, of the op seq the newest *landed* checkpoint
        generation covers — records at or below it are replayable from
        checkpoints alone."""
        removed = 0
        with self._cond:
            while len(self._segments) >= 2 and self._segments[1][0] <= seq + 1:
                _, path = self._segments.pop(0)
                try:
                    self._bytes -= os.path.getsize(path)
                    os.unlink(path)
                except OSError:
                    pass
                removed += 1
            if removed:
                self._bytes = max(0, self._bytes)
                self._update_gauges_locked()
        return removed

    # -- observability / lifecycle -------------------------------------------

    def total_bytes(self) -> int:
        """Incrementally-tracked log size (no per-call disk stats)."""
        with self._cond:
            return self._bytes

    def stats(self) -> dict:
        with self._cond:
            return {
                "first_seq": (
                    self._segments[0][0] if self._segments else self.last_seq + 1
                ),
                "last_seq": self.last_seq,
                "segments": len(self._segments),
                "bytes": self._bytes,
                "log_id": self.log_id,
            }

    def _update_gauges(self) -> None:
        with self._cond:
            self._update_gauges_locked()

    def _update_gauges_locked(self) -> None:
        _counters.set_gauge("repl_log_seq", self.last_seq)
        _counters.set_gauge("repl_log_bytes", self._bytes)
        _counters.set_gauge("repl_log_segments", len(self._segments))

    def follower(self, cursor: int) -> "LogFollower":
        """Incremental tail reader starting after ``cursor`` (what the
        stream generators use — polling costs O(new bytes), not
        O(segment))."""
        return LogFollower(self, cursor)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            self._cond.notify_all()


class LogFollower:
    """Stateful reader over a live :class:`OpLog`: remembers its byte
    position (segment start seq + validated-record-boundary offset) so
    each poll reads only bytes appended since the last one. A partially
    flushed tail frame ends the scan at the last intact record and is
    re-read complete on the next poll; a segment truncated away under
    the follower degrades to :meth:`OpLog.read_from` (which skips to the
    surviving segments)."""

    def __init__(self, oplog: OpLog, cursor: int):
        self.oplog = oplog
        self.cursor = cursor
        self._seg_start: Optional[int] = None
        self._offset = 0

    def next_batch(self, limit: int = 256) -> list:
        """Records with ``seq > cursor``, up to ``limit``; advances the
        cursor past everything returned."""
        out: list = []
        while len(out) < limit:
            with self.oplog._cond:
                segments = list(self.oplog._segments)
            if not segments:
                break
            starts = [s for s, _ in segments]
            if self._seg_start is None or self._seg_start not in starts:
                # (re)position: one full scan via the skip logic, then
                # pin to the START of the segment holding the cursor —
                # the next incremental pass re-scans that one segment
                # (seq-filtered, so nothing duplicates) and lands on the
                # true byte boundary
                import bisect

                resync = list(self.oplog.read_from(self.cursor, limit=limit))
                for r in resync:
                    self.cursor = r["seq"]
                out.extend(resync)
                idx = bisect.bisect_right(starts, self.cursor + 1) - 1
                if idx >= 0:
                    self._seg_start = starts[idx]
                    self._offset = 0
                break
            idx = starts.index(self._seg_start)
            path = segments[idx][1]
            try:
                with open(path, "rb") as f:
                    f.seek(self._offset)
                    buf = f.read()
            except OSError:
                self._seg_start = None
                continue
            records, valid_len, _ = rec.scan_buffer(buf)
            self._offset += valid_len
            fresh = [r for r in records if r["seq"] > self.cursor]
            for r in fresh:
                self.cursor = r["seq"]
            out.extend(fresh)
            if records or idx == len(segments) - 1:
                break
            # this segment is exhausted AND a newer one exists: the log
            # rolled — move to the next segment from its start
            self._seg_start = starts[idx + 1]
            self._offset = 0
        return out[:limit]
