"""Crash-forensics black box — mmap'd flight/trace rings
that survive SIGKILL, plus the fleet post-mortem CLI.

The flight recorder and trace ring die with the process: only the
dump-on-signal path (SIGTERM, fatal, DEGRADED flip) persists anything,
and the failures the chaos suite cares about most — SIGKILL
mid-migration, mid-eviction, mid-quorum — are exactly the ones that
never run a signal handler. This module is the durable layer: two
small file-backed rings in the node's state dir, written through an
``mmap`` so the KERNEL owns the dirty pages. A SIGKILL (or any process
death) loses nothing the slice assignment completed; only a machine
crash can lose unsynced pages, and the drain/fatal paths ``msync`` for
that case too.

Layout (one file per ring, fixed size, created once and reattached on
restart — the spec the README runbook documents):

* **header, 64 bytes**: ``MAGIC(8)=b"TPBBOX1\\n" | version u32le |
  slot_size u32le | nslots u32le | zeros``. Geometry is read back on
  reattach — the FILE's geometry wins over the caller's, so a restart
  with different defaults never misparses old slots.
* **slots**: ``nslots`` fixed slots of ``slot_size`` bytes; slot ``i``
  starts at ``64 + i * slot_size``. Record ``seq`` lives in slot
  ``seq % nslots`` — the ring overwrites oldest-first with no shared
  head pointer to corrupt.
* **frame** (op-log framing discipline, :mod:`tpubloom_torch.repl.record`):
  ``FMAGIC(4)=b"TBBR" | seq u64le | body_len u32le | crc32c u32le |
  msgpack body``. The CRC covers ``seq || body_len || body`` — every
  byte of the frame is checksummed, so a record torn by a kill mid-copy
  (or a flipped byte anywhere in it) is *whole or skipped*, never
  misread. ``body`` is a msgpack map ``{"k": "meta"|"ev"|"span", "ts",
  "ep", ...}`` — ``ep`` is the writer's topology epoch at write time,
  which is what lets the CLI merge rings from different nodes into one
  epoch-then-wall-clock fleet timeline.

Writes are **lock-free**, by construction rather than by luck — the
:func:`tpubloom_torch.obs.flight.note` path this rides is called under
``filter.op`` / ``service.promote`` / ``client.breaker`` /
``sentinel.state`` locks and is documented lock-free, and the runtime
lock-order analyzer would flag any new lock here:

* slot reservation is ``next(itertools.count())`` (GIL-atomic in
  CPython — the same trick the flight dump sequencer uses), so two
  threads never frame into the same slot;
* the write itself is ONE mmap slice assignment (a single bytecode, a
  C-level memcpy) — atomic against in-process readers, and torn-at-
  any-byte against a kill, which the CRC framing absorbs.

The reader side never needs the writer alive: :func:`read_ring` /
:func:`read_node` parse a plain ``bytes`` copy of the file, skip torn
slots, and order records by their embedded ``seq``. On top sits the
post-mortem CLI::

    python -m tpubloom_torch.obs.blackbox <state-dir>... [--json] [--rid R]

which decodes every given node's rings (dead or live), correlates
flight events with trace spans AND op-log seqs by rid, and renders one
fleet timeline ordered by topology epoch + wall clock.
"""

from __future__ import annotations

import argparse
import itertools
import json
import logging
import mmap
import os
import shutil
import sys
import time
from typing import Optional

import msgpack

from tpubloom_torch.obs import counters as obs_counters
from tpubloom_torch.utils.crc32c import crc32c

log = logging.getLogger("tpubloom.obs")

MAGIC = b"TPBBOX1\n"
VERSION = 1
HEADER_LEN = 64
FMAGIC = b"TBBR"
FRAME_HEADER = len(FMAGIC) + 8 + 4 + 4  # magic | seq | body_len | crc

#: ring file names inside ``<state-dir>/blackbox/``
SUBDIR = "blackbox"
FLIGHT_RING = "flight.ring"
TRACE_RING = "trace.ring"

#: defaults sized so both rings together stay under ~1.3 MiB per node:
#: flight events are rare and small, spans carry attrs and links
DEFAULT_FLIGHT_SLOTS = 1024
DEFAULT_FLIGHT_SLOT_SIZE = 256
DEFAULT_TRACE_SLOTS = 2048
DEFAULT_TRACE_SLOT_SIZE = 512


def _frame(seq: int, body: bytes) -> bytes:
    head = seq.to_bytes(8, "little") + len(body).to_bytes(4, "little")
    return (
        FMAGIC + head + crc32c(head + body).to_bytes(4, "little") + body
    )


class MappedRing:
    """One mmap'd slot ring. Create with :meth:`open` (never raises into
    the caller's write path — a broken disk disables the ring, it does
    not crash a drain or a promote)."""

    def __init__(self, path: str, slot_size: int, nslots: int):
        self.path = path
        size = HEADER_LEN + slot_size * nslots
        exists = os.path.exists(path) and os.path.getsize(path) >= HEADER_LEN
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            if exists:
                header = os.pread(fd, HEADER_LEN, 0)
                if (
                    header[:8] == MAGIC
                    and int.from_bytes(header[8:12], "little") == VERSION
                ):
                    # reattach: the FILE's geometry wins — old slots
                    # must keep parsing under the sizes they were
                    # written with
                    slot_size = int.from_bytes(header[12:16], "little")
                    nslots = int.from_bytes(header[16:20], "little")
                    size = HEADER_LEN + slot_size * nslots
                else:
                    exists = False  # foreign/corrupt header: recreate
            if not exists:
                header = (
                    MAGIC
                    + VERSION.to_bytes(4, "little")
                    + slot_size.to_bytes(4, "little")
                    + nslots.to_bytes(4, "little")
                )
                os.pwrite(fd, header.ljust(HEADER_LEN, b"\0"), 0)
            if os.path.getsize(path) != size:
                os.ftruncate(fd, size)
            self.slot_size = slot_size
            self.nslots = nslots
            self._mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        # resume the seq space past whatever survived in the file, so a
        # restarted node appends AFTER its pre-crash history instead of
        # overwriting it from slot 0
        decoded = decode_ring(bytes(self._mm))
        last = decoded["records"][-1]["seq"] if decoded["records"] else -1
        self._seq = itertools.count(last + 1)

    def append(self, body: bytes) -> bool:
        """Frame ``body`` into the next slot; False iff it cannot fit.
        Lock-free: atomic seq reservation + one slice assignment."""
        if FRAME_HEADER + len(body) > self.slot_size:
            return False
        seq = next(self._seq)
        frame = _frame(seq, body)
        off = HEADER_LEN + (seq % self.nslots) * self.slot_size
        self._mm[off : off + len(frame)] = frame
        return True

    def sync(self) -> None:
        """msync for the machine-crash case (SIGKILL needs nothing —
        the kernel owns the dirty pages already)."""
        try:
            self._mm.flush()
        except (OSError, ValueError):
            pass

    def close(self) -> None:
        try:
            self._mm.flush()
            self._mm.close()
        except (OSError, ValueError):
            pass


# -- writer state (module-level, like flight/trace) ---------------------------

_flight_ring: Optional[MappedRing] = None
_trace_ring: Optional[MappedRing] = None
_dir: Optional[str] = None
#: topology epoch stamped into every record at write time — the fleet
#: merge's primary sort key (service.adopt_epoch / sentinel adoption
#: keep it current)
_epoch: int = 0
_node: dict = {}


def configure(
    state_dir: str,
    *,
    node: Optional[dict] = None,
    flight_slots: int = DEFAULT_FLIGHT_SLOTS,
    flight_slot_size: int = DEFAULT_FLIGHT_SLOT_SIZE,
    trace_slots: int = DEFAULT_TRACE_SLOTS,
    trace_slot_size: int = DEFAULT_TRACE_SLOT_SIZE,
) -> bool:
    """Arm the black box under ``<state_dir>/blackbox/``. Best-effort:
    returns False (and stays disabled) on any IO error — forensics must
    never stop a server from booting."""
    global _flight_ring, _trace_ring, _dir
    directory = os.path.join(state_dir, SUBDIR)
    try:
        os.makedirs(directory, exist_ok=True)
        _flight_ring = MappedRing(
            os.path.join(directory, FLIGHT_RING),
            flight_slot_size, flight_slots,
        )
        _trace_ring = MappedRing(
            os.path.join(directory, TRACE_RING),
            trace_slot_size, trace_slots,
        )
    except OSError:
        log.exception("black box disabled: cannot map rings in %s", directory)
        _flight_ring = _trace_ring = None
        return False
    _dir = directory
    if node:
        _node.update(node)
    set_node_meta(pid=os.getpid())
    return True


def enabled() -> bool:
    return _flight_ring is not None


def directory() -> Optional[str]:
    return _dir


def set_node_meta(**meta) -> None:
    """Update the node identity (``role``/``epoch``/``addr``/...) and,
    when armed, persist a ``meta`` record so a post-mortem knows who
    this ring belonged to and which epochs it lived through."""
    global _epoch
    ep = meta.get("epoch")
    if ep is not None:
        _epoch = max(_epoch, int(ep))
    _node.update({k: v for k, v in meta.items() if v is not None})
    ring = _flight_ring
    if ring is None:
        return
    _write(ring, {"k": "meta", "ts": time.time(), "ep": _epoch, **_node})


def _write(ring: MappedRing, body: dict) -> None:
    """Pack + append, degrading oversized records instead of losing
    them silently: attrs/links are dropped first, and a record that
    still cannot fit counts as dropped."""
    try:
        packed = msgpack.packb(body, use_bin_type=True, default=str)
        if not ring.append(packed):
            slim = {
                k: v for k, v in body.items() if k not in ("attrs", "links")
            }
            slim["truncated"] = True
            if not ring.append(
                msgpack.packb(slim, use_bin_type=True, default=str)
            ):
                obs_counters.incr("blackbox_records_dropped")
                return
    except (ValueError, OSError, TypeError):
        obs_counters.incr("blackbox_records_dropped")
        return
    obs_counters.incr("blackbox_records_written")


def note_event(ev: dict) -> None:
    """Write-through for :func:`tpubloom_torch.obs.flight.note` — one truthy
    check when disarmed, a lock-free mapped append when armed."""
    ring = _flight_ring
    if ring is None:
        return
    _write(ring, {"k": "ev", "ep": _epoch, **ev})


def spill_span(span: dict) -> None:
    """Persist one forced/slowlog-worthy span (the spans explaining a
    crash must survive the crash) into the companion trace ring."""
    ring = _trace_ring
    if ring is None:
        return
    _write(ring, {"k": "span", "ts": span.get("start"), "ep": _epoch, **span})


def sync() -> None:
    for ring in (_flight_ring, _trace_ring):
        if ring is not None:
            ring.sync()


#: snapshot directory prefix under ``blackbox/`` — the post-mortem CLI
#: and pruning both key on it
SNAP_PREFIX = "snap-"


def snapshot_rings(reason: str, max_snapshots: int = 8) -> Optional[str]:
    """Freeze both rings into ``blackbox/snap-<ts>-<reason>/``.
    The rings are oldest-first OVERWRITE buffers — by the
    time someone reads a DEGRADED incident, minutes of healthy traffic
    may have lapped the records that explain it. Health's
    SERVING→DEGRADED flip calls this so the lead-up survives. Bounded:
    the oldest snapshots beyond ``max_snapshots`` are pruned (a
    flapping health check must not fill the disk). Best-effort like
    every writer here — returns the snapshot dir, or None (disarmed or
    IO error), and never raises."""
    directory = _dir
    if directory is None:
        return None
    sync()  # the copies must include everything written so far
    tag = "".join(
        c if c.isalnum() or c in "-_" else "-" for c in reason
    ) or "unknown"
    snap = os.path.join(
        directory, f"{SNAP_PREFIX}{int(time.time() * 1000):013d}-{tag}"
    )
    try:
        os.makedirs(snap, exist_ok=True)
        for fname in (FLIGHT_RING, TRACE_RING):
            src = os.path.join(directory, fname)
            if os.path.exists(src):
                shutil.copyfile(src, os.path.join(snap, fname))
    except OSError:
        log.exception("black box: ring snapshot failed in %s", directory)
        return None
    try:
        snaps = sorted(
            d for d in os.listdir(directory)
            if d.startswith(SNAP_PREFIX)
            and os.path.isdir(os.path.join(directory, d))
        )
        for stale in snaps[:-max_snapshots] if max_snapshots > 0 else snaps:
            shutil.rmtree(os.path.join(directory, stale), ignore_errors=True)
    except OSError:
        pass  # pruning is advisory; the snapshot itself landed
    return snap


def reset_for_tests() -> None:
    global _flight_ring, _trace_ring, _dir, _epoch
    for ring in (_flight_ring, _trace_ring):
        if ring is not None:
            ring.close()
    _flight_ring = _trace_ring = None
    _dir = None
    _epoch = 0
    _node.clear()


# -- decoding (works on dead processes: plain bytes, no mmap) -----------------


def decode_ring(buf: bytes) -> dict:
    """Parse one ring image: ``{"geometry", "records", "skipped"}``.
    ``records`` are seq-ordered bodies (each with its ``seq`` folded
    in); a slot whose frame is torn — short, bad magic, bad length, CRC
    mismatch, unparseable body — is *skipped*, exactly one record lost,
    never a misread."""
    if len(buf) < HEADER_LEN or buf[:8] != MAGIC:
        return {"geometry": None, "records": [], "skipped": 0}
    version = int.from_bytes(buf[8:12], "little")
    slot_size = int.from_bytes(buf[12:16], "little")
    nslots = int.from_bytes(buf[16:20], "little")
    geometry = {
        "version": version, "slot_size": slot_size, "nslots": nslots,
    }
    if version != VERSION or slot_size <= FRAME_HEADER or nslots <= 0:
        return {"geometry": geometry, "records": [], "skipped": 0}
    records, skipped = [], 0
    for i in range(nslots):
        off = HEADER_LEN + i * slot_size
        slot = buf[off : off + slot_size]
        if len(slot) < FRAME_HEADER:
            if slot.strip(b"\0"):
                skipped += 1  # truncated mid-slot: a torn tail
            continue
        if slot[:4] != FMAGIC:
            if slot.strip(b"\0"):
                skipped += 1
            continue
        seq = int.from_bytes(slot[4:12], "little")
        body_len = int.from_bytes(slot[12:16], "little")
        crc = int.from_bytes(slot[16:20], "little")
        body = slot[FRAME_HEADER : FRAME_HEADER + body_len]
        if (
            len(body) != body_len
            or crc32c(slot[4:16] + body) != crc
        ):
            skipped += 1
            continue
        try:
            rec = msgpack.unpackb(body, raw=False)
        except Exception:  # torn in a way the CRC cannot see (never
            skipped += 1  # observed; belt and braces for a post-mortem)
            continue
        if not isinstance(rec, dict):
            skipped += 1
            continue
        rec["seq"] = seq
        records.append(rec)
    records.sort(key=lambda r: r["seq"])
    return {"geometry": geometry, "records": records, "skipped": skipped}


def read_ring(path: str) -> dict:
    """Decode one ring file from disk (tolerates short/truncated
    files — missing slots read as torn)."""
    try:
        with open(path, "rb") as f:
            return decode_ring(f.read())
    except OSError:
        return {"geometry": None, "records": [], "skipped": 0}


def _blackbox_dir_of(path: str) -> Optional[str]:
    """Accept a state dir, the blackbox dir itself, or a ring file."""
    if os.path.isfile(path):
        return os.path.dirname(path) or "."
    if os.path.isdir(os.path.join(path, SUBDIR)):
        return os.path.join(path, SUBDIR)
    if os.path.isdir(path) and (
        os.path.exists(os.path.join(path, FLIGHT_RING))
        or os.path.exists(os.path.join(path, TRACE_RING))
    ):
        return path
    return None


def read_node(path: str) -> Optional[dict]:
    """Decode one node's black box: ``{"dir", "label", "meta",
    "events", "spans", "skipped"}``. ``meta`` is the newest meta
    record; ``label`` prefers the node's announced address."""
    directory = _blackbox_dir_of(path)
    if directory is None:
        return None
    flight = read_ring(os.path.join(directory, FLIGHT_RING))
    trace = read_ring(os.path.join(directory, TRACE_RING))
    meta: dict = {}
    events = []
    for rec in flight["records"]:
        if rec.get("k") == "meta":
            meta = {
                k: v for k, v in rec.items() if k not in ("k", "seq")
            }
        elif rec.get("k") == "ev":
            events.append(rec)
    spans = [r for r in trace["records"] if r.get("k") == "span"]
    state_dir = os.path.dirname(os.path.abspath(directory))
    label = meta.get("addr") or os.path.basename(state_dir)
    return {
        "dir": directory,
        "state_dir": state_dir,
        "label": str(label),
        "meta": meta,
        "events": events,
        "spans": spans,
        "skipped": flight["skipped"] + trace["skipped"],
    }


def scan_oplog(state_dir: str, rids: set) -> list:
    """Correlate by rid against the node's op log: scan every
    ``oplog.*.seg`` beside the blackbox dir with the op-log framing and
    keep the records whose rid the rings mentioned — the post-mortem's
    bridge from 'the span says it committed' to 'seq N in the log'."""
    from tpubloom_torch.repl import record as repl_record

    out = []
    if not rids:
        return out
    try:
        names = sorted(
            fn for fn in os.listdir(state_dir)
            if fn.startswith("oplog.") and fn.endswith(".seg")
        )
    except OSError:
        return out
    for fn in names:
        try:
            with open(os.path.join(state_dir, fn), "rb") as f:
                buf = f.read()
        except OSError:
            continue
        records, _valid, _clean = repl_record.scan_buffer(buf)
        for rec in records:
            if rec.get("rid") in rids:
                out.append(
                    {
                        "seq": rec.get("seq"),
                        "method": rec.get("method"),
                        "rid": rec.get("rid"),
                        "ts": rec.get("ts"),
                        "filter": (rec.get("req") or {}).get("name"),
                    }
                )
    return out


def merge_timeline(
    nodes: list, *, rid: Optional[str] = None, with_oplog: bool = True
) -> list:
    """Merge decoded nodes into one fleet timeline: entries ``{"ts",
    "ep", "node", "type", ...}`` ordered by (topology epoch, wall
    clock) — epoch first because wall clocks across a fleet skew, and
    an epoch boundary is the one ordering every node agrees on."""
    entries = []
    rids: set = set()
    for node in nodes:
        for ev in node["events"]:
            attrs = ev.get("attrs") or {}
            if attrs.get("rid"):
                rids.add(attrs["rid"])
            entries.append(
                {
                    "ts": float(ev.get("ts") or 0.0),
                    "ep": int(ev.get("ep") or 0),
                    "node": node["label"],
                    "type": "event",
                    "kind": ev.get("kind"),
                    "attrs": attrs,
                    "seq": ev.get("seq"),
                }
            )
        for s in node["spans"]:
            if s.get("rid"):
                rids.add(s["rid"])
            entries.append(
                {
                    "ts": float(s.get("start") or s.get("ts") or 0.0),
                    "ep": int(s.get("ep") or 0),
                    "node": node["label"],
                    "type": "span",
                    "name": s.get("name"),
                    "rid": s.get("rid"),
                    "span": s.get("span"),
                    "parent": s.get("parent"),
                    "duration_s": s.get("duration_s"),
                    "attrs": s.get("attrs") or {},
                    "seq": s.get("seq"),
                }
            )
    if with_oplog:
        for node in nodes:
            want = {rid} if rid else rids
            for rec in scan_oplog(node["state_dir"], want):
                entries.append(
                    {
                        "ts": float(rec.get("ts") or 0.0),
                        "ep": 0,
                        "node": node["label"],
                        "type": "oplog",
                        "rid": rec.get("rid"),
                        "oplog_seq": rec.get("seq"),
                        "method": rec.get("method"),
                        "filter": rec.get("filter"),
                    }
                )
    if rid:
        entries = [
            e for e in entries
            if e.get("rid") == rid or (e.get("attrs") or {}).get("rid") == rid
            or e["type"] == "event"  # lifecycle context stays visible
        ]
    entries.sort(key=lambda e: (e["ep"], e["ts"], e.get("seq") or 0))
    return entries


def _fmt_ts(ts: float) -> str:
    if not ts:
        return "?" * 15
    lt = time.localtime(ts)
    return time.strftime("%H:%M:%S", lt) + f".{int((ts % 1) * 1e6):06d}"


def _render(nodes: list, timeline: list) -> str:
    lines = []
    for node in nodes:
        meta = node["meta"]
        lines.append(
            f"node {node['label']}  dir={node['state_dir']}  "
            f"pid={meta.get('pid', '?')}  role={meta.get('role', '?')}  "
            f"ep={meta.get('ep', 0)}  events={len(node['events'])}  "
            f"spans={len(node['spans'])}  torn={node['skipped']}"
        )
    lines.append("-" * 72)
    for e in timeline:
        head = f"{_fmt_ts(e['ts'])} ep={e['ep']:<3d} [{e['node']}]"
        if e["type"] == "event":
            attrs = " ".join(
                f"{k}={v}" for k, v in sorted((e["attrs"] or {}).items())
            )
            lines.append(f"{head} EVENT {e['kind']} {attrs}".rstrip())
        elif e["type"] == "span":
            dur = (e.get("duration_s") or 0.0) * 1e3
            attrs = " ".join(
                f"{k}={v}" for k, v in sorted((e["attrs"] or {}).items())
            )
            lines.append(
                f"{head} SPAN  {e['name']} rid={e.get('rid')} "
                f"{dur:.1f}ms {attrs}".rstrip()
            )
        else:
            lines.append(
                f"{head} OPLOG seq={e.get('oplog_seq')} {e.get('method')} "
                f"rid={e.get('rid')} filter={e.get('filter')}"
            )
    return "\n".join(lines)


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tpubloom_torch.obs.blackbox",
        description="decode crash-forensics rings from any number of "
        "(dead or live) tpubloom state dirs and merge them into one "
        "fleet timeline ordered by topology epoch + wall clock",
    )
    parser.add_argument(
        "paths", nargs="+", metavar="STATE-DIR",
        help="state dirs (op-log/checkpoint dirs), blackbox/ dirs, or "
        "ring files",
    )
    parser.add_argument(
        "--json", action="store_true", dest="as_json",
        help="machine-readable output instead of the human timeline",
    )
    parser.add_argument(
        "--rid", default=None,
        help="focus the timeline on one request id (lifecycle events "
        "stay for context)",
    )
    parser.add_argument(
        "--no-oplog", action="store_true",
        help="skip the op-log seq correlation scan",
    )
    parser.add_argument(
        "--limit", type=int, default=0, metavar="N",
        help="keep only the N newest timeline entries",
    )
    args = parser.parse_args(argv)
    nodes = []
    for path in args.paths:
        node = read_node(path)
        if node is None:
            print(f"no black box under {path!r}", file=sys.stderr)
            continue
        nodes.append(node)
    if not nodes:
        print("nothing to decode", file=sys.stderr)
        return 2
    timeline = merge_timeline(
        nodes, rid=args.rid, with_oplog=not args.no_oplog
    )
    if args.limit > 0:
        timeline = timeline[-args.limit :]
    if args.as_json:
        print(json.dumps({"nodes": nodes, "timeline": timeline}, default=str))
    else:
        print(_render(nodes, timeline))
    return 0


if __name__ == "__main__":
    sys.exit(main())
