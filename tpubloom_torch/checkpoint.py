"""Checkpoint blobs of the port's filters: the codec of ``tpubloom/checkpoint.py``
for every kind: flat and blocked, bit and counting, on one device or
sharded (``shards > 1``,
:class:`~tpubloom_torch.parallel.sharded.ShardedBloomFilter`), the
scalable layer stack (:class:`~tpubloom_torch.scalable.ScalableBloomFilter`)
and the sketch kinds (:mod:`tpubloom_torch.sketch`).

A blob is format v2, byte for byte as ``tpubloom`` writes it::

    MAGIC_V2 | header_len u64le | header_crc32c u32le | header_json | payload

The JSON header carries the filter's config (``FilterConfig.to_dict``),
the sequence number, the payload format (``blocked_le_words`` or
``counting_le_words``: the state's row-major little-endian words;
``redis_bitmap`` for a flat bit filter: the reference gem's SETBIT string
bitmap, ``ceil(m / 8)`` bytes), the wall-clock time, ``extra``
(``n_inserted`` / ``n_queried``, and a top-k sketch's heap), and the
payload's length and CRC32C. A sharded filter's payload is its words
shard-major (``tpubloom``'s global array). A sketch's payload is its raw
LE words under its kind's tag (``sketch_{cuckoo,cms,topk}_le_words``, from
:mod:`tpubloom_torch.sketch.registry`). A scalable filter's
(``scalable_stack``) is its layers' raw LE words one after the other, its
header naming the base config and, under ``scalable``, the growth policy,
each layer's config, count and byte length. v1 blobs (``TPUBLOOM1``, no
CRC) still decode. A blob of either package restores in the other; a
:class:`FileSink` directory too, since the file names are the same
(``<key_name>.<seq:012d>.ckpt``). A payload format the port does not know
raises ``NotImplementedError`` naming it; nothing falls back.

The snapshot copies the state on its device first (a scalable filter's
layers into one tensor): the port updates a filter in place, so the copy
must be taken in stream order, before any later launch can write the
state. The payload's bytes (the bit reversal
of the Redis bitmap, or the raw words) and its CRC32C are then made from
that copy where it lies (:mod:`tpubloom_torch.ops.checksum`: one kernel
pair on the card, its plain version on the CPU), and only the payload
crosses to the host. The header's own CRC32C covers a few hundred bytes
and stays :func:`tpubloom_torch.utils.crc32c.crc32c`. A restore onto the
card checks the payload's CRC32C there too; a restore onto the CPU, or
:func:`_deserialize` with no device, checks it on the host.

Sinks: :class:`FileSink` (a directory; retention by :meth:`FileSink.prune`,
a capped ``corrupt/`` quarantine, :func:`inspect_quarantine`) and
:class:`RedisSink` (a live Redis over the RESP client of
:mod:`tpubloom_torch.server.resp`: the raw bitmap under ``<key_name>``
and the framed generations beside it). :class:`AsyncCheckpointer`
snapshots a filter in the background every ``every_n_inserts`` keys,
with ``tpubloom``'s interface and semantics (the streaming pipeline's
checkpoints, :mod:`tpubloom_torch.parallel.pipeline`).

Fault points (:mod:`tpubloom_torch.faults`), as in ``tpubloom``:
``ckpt.write`` (before the temporary write; the ``torn`` directive writes
half the blob, the case the restore-side CRC walk must catch),
``ckpt.fsync`` (before fsync and rename: a raise leaves no partial final
file) and ``ckpt.restore_read`` (before a blob is read back). Counters
(:mod:`tpubloom_torch.obs.counters`): ``ckpt_corrupt_detected``,
``ckpt_restore_read_errors`` and ``ckpt_quarantine_evicted``, which a
server's Health reasons and metrics read.
"""

from __future__ import annotations

import ctypes
import json
import logging
import os
import queue
import re
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from tpubloom_torch import faults
from tpubloom_torch.config import FilterConfig, identity_mismatch
from tpubloom_torch.filter import resolve_device
from tpubloom_torch.interop import new_filter
from tpubloom_torch.obs import counters as _counters
from tpubloom_torch.ops import checksum
from tpubloom_torch.sketch import registry as sketch_registry
from tpubloom_torch.utils import locks
from tpubloom_torch.utils.crc32c import crc32c
from tpubloom_torch.utils.packing import redis_bitmap_to_words

log = logging.getLogger("tpubloom_torch.checkpoint")

MAGIC = b"TPUBLOOM1\n"  # v1: no integrity framing (read-compat only)
MAGIC_V2 = b"TPUBLOOM2\n"  # v2: header + payload CRC32C

#: Default checkpoint generations the async checkpointer's GC retains.
#: >1 by design: the newest generation being corrupt is exactly the case
#: the restore walk exists for, so there must be a predecessor to fall
#: back to.
DEFAULT_RETAIN = 4

_CKPT_RE = re.compile(r"^(?P<name>.+)\.(?P<seq>\d{12,})\.ckpt$")

#: Base-config identity of a scalable checkpoint: the template's m / k are
#: placeholders (each layer derives its own from the growth policy), so only
#: the fields every layer inherits take part.
IDENTITY_FIELDS_SCALABLE = ("seed", "counting", "shards", "block_bits", "block_hash")

#: Growth-policy fields that a restore request may pin: they fix every
#: layer's (m, k, seed).
SCALABLE_POLICY_FIELDS = ("capacity", "error_rate", "growth", "tightening")


class CheckpointCorruptError(ValueError):
    """A blob failed integrity validation (torn, truncated, bit-rotted).

    Distinct from plain ValueError config/identity mismatches: corruption
    is skippable (fall back a generation), a mismatch is an operator
    error that must surface."""


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"tpubloom_torch cannot read a {what}; such checkpoints restore only "
        "in tpubloom"
    )


def _payload_format(filter_obj) -> Tuple[str, bool]:
    """``(format, bit_reverse)`` of a live filter's payload: the flat bit
    filter stores the Redis bitmap (what the reference's SETBIT loop would
    have produced: each byte's bits reversed), the others their raw LE
    words (a sketch under its kind's tag, a scalable filter its layers'
    words one after the other). A sharded filter of a joined process
    group holds only its rank's shards, so its blob would not be the
    filter's: that raises."""
    if getattr(filter_obj, "distributed", False):
        filter_obj._require_whole("a checkpoint blob")
    if hasattr(filter_obj, "layers"):
        return "scalable_stack", False
    config = filter_obj.config
    if sketch_registry.is_sketch(config):
        return sketch_registry.blob_format(config), False
    if config.counting:
        return "counting_le_words", False
    if config.block_bits:
        return "blocked_le_words", False
    return "redis_bitmap", True


def _payload_nbytes(fmt: str, config: FilterConfig, n_words: int) -> int:
    """Payload bytes: ``ceil(m / 8)`` for a Redis bitmap, else 4 a word."""
    if fmt == "redis_bitmap":
        return (config.m + 7) // 8
    return 4 * n_words


def _header(filter_obj, seq: int, fmt: str, extra: Optional[dict]) -> dict:
    """The header of a live filter's checkpoint, taken with its snapshot. A
    scalable filter's names its base config and holds, under
    ``scalable``, its stack meta (``snapshot_meta``) with each layer's
    payload bytes, as ``tpubloom``'s ``_serialize_scalable`` records it."""
    stack = fmt == "scalable_stack"
    header = {
        "config": (filter_obj.base_config if stack else filter_obj.config).to_dict(),
        "seq": seq,
        "format": fmt,
        "time": time.time(),
        "extra": extra or {},
    }
    if stack:
        header["scalable"] = {
            **filter_obj.snapshot_meta(),
            "layer_nbytes": [4 * sum(t.numel() for t in layer._state_tensors())
                             for layer in filter_obj.layers],
        }
    return header


def _serialize(filter_obj, seq: int, words: torch.Tensor,
               extra: Optional[dict] = None) -> bytearray:
    """Self-describing checkpoint of ``filter_obj``: framing + json header
    + payload, from a snapshot of its state's words (a tensor this call may
    consume) on its device; the payload and its CRC32C are made there."""
    fmt, bit_reverse = _payload_format(filter_obj)
    header = _header(filter_obj, seq, fmt, extra)
    payload, crc = checksum.payload_crc32c(
        words, _payload_nbytes(fmt, filter_obj.config, words.numel()), bit_reverse
    )
    return _frame(header, payload.cpu().numpy(), crc)


def _uninitialized_bytearray(n: int) -> bytearray:
    """A bytearray of ``n`` bytes whose contents are not written:
    ``bytearray(n)`` would zero them while holding the GIL (a 2 GiB
    payload's framing would then stall the thread that launches
    inserts)."""
    make = ctypes.pythonapi.PyByteArray_FromStringAndSize
    make.restype = ctypes.py_object
    make.argtypes = [ctypes.c_void_p, ctypes.c_ssize_t]
    return make(None, n)


def _frame(header: dict, payload, payload_crc: int) -> bytearray:
    """Format-v2 writer: the header records the payload's length and its
    CRC32C (computed by the caller from the same bytes); the header bytes
    get their own CRC32C right after the length word, so corruption
    anywhere in the blob is attributable. ``payload`` is any bytes-like
    (a numpy ``uint8`` array: the page-locked buffer of an async
    checkpoint). The blob is a bytearray into which numpy copies the
    payload once, with the GIL released."""
    src = np.frombuffer(memoryview(payload).cast("B"), dtype=np.uint8)
    header = {**header, "payload_len": int(src.size), "payload_crc32c": payload_crc}
    hdr = json.dumps(header).encode()
    prefix = MAGIC_V2 + len(hdr).to_bytes(8, "little") + crc32c(hdr).to_bytes(4, "little") + hdr
    blob = _uninitialized_bytearray(len(prefix) + src.size)
    blob[: len(prefix)] = prefix
    np.frombuffer(blob, dtype=np.uint8, offset=len(prefix))[:] = src
    return blob


def _parse(data: bytes) -> Tuple[dict, bytes]:
    """Framing and header checks of a blob (v2: header CRC and payload
    length; v1: structure only): ``(header, payload)``. Raises
    :class:`CheckpointCorruptError` on anything torn or truncated. The
    payload's CRC32C is :func:`_deserialize`'s."""
    if data.startswith(MAGIC_V2):
        off = len(MAGIC_V2)
        if len(data) < off + 12:
            raise CheckpointCorruptError("checkpoint truncated in framing")
        hlen = int.from_bytes(data[off : off + 8], "little")
        hcrc = int.from_bytes(data[off + 8 : off + 12], "little")
        hdr = data[off + 12 : off + 12 + hlen]
        if len(hdr) != hlen:
            raise CheckpointCorruptError("checkpoint truncated in header")
        if crc32c(hdr) != hcrc:
            raise CheckpointCorruptError("checkpoint header CRC32C mismatch")
        header = json.loads(hdr)  # CRC passed: json is structurally sound
        payload = data[off + 12 + hlen :]
        if len(payload) != header["payload_len"]:
            raise CheckpointCorruptError(
                f"checkpoint payload truncated: header says "
                f"{header['payload_len']} bytes, found {len(payload)}"
            )
        return header, payload
    if data.startswith(MAGIC):
        # v1 (pre-integrity framing): structural validation only — a torn
        # v1 header fails the json parse; a torn v1 payload is
        # undetectable here (that is why v2 exists)
        off = len(MAGIC)
        hlen = int.from_bytes(data[off : off + 8], "little")
        raw = data[off + 8 : off + 8 + hlen]
        if len(raw) != hlen:
            raise CheckpointCorruptError("v1 checkpoint truncated in header")
        try:
            header = json.loads(raw)
        except ValueError as e:
            raise CheckpointCorruptError(f"v1 checkpoint header unparseable: {e}")
        return header, data[off + 8 + hlen :]
    raise CheckpointCorruptError("not a tpubloom checkpoint (bad magic)")


def _deserialize(data: bytes, device=None) -> Tuple[dict, bytes]:
    """Parse + integrity-check a blob (v2 full CRC, v1 structural only).

    The payload's CRC32C is checked on ``device`` when it is a CUDA device
    (the blob's payload is going there), else on the host. Raises
    :class:`CheckpointCorruptError` on anything torn, truncated, or
    bit-rotted; restore treats that as "fall back a generation"."""
    header, payload = _parse(data)
    if data.startswith(MAGIC_V2):
        if device is not None and torch.device(device).type == "cuda":
            got = checksum.bytes_crc32c(payload, device)
        else:
            got = crc32c(payload)
        if got != header["payload_crc32c"]:
            raise CheckpointCorruptError("checkpoint payload CRC32C mismatch")
    return header, payload


def payload_to_words(config: FilterConfig, header: dict, payload: bytes) -> np.ndarray:
    """The payload's ``uint32`` words (raw LE words, or a Redis bitmap)."""
    if header["format"] in ("counting_le_words", "blocked_le_words") or (
        header["format"].startswith("sketch_")
    ):
        return np.frombuffer(payload, dtype="<u4").astype(np.uint32)
    if header["format"] == "redis_bitmap":
        return redis_bitmap_to_words(payload, config.m)
    raise _unsupported(f"{header['format']!r} payload")


class FileSink:
    """Checkpoints as ``<dir>/<key_name>.<seq:012d>.ckpt`` files, the names
    ``tpubloom.checkpoint.FileSink`` uses, so either package restores the
    other's directory.

    ``put`` writes a temporary file, fsyncs it and renames it into place:
    a failure at any point leaves no partial ``.ckpt`` visible. Files that
    fail integrity checks at restore are moved to ``<dir>/corrupt/``, so a
    later walk never reads them again."""

    CORRUPT_SUBDIR = "corrupt"

    #: Default cap on the quarantine dir: corrupt blobs are post-mortem
    #: material, not an unbounded landfill — oldest ones are dropped once
    #: the dir exceeds this (:func:`inspect_quarantine` lists survivors).
    QUARANTINE_MAX_BYTES = 256 << 20

    def __init__(self, directory: str, *, quarantine_max_bytes: Optional[int] = None):
        self.directory = directory
        self.quarantine_max_bytes = (
            self.QUARANTINE_MAX_BYTES
            if quarantine_max_bytes is None
            else quarantine_max_bytes
        )
        os.makedirs(directory, exist_ok=True)

    def _path(self, key_name: str, seq: int) -> str:
        return os.path.join(self.directory, f"{key_name}.{seq:012d}.ckpt")

    def put(self, key_name: str, seq: int, blob: bytes) -> None:
        final = self._path(key_name, seq)
        tmp = final + ".tmp"
        try:
            directive = faults.fire("ckpt.write")
            if directive == "torn":
                # a torn write: the write "succeeds" from the process's
                # view but half the blob is gone; only the restore-side
                # CRC walk can catch it
                blob = blob[: max(1, len(blob) // 2)]
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                faults.fire("ckpt.fsync")
                os.fsync(f.fileno())
            os.replace(tmp, final)
        except BaseException:
            # never leave a stale tmp behind
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def list_seqs(self, key_name: str) -> list:
        """All generations for ``key_name``, newest first."""
        return sorted(
            (
                int(m.group("seq"))
                for fn in os.listdir(self.directory)
                if (m := _CKPT_RE.match(fn)) and m.group("name") == key_name
            ),
            reverse=True,
        )

    def latest_seq(self, key_name: str) -> Optional[int]:
        seqs = self.list_seqs(key_name)
        return seqs[0] if seqs else None

    def get(self, key_name: str, seq: Optional[int] = None) -> Optional[bytes]:
        if seq is None:
            seq = self.latest_seq(key_name)
            if seq is None:
                return None
        path = self._path(key_name, seq)
        if not os.path.exists(path):
            return None
        faults.fire("ckpt.restore_read")
        with open(path, "rb") as f:
            return f.read()

    def quarantine(self, key_name: str, seq: int) -> Optional[str]:
        """Move a corrupt generation into ``<dir>/corrupt/``; returns the
        new path (None if the file vanished underneath us)."""
        src = self._path(key_name, seq)
        qdir = os.path.join(self.directory, self.CORRUPT_SUBDIR)
        os.makedirs(qdir, exist_ok=True)
        dst = os.path.join(qdir, os.path.basename(src))
        try:
            os.replace(src, dst)
        except FileNotFoundError:
            return None
        self._enforce_quarantine_cap(qdir, protect=dst)
        return dst

    def _enforce_quarantine_cap(self, qdir: str, protect: str) -> None:
        """Drop oldest quarantined blobs until the dir fits the cap (the
        just-quarantined file is protected — the freshest one is the one
        an operator most wants to examine). 0 disables the cap."""
        if not self.quarantine_max_bytes:
            return
        entries = []
        for fn in os.listdir(qdir):
            path = os.path.join(qdir, fn)
            try:
                st = os.stat(path)
            except OSError:
                continue
            entries.append((st.st_mtime, st.st_size, path))
        total = sum(size for _, size, _ in entries)
        for _, size, path in sorted(entries):
            if total <= self.quarantine_max_bytes:
                break
            if path == protect:
                continue
            try:
                os.unlink(path)
                total -= size
                _counters.incr("ckpt_quarantine_evicted")
            except OSError:
                pass

    def prune(self, key_name: str, keep: int = 2) -> int:
        """Drop all but the newest ``keep`` generations (quarantined files
        live in a subdirectory and are never touched); returns the number
        of files removed."""
        seqs = self.list_seqs(key_name)  # newest first
        pruned = 0
        for s in seqs[keep:] if keep else seqs:
            try:
                os.unlink(self._path(key_name, s))
                pruned += 1
            except FileNotFoundError:
                pass
        return pruned


class RedisSink:
    """Checkpoints into a live Redis, keeping the reference's storage
    model: the keys and index of ``tpubloom.checkpoint.RedisSink``, so
    either package restores the other's generations. Keys written per
    checkpoint:

    * ``<key_name>`` — the RAW Redis bitmap (flat bit filters), the exact
      string the reference's ``:ruby`` driver GETBITs against;
    * ``<key_name>:tpubloom.ckpt:<seq>`` — the framed blob for that
      generation (header + payload, seq/config-aware restore);
    * ``<key_name>:tpubloom.ckpt.seqs`` — JSON index of retained seqs,
      newest first (the RESP client has no KEYS/SCAN, so enumeration is
      explicit — and atomic per sink because every mutation runs under
      the sink lock);
    * ``<key_name>:tpubloom.ckpt`` — the newest blob under the legacy
      key, kept so readers of the single-blob layout still restore.

    With ``list_seqs``/``quarantine``/``prune`` present, the corrupt-newest
    restore walk and the retention GC behave exactly as on a
    :class:`FileSink`: a bit-rotted newest generation is copied to
    ``<key_name>:tpubloom.ckpt.corrupt:<seq>``, dropped from the index, and
    the previous generation restores.

    ``put`` checks the blob's framing and header (its payload CRC32C was
    computed from the same bytes by the writer, and every read checks it
    again), so a multi-GiB payload is not checksummed twice on the host.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 6379, **kwargs):
        from tpubloom_torch.server.resp import RespClient

        self._client = RespClient(host, port, **kwargs)
        self._lock = locks.named_lock("ckpt.redis_sink")

    def _index_key(self, key_name: str) -> str:
        return f"{key_name}:tpubloom.ckpt.seqs"

    def _gen_key(self, key_name: str, seq: int) -> str:
        return f"{key_name}:tpubloom.ckpt:{seq:012d}"

    def _read_index(self, key_name: str) -> list:
        """Retained seqs newest-first (caller holds the lock). Falls back
        to the legacy single-blob key for sinks written before the index
        existed."""
        raw = self._client.get(self._index_key(key_name))
        if raw is not None:
            return sorted((int(s) for s in json.loads(raw)), reverse=True)
        legacy = self._client.get(f"{key_name}:tpubloom.ckpt")
        if legacy is None:
            return []
        try:
            header, _ = _deserialize(legacy)
        except ValueError:
            return []
        return [int(header["seq"])]

    def _write_index(self, key_name: str, seqs: list) -> None:
        self._client.set(
            self._index_key(key_name),
            json.dumps(sorted(set(seqs), reverse=True)).encode(),
        )

    def put(self, key_name: str, seq: int, blob: bytes) -> None:
        header, payload = _parse(blob)
        with self._lock:
            if header["format"] == "redis_bitmap":
                self._client.set(key_name, payload)
            self._client.set(self._gen_key(key_name, seq), blob)
            self._client.set(f"{key_name}:tpubloom.ckpt", blob)  # legacy readers
            self._write_index(key_name, self._read_index(key_name) + [seq])

    def list_seqs(self, key_name: str) -> list:
        """All retained generations, newest first (FileSink parity)."""
        with self._lock:
            return self._read_index(key_name)

    def latest_seq(self, key_name: str) -> Optional[int]:
        seqs = self.list_seqs(key_name)
        return seqs[0] if seqs else None

    def get(self, key_name: str, seq: Optional[int] = None) -> Optional[bytes]:
        with self._lock:
            if seq is None:
                seqs = self._read_index(key_name)
                if not seqs:
                    return None
                seq = seqs[0]
            blob = self._client.get(self._gen_key(key_name, seq))
            if blob is None:
                # legacy layout: the only copy lives under the bare key
                blob = self._client.get(f"{key_name}:tpubloom.ckpt")
                if blob is not None:
                    try:
                        header, _ = _deserialize(blob)
                    except ValueError:
                        return None  # corrupt legacy blob: nothing older exists
                    if header["seq"] != seq:
                        return None
            return blob

    def quarantine(self, key_name: str, seq: int) -> Optional[str]:
        """Move a corrupt generation to ``...ckpt.corrupt:<seq>`` and drop
        it from the index so the restore walk never re-reads it; returns
        the corrupt key (None if the blob vanished underneath us)."""
        with self._lock:
            gen = self._gen_key(key_name, seq)
            blob = self._client.get(gen)
            if blob is None:
                blob = self._client.get(f"{key_name}:tpubloom.ckpt")
            dst = f"{key_name}:tpubloom.ckpt.corrupt:{seq:012d}"
            if blob is not None:
                self._client.set(dst, blob)
            self._client.delete(gen)
            self._write_index(
                key_name,
                [s for s in self._read_index(key_name) if s != seq],
            )
            return dst if blob is not None else None

    def prune(self, key_name: str, keep: int = 2) -> int:
        """Drop all but the newest ``keep`` generations (retention GC,
        FileSink parity); returns generations removed."""
        with self._lock:
            seqs = self._read_index(key_name)
            victims = seqs[keep:] if keep else seqs
            for s in victims:
                self._client.delete(self._gen_key(key_name, s))
            if victims:
                self._write_index(key_name, seqs[:keep] if keep else [])
            return len(victims)

    def close(self) -> None:
        self._client.close()


def inspect_quarantine(directory: str, *, purge: bool = False) -> dict:
    """Operator view of ``<directory>/corrupt/``, as
    ``tpubloom.checkpoint.inspect_quarantine``.

    Each entry carries a ``diagnosis`` from re-running the integrity
    checks: what exactly is broken (header CRC, payload CRC, truncation
    ...) plus the header fields when they are still readable — enough to
    decide whether a blob is worth a deeper post-mortem before ``purge``
    drops it."""
    qdir = os.path.join(directory, FileSink.CORRUPT_SUBDIR)
    entries = []
    if os.path.isdir(qdir):
        for fn in sorted(os.listdir(qdir)):
            path = os.path.join(qdir, fn)
            try:
                st = os.stat(path)
            except OSError:
                continue
            diagnosis, header_info = "unreadable", None
            try:
                with open(path, "rb") as f:
                    blob = f.read()
                try:
                    _deserialize(blob)
                    diagnosis = "intact (quarantined by an older build?)"
                except CheckpointCorruptError as e:
                    diagnosis = str(e)
                # best effort: a payload-corrupt blob still has a good
                # header — surface seq/format/time for the post-mortem
                if blob.startswith(MAGIC_V2):
                    off = len(MAGIC_V2)
                    hlen = int.from_bytes(blob[off : off + 8], "little")
                    hdr = blob[off + 12 : off + 12 + hlen]
                    if len(hdr) == hlen and crc32c(hdr) == int.from_bytes(
                        blob[off + 8 : off + 12], "little"
                    ):
                        h = json.loads(hdr)
                        header_info = {
                            "seq": h.get("seq"),
                            "format": h.get("format"),
                            "time": h.get("time"),
                        }
            except OSError as e:
                diagnosis = f"read failed: {e}"
            entries.append(
                {
                    "file": fn,
                    "bytes": st.st_size,
                    "mtime": st.st_mtime,
                    "diagnosis": diagnosis,
                    "header": header_info,
                }
            )
    purged = 0
    if purge:
        for e in entries:
            try:
                os.unlink(os.path.join(qdir, e["file"]))
                purged += 1
            except OSError:
                pass
    return {
        "quarantine_dir": qdir,
        "entries": entries,
        "total_bytes": sum(e["bytes"] for e in entries),
        "purged": purged,
    }


def _device_snapshot(tensors: list[torch.Tensor]) -> torch.Tensor:
    """A copy of a filter's state (its tensors' words in order, as one
    ``uint32`` tensor on the first tensor's device), queued on the current
    stream of each tensor's device: after every launch already made there,
    and out of reach of any later one."""
    flat = [t.view(torch.int32).reshape(-1) for t in tensors]
    dev = flat[0].device
    snap = flat[0].clone() if len(flat) == 1 else torch.cat([x.to(dev) for x in flat])
    return snap.view(torch.uint32)


def _usage_extra(filter_obj) -> dict:
    """Usage counters recorded in every checkpoint so a restore can
    rebuild the filter's stats, and the host state a kind declares (a
    top-k sketch's heap: the counter grid alone cannot name the hot keys)."""
    out = {
        "n_inserted": getattr(filter_obj, "n_inserted", 0),
        "n_queried": getattr(filter_obj, "n_queried", 0),
    }
    sketch_extra = getattr(filter_obj, "sketch_extra", None)
    if sketch_extra is not None:
        out.update(sketch_extra())
    return out


def snapshot_blob(
    filter_obj, *, seq: Optional[int] = None, extra: Optional[dict] = None
) -> Tuple[str, int, bytearray]:
    """Serialize a live filter into one checkpoint blob without touching
    any sink; returns ``(key_name, seq, blob)``, the blob a bytearray
    (the bytes ``tpubloom`` would write). ``seq`` defaults to the
    millisecond clock, as in ``tpubloom``."""
    seq = seq if seq is not None else int(time.time() * 1000)
    full_extra = {**_usage_extra(filter_obj), **(extra or {})}
    words = _device_snapshot(filter_obj._state_tensors())
    blob = _serialize(filter_obj, seq, words, full_extra)
    return filter_obj.config.key_name, seq, blob


def restore_blob(
    blob: bytes,
    config: Optional[FilterConfig] = None,
    *,
    device=None,
    scalable_expect: Optional[dict] = None,
    expect_scalable: Optional[bool] = None,
):
    """Rebuild a live filter from one in-memory blob (integrity-checked
    like any sink read). With no ``config`` the blob's own stored config
    is adopted (for a ``scalable_stack`` blob, its base config).
    ``device`` as for :func:`~tpubloom_torch.interop.new_filter` (the card
    unless given); ``scalable_expect`` / ``expect_scalable`` as for
    :func:`restore`."""
    dev = resolve_device(device)
    header, payload = _deserialize(blob, dev)
    if config is None:
        config = FilterConfig.from_dict(header["config"])
    return _build_filter(config, header, payload, device, scalable_expect, expect_scalable)


def save(filter_obj, sink, *, seq: Optional[int] = None, extra: Optional[dict] = None) -> int:
    """Synchronous snapshot of a filter into ``sink``; returns its seq."""
    key_name, seq, blob = snapshot_blob(filter_obj, seq=seq, extra=extra)
    sink.put(key_name, seq, blob)
    return seq


def restore(
    config: FilterConfig,
    sink,
    *,
    seq: Optional[int] = None,
    device=None,
    scalable_expect: Optional[dict] = None,
    expect_scalable: Optional[bool] = None,
):
    """Rebuild a filter from the newest intact (or the given) checkpoint in
    ``sink``, or None if the sink has none.

    For a ``scalable_stack`` blob ``config`` is the base config, whose
    identity fields (:data:`IDENTITY_FIELDS_SCALABLE`) must match the
    stored one, and ``scalable_expect`` may pin the growth policy
    (:data:`SCALABLE_POLICY_FIELDS`). ``expect_scalable`` (when not None)
    refuses a blob of the other kind (a layer stack where a fixed-size
    filter was asked for, or the reverse) before any state is built.

    With no ``seq`` on a sink that lists its generations (``list_seqs``),
    the walk goes newest to oldest: a corrupt blob is quarantined (where
    the sink can, counted as ``ckpt_corrupt_detected``) and the next older
    one is tried; a blob that cannot be read (an I/O error, or the
    ``ckpt.restore_read`` fault point) is skipped, not quarantined, since
    its bytes may be fine, and counted as ``ckpt_restore_read_errors``.
    Config identity mismatches are not skipped: a wrong config
    raises rather than fall back to an older blob that happens to match.
    The payload's CRC32C is checked on the device the filter is rebuilt
    on (the card unless ``device`` names another).
    """
    locks.note_blocking(
        "ckpt.restore",
        allow=("service.registry",),
        reason="restore-on-create IS the create's commit point and must "
        "serialize under the registry lock; control-plane-rare",
    )
    dev = resolve_device(device)
    if seq is None and hasattr(sink, "list_seqs"):
        for s in sink.list_seqs(config.key_name):
            try:
                blob = sink.get(config.key_name, s)
            except Exception as e:
                _counters.incr("ckpt_restore_read_errors")
                log.warning(
                    "checkpoint %r seq %d unreadable (%s); trying older",
                    config.key_name, s, e,
                )
                continue
            if blob is None:
                continue
            try:
                header, payload = _deserialize(blob, dev)
            except CheckpointCorruptError as e:
                _counters.incr("ckpt_corrupt_detected")
                qpath = (
                    sink.quarantine(config.key_name, s)
                    if hasattr(sink, "quarantine")
                    else None
                )
                log.error(
                    "checkpoint %r seq %d corrupt (%s)%s; trying older",
                    config.key_name, s, e,
                    f", quarantined to {qpath}" if qpath else "",
                )
                continue
            return _build_filter(config, header, payload, device, scalable_expect,
                                 expect_scalable)
        return None
    blob = sink.get(config.key_name, seq)
    if blob is None:
        return None
    header, payload = _deserialize(blob, dev)
    return _build_filter(config, header, payload, device, scalable_expect, expect_scalable)


def _restore_scalable(config: FilterConfig, header: dict, payload: bytes, device=None,
                      expect: Optional[dict] = None):
    """A :class:`~tpubloom_torch.scalable.ScalableBloomFilter` from a
    ``scalable_stack`` blob: ``config`` is the base config, ``expect``
    optionally pins the growth policy; each layer's geometry is derived
    again and checked against the stored one."""
    from tpubloom_torch.scalable import ScalableBloomFilter

    saved = header["config"]
    field = identity_mismatch(saved, config, IDENTITY_FIELDS_SCALABLE)
    if field is not None:
        raise ValueError(
            f"scalable checkpoint/config mismatch on base {field}: "
            f"saved={saved.get(field, '<absent: default>')} "
            f"requested={getattr(config, field)}"
        )
    meta = header["scalable"]
    if expect is not None:
        for name in SCALABLE_POLICY_FIELDS:
            if name in expect and expect[name] != meta[name]:
                raise ValueError(
                    f"scalable checkpoint/policy mismatch on {name}: "
                    f"saved={meta[name]} requested={expect[name]}"
                )
    f = ScalableBloomFilter(
        meta["capacity"], meta["error_rate"], config=config,
        growth=meta["growth"], tightening=meta["tightening"], device=device,
    )
    words, off = [], 0
    for nbytes in meta["layer_nbytes"]:
        words.append(np.frombuffer(payload[off : off + nbytes], dtype="<u4").astype(np.uint32))
        off += nbytes
    f._load_layers(meta, words)
    f._restored_seq = header["seq"]
    f._restored_meta = header.get("extra", {})
    return f


def _build_filter(
    config: FilterConfig,
    header: dict,
    payload: bytes,
    device=None,
    scalable_expect: Optional[dict] = None,
    expect_scalable: Optional[bool] = None,
):
    """Validated header + payload -> live filter, routed as
    ``tpubloom.checkpoint._build_filter`` routes them."""
    is_stack = header["format"] == "scalable_stack"
    if expect_scalable is not None and is_stack != expect_scalable:
        raise ValueError(
            f"checkpoint for {config.key_name!r} holds a "
            f"{'scalable layer stack' if is_stack else 'fixed-size filter'}; "
            f"requested a {'scalable' if expect_scalable else 'fixed-size'} filter"
        )
    if is_stack:
        return _restore_scalable(config, header, payload, device, scalable_expect)
    saved = header["config"]
    field = identity_mismatch(saved, config)
    if field is not None:
        # .get: legacy headers may predate a field (it then mismatched
        # against the field's default, e.g. block_bits -> flat)
        raise ValueError(
            f"checkpoint/config mismatch on {field}: "
            f"saved={saved.get(field, '<absent: default>')} "
            f"requested={getattr(config, field)}"
        )
    if sketch_registry.is_sketch(config):
        # identity_mismatch refuses a kind flip; this guards a mislabelled
        # payload tag
        want = sketch_registry.blob_format(config)
        if header["format"] != want:
            raise ValueError(
                f"checkpoint payload tag {header['format']!r} does not match "
                f"kind {config.kind!r} (want {want!r})"
            )
    words = payload_to_words(config, header, payload)
    f = new_filter(config, device)
    n_words = sum(t.numel() for t in f._state_tensors())
    if words.size != n_words:
        raise ValueError(
            f"checkpoint payload holds {words.size} words, the config "
            f"needs {n_words}"
        )
    f._set_words(words)
    loader = getattr(f, "load_sketch_extra", None)
    if loader is not None:
        loader(header.get("extra", {}))
    f._restored_seq = header["seq"]
    f._restored_meta = header.get("extra", {})
    f.n_inserted = int(f._restored_meta.get("n_inserted", 0))
    f.n_queried = int(f._restored_meta.get("n_queried", 0))
    return f


class AsyncCheckpointer:
    """Background checkpoint writer with bounded lag: the interface and
    semantics of ``tpubloom.checkpoint.AsyncCheckpointer``.

    ``notify_inserts(n)`` after each batch; every ``every_n_inserts`` keys
    a snapshot is taken and handed to a worker thread that writes it to
    the sink. If a write is still in flight the trigger is deferred —
    checkpoints never queue up, and inserts are never blocked.

    On the card, :meth:`trigger` enqueues, on the caller's thread: a copy
    of the state on the filter's current stream (after every insert
    already launched, before any later one: stream order, not a lock,
    makes the snapshot consistent); an event; and on a side stream that
    waits that event, the payload's checksum kernels
    (:mod:`tpubloom_torch.ops.checksum`) and a non-blocking copy of the
    payload into one page-locked host buffer (allocated at the first
    trigger, reused, since at most one checkpoint is in flight, and freed
    by :meth:`close`). The worker waits the copy's event, frames the blob
    (one copy out of the page-locked buffer) and calls ``sink.put``. On
    the CPU the payload is made by the plain version at trigger time.

    A build or launch failure raises from :meth:`trigger`; a sink's write
    error goes to :attr:`last_error`, as in ``tpubloom``.
    """

    def __init__(
        self,
        filter_obj,
        sink,
        *,
        every_n_inserts: int = 0,
        meta_fn=None,
        retain: int = DEFAULT_RETAIN,
    ):
        """``meta_fn() -> dict`` (optional) is sampled at trigger time and
        stored in the checkpoint header's ``extra`` field — the streaming
        pipeline records its stream offset this way so resume knows where
        to replay from. ``retain`` bounds how many generations the sink
        keeps (GC runs after each successful write, on sinks with
        ``prune``); 0 disables GC."""
        self.filter = filter_obj
        self.sink = sink
        self.every_n_inserts = every_n_inserts
        self.meta_fn = meta_fn
        self.retain = retain
        self._since_last = 0
        # Millisecond-epoch base keeps sequence numbers monotonic across
        # process restarts (restore picks the max seq in the sink).
        self._seq = int(time.time() * 1000)
        self._queue: "queue.Queue" = queue.Queue(maxsize=1)
        self._busy = threading.Event()
        self._trigger_lock = locks.named_lock("ckpt.trigger")
        self._stop = False
        self._host: Optional[checksum.PinnedBuffer] = None
        self._side: Optional[torch.cuda.Stream] = None
        self.last_error: Optional[Exception] = None
        self.checkpoints_written = 0
        #: when the last checkpoint landed in the sink + how long its write
        #: took (from the worker's pick-up: the wait for the copy to the
        #: host, the framing and ``sink.put``)
        self.last_checkpoint_time: Optional[float] = None
        self.last_checkpoint_duration_s: Optional[float] = None
        #: the ``extra`` header of the last checkpoint that verifiably
        #: LANDED (not merely triggered)
        self.last_landed_meta: Optional[dict] = None
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            seq, key_name, blob_fn, extra = item
            t0 = time.perf_counter()
            try:
                # blob_fn waits for the payload's copy to the host
                self.sink.put(key_name, seq, blob_fn())
                # the gauges before the count, so that a reader who sees
                # the count move reads this checkpoint's duration
                self.last_checkpoint_duration_s = time.perf_counter() - t0
                self.last_checkpoint_time = time.time()
                self.last_landed_meta = extra
                self.checkpoints_written += 1
                self.last_error = None  # a success clears a transient failure
                if self.retain and hasattr(self.sink, "prune"):
                    # GC AFTER a confirmed-good write: the newest blob is
                    # intact, so dropping generations beyond `retain`
                    # never strips the corruption fallback
                    try:
                        self.sink.prune(key_name, keep=self.retain)
                    except Exception:  # GC failure must not fail the write
                        log.exception("checkpoint GC for %r failed", key_name)
            except Exception as e:  # surfaced via last_error + obs_stats
                self.last_error = e
            finally:
                self._busy.clear()

    def notify_inserts(self, n: int) -> None:
        self._since_last += n
        if self.every_n_inserts and self._since_last >= self.every_n_inserts:
            self.trigger()  # resets _since_last itself when it fires

    def obs_stats(self) -> dict:
        """Checkpoint gauges: lag (inserts since the last trigger fired),
        age (seconds since a write last landed), last write duration, seq,
        written count."""
        return {
            "lag_inserts": self._since_last,
            "age_seconds": (
                time.time() - self.last_checkpoint_time
                if self.last_checkpoint_time is not None
                else None
            ),
            "last_duration_seconds": self.last_checkpoint_duration_s,
            "seq": self._seq,
            "checkpoints_written": self.checkpoints_written,
            "in_flight": self._busy.is_set(),
            "last_error": (
                repr(self.last_error) if self.last_error is not None else None
            ),
        }

    def _start_payload(self, fmt: str, bit_reverse: bool):
        """Queue the snapshot (a scalable filter's layers concatenated into
        one tensor), its payload and CRC32C, and (on the card) the copy to
        the host; returns a callable that waits for them and gives
        ``(payload bytes-like, crc)``."""
        snap = _device_snapshot(self.filter._state_tensors())
        nbytes = _payload_nbytes(fmt, self.filter.config, snap.numel())
        if snap.device.type != "cuda":
            payload, crc = checksum.payload_crc32c(snap, nbytes, bit_reverse)
            return lambda: (payload.numpy(), crc)
        dev = snap.device
        if self._side is None:
            self._side = torch.cuda.Stream(dev)
        if self._host is None or self._host.nbytes != nbytes:
            if self._host is not None:
                self._host.free()
                self._host = None
            self._host = checksum.PinnedBuffer(nbytes)
        taken = torch.cuda.Event()
        taken.record(torch.cuda.current_stream(dev))
        snap.record_stream(self._side)  # read by the side stream after the caller drops it
        host, side = self._host, self._side
        crc_host = torch.empty(1, dtype=torch.int32, pin_memory=True)
        with torch.cuda.device(dev), torch.cuda.stream(side):
            side.wait_event(taken)
            payload, crc = checksum.launch_payload_crc32c(snap, nbytes, bit_reverse)
            host.tensor.copy_(payload, non_blocking=True)
            crc_host.copy_(crc, non_blocking=True)
            landed = torch.cuda.Event()
            landed.record(side)

        def wait():
            landed.synchronize()
            return host.array, int(crc_host[0]) & 0xFFFFFFFF

        return wait

    def trigger(self) -> bool:
        """Start an async checkpoint now; False if one is still in flight.

        Call it from the thread that launches the inserts (or under the
        caller's own exclusion), so that the snapshot lands between two
        of them in stream order. A scalable filter's stack meta is taken
        with its layers' words, and its layers are concatenated on their
        device before one payload kernel pair runs over them."""
        with self._trigger_lock:
            if self._stop or self._busy.is_set():
                return False
            self._busy.set()
            try:
                # a landed trigger restarts the lag window — manual
                # triggers count too, or the lag gauge would lie
                self._since_last = 0
                self._seq = max(self._seq + 1, int(time.time() * 1000))
                extra = _usage_extra(self.filter)
                if self.meta_fn:
                    extra.update(self.meta_fn())
                seq = self._seq
                fmt, bit_reverse = _payload_format(self.filter)
                header = _header(self.filter, seq, fmt, extra)
                payload_fn = self._start_payload(fmt, bit_reverse)
            except BaseException:
                self._busy.clear()
                raise

            def blob_fn():
                payload, crc = payload_fn()
                return _frame(header, payload, crc)

        self._queue.put((seq, self.filter.config.key_name, blob_fn, extra))
        return True

    def flush(self, timeout: float = 60.0) -> bool:
        """Block until the in-flight checkpoint (if any) is written.

        Returns False if it is still unfinished at ``timeout`` — callers
        treating a checkpoint as a durability point must check this.
        """
        locks.note_blocking(
            "ckpt.flush",
            allow=("filter.op",),
            reason="a close under the filter's op lock by design: the final "
            "snapshot must exclude concurrent inserts",
        )
        deadline = time.time() + timeout
        while self._busy.is_set() and time.time() < deadline:
            time.sleep(0.005)
        return not self._busy.is_set()

    def close(self, *, final_checkpoint: bool = True) -> bool:
        """Stop the worker; with ``final_checkpoint`` take one last snapshot.

        Returns True iff the final snapshot verifiably landed in the sink
        (always True when ``final_checkpoint=False``). Callers using close
        as a durability point must check this. Frees the page-locked
        buffer once the worker has stopped.
        """
        locks.note_blocking(
            "ckpt.close",
            allow=("filter.op",),
            reason="a close under the filter's op lock by design: the final "
            "snapshot must exclude concurrent inserts",
        )
        ok = True
        if final_checkpoint:
            ok = self.flush()  # drain any in-flight write first
            ok = self.trigger() and ok
            ok = self.flush() and ok
        self._stop = True
        self._queue.put(None)
        self._worker.join(timeout=30)
        if self._host is not None and not self._worker.is_alive():
            self._host.free()
            self._host = None
        if final_checkpoint and self.last_error is not None:
            ok = False
        return ok

    @property
    def seq(self) -> int:
        return self._seq
