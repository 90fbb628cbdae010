"""Checkpoint blobs of the port's filters: the codec of ``tpubloom/checkpoint.py``
for the kinds the port has, blocked and blocked counting, on one device or
sharded (``shards > 1``, :class:`~tpubloom_torch.parallel.sharded.ShardedBloomFilter`).

A blob is format v2, byte for byte as ``tpubloom`` writes it::

    MAGIC_V2 | header_len u64le | header_crc32c u32le | header_json | payload

The JSON header carries the filter's config (``FilterConfig.to_dict``),
the sequence number, the payload format (``blocked_le_words`` or
``counting_le_words``: the state's row-major little-endian words), the
wall-clock time, ``extra`` (``n_inserted`` / ``n_queried``), and the
payload's length and CRC32C. A sharded filter's payload is its words
shard-major (``tpubloom``'s global array). v1 blobs (``TPUBLOOM1``, no CRC) still
decode. A blob of either package restores in the other; a
:class:`FileSink` directory too, since the file names are the same
(``<key_name>.<seq:012d>.ckpt``).

Kinds the port does not have yet — flat (``redis_bitmap``), flat
counting, flat sharded, ``scalable_stack``, the sketch kinds — raise
``NotImplementedError`` naming the kind; nothing falls back.

The snapshot copies the state on its device first and then to the host:
the port updates a filter in place, so the copy must be taken in stream
order, before any later launch can write the state.
"""

from __future__ import annotations

import json
import logging
import os
import re
import time
from typing import Optional, Tuple

import numpy as np
import torch

from tpubloom_torch.config import FilterConfig, identity_mismatch
from tpubloom_torch.filter import BlockedBloomFilter, BlockedCountingBloomFilter
from tpubloom_torch.parallel.sharded import ShardedBloomFilter
from tpubloom_torch.utils.crc32c import crc32c

log = logging.getLogger("tpubloom_torch.checkpoint")

MAGIC = b"TPUBLOOM1\n"  # v1: no integrity framing (read-compat only)
MAGIC_V2 = b"TPUBLOOM2\n"  # v2: header + payload CRC32C

_CKPT_RE = re.compile(r"^(?P<name>.+)\.(?P<seq>\d{12,})\.ckpt$")


class CheckpointCorruptError(ValueError):
    """A blob failed integrity validation (torn, truncated, bit-rotted).

    Distinct from plain ValueError config/identity mismatches: corruption
    is skippable (fall back a generation), a mismatch is an operator
    error that must surface."""


def _kind_name(config: FilterConfig) -> Optional[str]:
    """The name of the config's kind when the port cannot hold it yet,
    else None."""
    if config.kind != "bloom":
        return f"kind={config.kind!r}"
    if not config.block_bits:
        if config.shards > 1:
            return f"flat sharded (shards={config.shards})"
        return "flat counting" if config.counting else "flat (redis_bitmap)"
    return None


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"tpubloom_torch has no {what} filter yet; its checkpoints restore "
        "only in tpubloom"
    )


def _serialize(
    config: FilterConfig, seq: int, words: np.ndarray, extra: Optional[dict] = None
) -> bytes:
    """Self-describing checkpoint: framing + json header + raw LE words."""
    kind = _kind_name(config)
    if kind is not None:
        raise _unsupported(kind)
    fmt = "counting_le_words" if config.counting else "blocked_le_words"
    return _frame(
        {
            "config": config.to_dict(),
            "seq": seq,
            "format": fmt,
            "time": time.time(),
            "extra": extra or {},
        },
        words.reshape(-1).astype("<u4").tobytes(),
    )


def _frame(header: dict, payload: bytes) -> bytes:
    """Format-v2 writer: the header records the payload's length and
    CRC32C; the header bytes get their own CRC32C right after the length
    word, so corruption anywhere in the blob is attributable."""
    header = {**header, "payload_len": len(payload),
              "payload_crc32c": crc32c(payload)}
    hdr = json.dumps(header).encode()
    return (
        MAGIC_V2
        + len(hdr).to_bytes(8, "little")
        + crc32c(hdr).to_bytes(4, "little")
        + hdr
        + payload
    )


def _deserialize(data: bytes) -> Tuple[dict, bytes]:
    """Parse + integrity-check a blob (v2 full CRC, v1 structural only).

    Raises :class:`CheckpointCorruptError` on anything torn, truncated,
    or bit-rotted; restore treats that as "fall back a generation"."""
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
        if crc32c(payload) != header["payload_crc32c"]:
            raise CheckpointCorruptError("checkpoint payload CRC32C mismatch")
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


def payload_to_words(config: FilterConfig, header: dict, payload: bytes) -> np.ndarray:
    """The payload's ``uint32`` words (the raw-LE-words formats only)."""
    if header["format"] not in ("counting_le_words", "blocked_le_words"):
        raise _unsupported(f"{header['format']!r} payload")
    return np.frombuffer(payload, dtype="<u4").astype(np.uint32)


class FileSink:
    """Checkpoints as ``<dir>/<key_name>.<seq:012d>.ckpt`` files, the names
    ``tpubloom.checkpoint.FileSink`` uses, so either package restores the
    other's directory.

    ``put`` writes a temporary file, fsyncs it and renames it into place:
    a failure at any point leaves no partial ``.ckpt`` visible. Files that
    fail integrity checks at restore are moved to ``<dir>/corrupt/``, so a
    later walk never reads them again."""

    CORRUPT_SUBDIR = "corrupt"

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, key_name: str, seq: int) -> str:
        return os.path.join(self.directory, f"{key_name}.{seq:012d}.ckpt")

    def put(self, key_name: str, seq: int, blob: bytes) -> None:
        final = self._path(key_name, seq)
        tmp = final + ".tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
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
        return dst


def _device_snapshot(tensors: list[torch.Tensor]) -> np.ndarray:
    """Host copy of a filter's state (its tensors' words in order), taken
    through a copy on their devices: each clone is queued on the current
    stream after every launch already made, and no later launch can write
    it."""
    snaps = [t.view(torch.int32).clone() for t in tensors]
    return np.concatenate([s.cpu().numpy().view(np.uint32).reshape(-1) for s in snaps])


def _usage_extra(filter_obj) -> dict:
    """Usage counters recorded in every checkpoint so a restore can
    rebuild the filter's stats."""
    return {
        "n_inserted": getattr(filter_obj, "n_inserted", 0),
        "n_queried": getattr(filter_obj, "n_queried", 0),
    }


def snapshot_blob(
    filter_obj, *, seq: Optional[int] = None, extra: Optional[dict] = None
) -> Tuple[str, int, bytes]:
    """Serialize a live filter into one checkpoint blob without touching
    any sink; returns ``(key_name, seq, blob)``. ``seq`` defaults to the
    millisecond clock, as in ``tpubloom``."""
    seq = seq if seq is not None else int(time.time() * 1000)
    full_extra = {**_usage_extra(filter_obj), **(extra or {})}
    words = _device_snapshot(filter_obj._state_tensors())
    blob = _serialize(filter_obj.config, seq, words, full_extra)
    return filter_obj.config.key_name, seq, blob


def restore_blob(blob: bytes, config: Optional[FilterConfig] = None, *, device=None):
    """Rebuild a live filter from one in-memory blob (integrity-checked
    like any sink read). With no ``config`` the blob's own stored config
    is adopted. ``device`` as for the filter classes (the card unless
    given); a sharded filter (``shards > 1``) gets one slot on it, or
    with no ``device`` one slot per visible card."""
    header, payload = _deserialize(blob)
    if config is None:
        config = FilterConfig.from_dict(header["config"])
    return _build_filter(config, header, payload, device)


def save(filter_obj, sink, *, seq: Optional[int] = None, extra: Optional[dict] = None) -> int:
    """Synchronous snapshot of a filter into ``sink``; returns its seq."""
    key_name, seq, blob = snapshot_blob(filter_obj, seq=seq, extra=extra)
    sink.put(key_name, seq, blob)
    return seq


def restore(config: FilterConfig, sink, *, seq: Optional[int] = None, device=None):
    """Rebuild a filter from the newest intact (or the given) checkpoint in
    ``sink``, or None if the sink has none.

    With no ``seq`` on a sink that lists its generations (``list_seqs``),
    the walk goes newest to oldest: a corrupt blob is quarantined (where
    the sink can) and the next older one is tried; a blob that cannot be
    read (``OSError``) is skipped, not quarantined, since its bytes may be
    fine. Config identity mismatches are not skipped: a wrong config
    raises rather than fall back to an older blob that happens to match.
    """
    if seq is None and hasattr(sink, "list_seqs"):
        for s in sink.list_seqs(config.key_name):
            try:
                blob = sink.get(config.key_name, s)
            except OSError as e:
                log.warning(
                    "checkpoint %r seq %d unreadable (%s); trying older",
                    config.key_name, s, e,
                )
                continue
            if blob is None:
                continue
            try:
                header, payload = _deserialize(blob)
            except CheckpointCorruptError as e:
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
            return _build_filter(config, header, payload, device)
        return None
    blob = sink.get(config.key_name, seq)
    if blob is None:
        return None
    header, payload = _deserialize(blob)
    return _build_filter(config, header, payload, device)


def _build_filter(config: FilterConfig, header: dict, payload: bytes, device=None):
    """Validated header + payload -> live filter, routed as
    ``tpubloom.checkpoint._build_filter`` routes the kinds the port has."""
    if header["format"] == "scalable_stack":
        raise _unsupported("scalable (scalable_stack)")
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
    kind = _kind_name(config)
    if kind is not None:
        raise _unsupported(kind)
    if config.shards > 1:
        f = ShardedBloomFilter(config, None if device is None else [device])
    else:
        cls = BlockedCountingBloomFilter if config.counting else BlockedBloomFilter
        f = cls(config, device)
    words = payload_to_words(config, header, payload)
    n_words = sum(t.numel() for t in f._state_tensors())
    if words.size != n_words:
        raise ValueError(
            f"checkpoint payload holds {words.size} words, the config "
            f"needs {n_words}"
        )
    f._set_words(words)
    f._restored_seq = header["seq"]
    f._restored_meta = header.get("extra", {})
    f.n_inserted = int(f._restored_meta.get("n_inserted", 0))
    f.n_queried = int(f._restored_meta.get("n_queried", 0))
    return f
