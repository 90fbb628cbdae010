"""Op-log record framing.

One record = one mutating RPC, exactly as it committed on the primary:

``MAGIC(4) | body_len u32le | body_crc32c u32le | body``

where ``body`` is the msgpack map ``{"seq", "method", "rid", "req",
"ts"}``. ``seq`` is the log-global monotonic sequence number (the
replication cursor — PSYNC-offset parity), ``rid`` the client request id
that committed the op (kept so a replayed op correlates with the
original slowlog/trace entries), ``req`` the decoded request map minus
transport-only fields, ``ts`` the primary's commit wall time (drives
``repl_lag_seconds``).

Integrity reuses :func:`tpubloom_torch.utils.crc32c.crc32c` — the same
polynomial the checkpoint v2 framing declares, so one checksum
implementation covers both durability formats. A record whose CRC or
length does not check out is *torn*: :func:`scan_buffer` stops there and
reports the longest valid prefix, which is what log recovery truncates
to (Redis ``aof-load-truncated`` parity).
"""

from __future__ import annotations

from typing import Optional

import msgpack

from tpubloom_torch.utils.crc32c import crc32c

#: 4-byte per-record magic: cheap resync sentinel + format versioning.
MAGIC = b"TPR1"
HEADER_LEN = len(MAGIC) + 4 + 4


def encode_record(rec: dict) -> bytes:
    """Frame one record dict (caller provides seq/method/rid/req/ts)."""
    body = msgpack.packb(rec, use_bin_type=True)
    return (
        MAGIC
        + len(body).to_bytes(4, "little")
        + crc32c(body).to_bytes(4, "little")
        + body
    )


def decode_record(buf: bytes, offset: int = 0) -> Optional[tuple]:
    """Decode the record at ``offset``; ``(record, next_offset)`` or None
    if the bytes from ``offset`` on do not form one intact record (short
    header, short body, bad magic, CRC mismatch — all read as *torn*)."""
    end = offset + HEADER_LEN
    if len(buf) < end:
        return None
    if buf[offset : offset + 4] != MAGIC:
        return None
    body_len = int.from_bytes(buf[offset + 4 : offset + 8], "little")
    body_crc = int.from_bytes(buf[offset + 8 : end], "little")
    body = buf[end : end + body_len]
    if len(body) != body_len or crc32c(body) != body_crc:
        return None
    return msgpack.unpackb(body, raw=False), end + body_len


def scan_buffer(buf: bytes, offset: int = 0):
    """Parse records until the buffer ends or turns invalid.

    Returns ``(records, valid_len, clean)`` — ``valid_len`` is the byte
    offset just past the last intact record (the truncation point for
    torn-tail repair), ``clean`` is True iff the buffer ended exactly on
    a record boundary."""
    records = []
    while True:
        parsed = decode_record(buf, offset)
        if parsed is None:
            return records, offset, offset == len(buf)
        rec, offset = parsed
        records.append(rec)
