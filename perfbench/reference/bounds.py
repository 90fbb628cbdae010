"""The least time the card could take for one call into the filter: bytes
and integer operations counted from the call's own inputs, over the peaks
in ``peaks.json``. Frozen here so that the same work is counted whatever
kernels a later version of the program runs.

Bytes (each input byte read once, each output byte written once): a
key's bytes and its 4-byte length in, a verdict byte a key out of a call
that answers; the state's distinct pieces that the batch touches read
once, and written once more by a call that sets bits. A blocked key
touches its 64-byte row; a flat key the 32-byte sectors of its k bits,
and a flat query that stops at a key's first zero bit reads only the
sectors up to it.

Operations (32-bit integer, at the INT32 rate; the count whatever the
design): murmur3_32 over L bytes 11 a word plus 10 of finalisation;
FNV-1a 4 a byte; a blocked key hashes three murmurs, one FNV and k slices
of 4, tests k bits at 4 each and sets k at 3 each; a flat key hashes three
murmurs and one FNV, and steps its walk at 8 a position read or set.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = Path(__file__).resolve().with_name("peaks.json")
SECTOR_BYTES = 32


def peaks(device_name: str) -> dict | None:
    """The published peaks of a card by its name, or None where the table
    has none."""
    return json.loads(PEAKS.read_text()).get(device_name)


def _murmur(L: int) -> int:
    return 11 * (L // 4) + 10


def blocked(*, keys: int, L: int, k: int, row_bytes: int, distinct_rows: int,
            answers: bool, sets: bool) -> tuple[int, int]:
    """``(bytes, operations)`` of a blocked call of ``keys`` rows."""
    nbytes = keys * (L + 4) + (keys if answers else 0)
    nbytes += distinct_rows * row_bytes * (2 if sets else 1)
    per_key = 3 * _murmur(L) + 4 * L + 4 * k + (4 * k if answers else 0) + (3 * k if sets else 0)
    return nbytes, keys * per_key


def flat(*, keys: int, valid: int, L: int, distinct_sectors: int, positions: int,
         answers: bool, sets: bool) -> tuple[int, int]:
    """``(bytes, operations)`` of a flat call of ``keys`` rows, ``valid`` of
    them keys, that reads (and sets, ``sets``) ``positions`` bits over
    ``distinct_sectors`` sectors."""
    nbytes = keys * (L + 4) + (keys if answers else 0)
    nbytes += distinct_sectors * SECTOR_BYTES * (2 if sets else 1)
    return nbytes, valid * (3 * _murmur(L) + 4 * L) + positions * 8


def least_seconds(nbytes: int, ops: int, peak: dict) -> float:
    """The larger of bytes over the memory rate and operations over the
    INT32 rate."""
    return max(nbytes / peak["hbm_bytes_per_s"], ops / peak["int32_ops_per_s"])
