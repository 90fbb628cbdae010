"""Tiny CRC32C-checked JSON files.

The HA subsystem persists several one-record facts (the topology epoch,
a replica's replication cursor) whose corruption must read as "absent"
— never as a crash, and never as a bogus value: a torn epoch fences the
node harder (safe), a torn cursor costs a full resync (safe). This is
the one shared implementation of that contract: the payload is
canonical JSON (sorted keys), the stored file adds a ``crc`` field over
those canonical bytes, writes go through tmp + ``os.replace``, and any
read problem (missing file, torn JSON, CRC mismatch, wrong shape)
returns None.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Optional

from tpubloom_torch.utils.crc32c import crc32c

log = logging.getLogger("tpubloom.utils")


def _canonical(payload: dict) -> bytes:
    return json.dumps(payload, sort_keys=True).encode()


def store(path: str, payload: dict) -> None:
    """Atomically write ``payload`` (a flat JSON-able dict) + its CRC."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({**payload, "crc": crc32c(_canonical(payload))}, f)
    os.replace(tmp, path)


def load(path: str, fields: tuple) -> Optional[dict]:
    """Read back the dict ``store`` wrote, keeping only ``fields`` (the
    caller's schema — also what the CRC is recomputed over). None on
    any problem, with corruption logged."""
    try:
        with open(path) as f:
            data = json.load(f)
        payload = {k: data[k] for k in fields}
        if int(data["crc"]) != crc32c(_canonical(payload)):
            log.warning("%s failed its CRC check; treating as absent", path)
            return None
        return payload
    except (OSError, ValueError, KeyError, TypeError):
        return None
