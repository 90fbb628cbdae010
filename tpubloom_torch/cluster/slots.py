"""Hash-slot keyspace partitioning (Redis Cluster parity).

Redis Cluster shards its keyspace into 16384 **hash slots**: ``slot =
CRC16(key) mod 16384``, with ``{hash tag}`` extraction so callers can
pin related keys to one slot. tpubbloom's keyed unit is the *filter
name*, so the slot of every RPC is ``key_slot(req["name"])`` — one
filter lives wholly in one slot, and a slot (with all its filters) is
the unit of ownership and migration.

:class:`SlotMap` is one node's view of WHO OWNS WHAT:

* ``owners`` — slot → shard address (the shard primary's announced
  address; a shard's replicas serve the same slots through the
  topology machinery);
* ``migrating`` / ``importing`` — slots mid-handoff (Redis ``CLUSTER
  SETSLOT MIGRATING/IMPORTING`` parity): the *source* keeps serving
  existing filters and answers ``ASK`` for missing ones, the *target*
  only serves requests flagged ``asking``;
* ``epoch`` — the map's config epoch (Redis config-epoch parity): every
  finalized handoff bumps it, and a node only adopts assignments at or
  past its current epoch, so a stale rebalancer replaying old moves
  cannot rewind ownership.

:class:`SlotStore` persists the map as a CRC32C-checked JSON file
(``cluster_slots.json`` via :mod:`tpubloom_torch.utils.crcjson`) beside the op
log: corruption reads as "no map" — the node then refuses keyed traffic
with ``CLUSTERDOWN`` until the rebalancer re-pushes assignments, which
is the safe direction (serve nothing rather than the wrong shard's
keys).
"""

from __future__ import annotations

from typing import Optional

from tpubloom_torch.utils import crcjson

#: Redis Cluster's slot count — kept verbatim so parity tables, hash
#: tags, and operator intuition transfer 1:1.
NUM_SLOTS = 16384

SLOTS_FILE = "cluster_slots.json"


def _crc16_table() -> list:
    """CRC16-CCITT (XMODEM: poly 0x1021, init 0) — the exact polynomial
    Redis Cluster keys slots with."""
    table = []
    for byte in range(256):
        crc = byte << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021 if crc & 0x8000 else crc << 1) & 0xFFFF
        table.append(crc)
    return table


_CRC16_TABLE = _crc16_table()


def crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFF) ^ _CRC16_TABLE[((crc >> 8) ^ b) & 0xFF]
    return crc


def key_slot(name: str | bytes) -> int:
    """Slot of one filter name, with Redis hash-tag semantics: when the
    name contains ``{...}`` with a non-empty body, only the body hashes
    — ``user:{42}:seen`` and ``user:{42}:blocked`` share a slot, so a
    tenant's filters migrate together."""
    raw = name.encode() if isinstance(name, str) else bytes(name)
    start = raw.find(b"{")
    if start >= 0:
        end = raw.find(b"}", start + 1)
        if end > start + 1:  # non-empty tag only, Redis rule
            raw = raw[start + 1 : end]
    return crc16(raw) % NUM_SLOTS


def ranges_of(owners: dict) -> list:
    """Compress ``{slot: addr}`` into sorted ``[[start, end, addr],
    ...]`` (inclusive ends) — the wire/persist form; 16384 per-slot
    entries would bloat every ClusterSlots answer."""
    out: list = []
    for slot in sorted(owners):
        addr = owners[slot]
        if out and out[-1][1] == slot - 1 and out[-1][2] == addr:
            out[-1][1] = slot
        else:
            out.append([slot, slot, addr])
    return out


def expand_ranges(ranges) -> dict:
    owners: dict = {}
    for start, end, addr in ranges or ():
        for slot in range(int(start), int(end) + 1):
            owners[slot] = addr
    return owners


class SlotMap:
    """One node's slot-ownership view (plain data + epoch discipline;
    thread-safety lives in :class:`tpubloom_torch.cluster.node.ClusterState`,
    which owns the single instance per process)."""

    def __init__(self):
        self.epoch = 0
        #: slot -> owning shard address
        self.owners: dict = {}
        #: slot -> target address (this node is handing the slot off)
        self.migrating: dict = {}
        #: slot -> source address (this node is receiving the slot)
        self.importing: dict = {}

    def owner(self, slot: int) -> Optional[str]:
        return self.owners.get(slot)

    def assign(self, slots, addr: str) -> None:
        for slot in slots:
            self.owners[int(slot)] = addr

    def adopt_assignments(self, ranges, epoch: int) -> bool:
        """Adopt a full assignment push iff it is not older than what we
        hold (the config-epoch rule); True iff adopted."""
        if int(epoch) < self.epoch:
            return False
        self.epoch = int(epoch)
        self.owners = expand_ranges(ranges)
        return True

    def to_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "ranges": ranges_of(self.owners),
            "migrating": {str(s): a for s, a in sorted(self.migrating.items())},
            "importing": {str(s): a for s, a in sorted(self.importing.items())},
        }

    @classmethod
    def from_dict(cls, data: dict) -> "SlotMap":
        m = cls()
        m.epoch = int(data.get("epoch") or 0)
        m.owners = expand_ranges(data.get("ranges"))
        m.migrating = {int(s): a for s, a in (data.get("migrating") or {}).items()}
        m.importing = {int(s): a for s, a in (data.get("importing") or {}).items()}
        return m


class SlotStore:
    """CRC-checked persistence of the slot map (corruption = no map =
    ``CLUSTERDOWN`` until re-pushed — never the wrong shard's keys)."""

    _FIELDS = ("epoch", "ranges", "migrating", "importing")

    def __init__(self, directory: str):
        import os

        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, SLOTS_FILE)

    def load(self) -> Optional[SlotMap]:
        data = crcjson.load(self.path, self._FIELDS)
        if data is None:
            return None
        try:
            return SlotMap.from_dict(data)
        except (ValueError, TypeError):
            return None

    def store(self, slot_map: SlotMap) -> None:
        crcjson.store(self.path, slot_map.to_dict())


__all__ = [
    "NUM_SLOTS",
    "crc16",
    "key_slot",
    "ranges_of",
    "expand_ranges",
    "SlotMap",
    "SlotStore",
]
