"""Topology epoch + cluster-view primitives.

The split-brain discipline is Raft's term idea applied to a much smaller
problem: every change of WHO IS PRIMARY happens under a monotonically
increasing **topology epoch**. A promotion persists the new epoch next
to the op log it adopted; every `Promote`/`ReplicaOf` RPC is
epoch-stamped and a stale epoch is rejected (``STALE_EPOCH``); sentinels
vote at most once per epoch, so two concurrent failovers cannot both win
the same epoch; clients cache the epoch with their topology and refresh
when a server proves theirs stale. A restarted pre-failover primary
carries the OLD epoch and is therefore fenceable: any sentinel that sees
it claim ``role=primary`` below the current epoch demotes it with
``ReplicaOf`` (Redis Sentinel's ``slaveof`` fencing, with Raft's "term
wins arguments" rule deciding who moves).

:class:`EpochStore` is the persistence: a tiny CRC32C-checked JSON file
(``epoch.json``) beside the op log — corrupt/torn contents read as epoch
0 rather than a crash, because a LOWER-than-true epoch only ever makes
this node easier to fence (safe direction).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import Optional

from tpubloom_torch.utils import crcjson

log = logging.getLogger("tpubloom.ha")

EPOCH_FILE = "epoch.json"


class EpochStore:
    """Persisted topology epoch (one integer, CRC-checked via
    :mod:`tpubloom_torch.utils.crcjson` — corrupt reads as epoch 0, the
    fence-me-harder direction)."""

    def __init__(self, directory: str):
        self.directory = directory
        self.path = os.path.join(directory, EPOCH_FILE)

    def load(self) -> int:
        data = crcjson.load(self.path, ("epoch",))
        if data is None:
            return 0
        try:
            return int(data["epoch"])
        except (ValueError, TypeError):
            return 0

    def store(self, epoch: int) -> None:
        os.makedirs(self.directory, exist_ok=True)
        crcjson.store(self.path, {"epoch": int(epoch)})


@dataclass
class Topology:
    """One cluster view: the epoch it was established under, the primary
    address, and the known replica addresses. What sentinels agree on,
    announce to each other, and serve to topology-aware clients."""

    epoch: int = 0
    primary: Optional[str] = None
    replicas: list = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "primary": self.primary,
            "replicas": list(self.replicas),
        }

    @classmethod
    def from_dict(cls, data: dict) -> "Topology":
        return cls(
            epoch=int(data.get("epoch") or 0),
            primary=data.get("primary"),
            replicas=list(data.get("replicas") or ()),
        )

    def adopt(self, other: "Topology") -> bool:
        """Take ``other``'s view iff it is from a NEWER epoch (the Raft
        rule: higher term wins every argument); True iff adopted."""
        if other.epoch <= self.epoch or not other.primary:
            return False
        self.epoch = other.epoch
        self.primary = other.primary
        self.replicas = list(other.replicas)
        return True
