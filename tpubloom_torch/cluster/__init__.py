"""Cluster mode — hash-slot sharding, MOVED/ASK redirects,
live slot migration. Redis Cluster parity for tpubloom:

* :mod:`tpubloom_torch.cluster.slots` — CRC16-mod-16384 slot hashing (hash
  tags included), the persisted CRC-checked :class:`SlotMap` with
  config epochs;
* :mod:`tpubloom_torch.cluster.node` — per-node :class:`ClusterState`: the
  ownership check behind every keyed RPC (``MOVED``/``ASK``/
  ``CLUSTERDOWN``), migration bookkeeping (dual-write forwards +
  exactly-once import gates), node→node RPC links;
* :mod:`tpubloom_torch.cluster.migrate` — live slot migration
  (``MigrateSlot``): snapshot blobs + op-log tail node→node, the
  replication resync machinery reused, with a dual-write window so no acked
  write is lost and counting filters never double-apply;
* :mod:`tpubloom_torch.cluster.client` — the cluster-aware Python client:
  slot→shard cache refreshed on ``MOVED``, one-shot ``ASK`` follow-ups,
  per-shard sentinel/topology awareness layered on the client;
* :mod:`tpubloom_torch.cluster.rebalance` — ``python -m tpubloom_torch.cluster``:
  ``init`` (seed assignments), ``info``, ``migrate``, ``rebalance``
  (plan + drive slot moves toward an even spread).

Server wiring: ``python -m tpubloom_torch.server --cluster`` (or
``BloomService(cluster=ClusterState(addr, state_dir=...))``) attaches a
:class:`ClusterState`; see :mod:`tpubloom_torch.server.service`. Every
module here speaks gRPC and JSON only, except the migration's snapshot
and install, which run the checkpoint codec on the service's device.
"""

from tpubloom_torch.cluster.client import ClusterClient
from tpubloom_torch.cluster.node import ClusterState, KEYED_METHODS
from tpubloom_torch.cluster.slots import NUM_SLOTS, SlotMap, SlotStore, crc16, key_slot

__all__ = [
    "ClusterClient",
    "ClusterState",
    "KEYED_METHODS",
    "NUM_SLOTS",
    "SlotMap",
    "SlotStore",
    "crc16",
    "key_slot",
]
