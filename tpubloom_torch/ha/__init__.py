"""High-availability plane of the port (``tpubloom/ha``), answer for answer:

* :mod:`tpubloom_torch.ha.promotion` — replica→primary promotion (op-log
  adoption, identity aliasing for cheap survivor resync, persisted
  topology epoch) and primary→replica demotion (``ReplicaOf``, Redis
  ``REPLICAOF`` parity), behind the server's ``Promote`` / ``ReplicaOf``
  RPCs and ``python -m tpubloom_torch.server promote``;
* :mod:`tpubloom_torch.ha.sentinel` — the failover coordinator
  (``python -m tpubloom_torch.sentinel``): a quorum of watchers that
  health-poll the primary, agree on SDOWN→ODOWN by epoch-stamped votes,
  promote the most-caught-up replica, re-point survivors and fence
  stale-epoch primaries. Host code and gRPC only; it watches servers of
  either package;
* :mod:`tpubloom_torch.ha.topology` — the topology epoch store (persisted
  beside the op log, carried by ``full_sync_end``) and the cluster-view
  struct sentinels announce and topology-aware clients cache.

The filters stay on the card through a role change: promotion adopts the
op log and rebuilds the creation manifest on the host, and demotion
drains the coalescer's launched flushes before the applier takes the log
over.
"""

from tpubloom_torch.ha.promotion import become_replica, promote_to_primary
from tpubloom_torch.ha.topology import EpochStore, Topology

__all__ = [
    "become_replica",
    "promote_to_primary",
    "EpochStore",
    "Topology",
]
