"""High-availability primitives of the port (``tpubloom/ha``).

* :mod:`tpubloom_torch.ha.topology` — the topology epoch store (persisted
  beside the op log, carried by ``full_sync_end``) and the cluster-view
  struct.

Promotion (``ha/promotion``) and the sentinel (``ha/sentinel``,
``sentinel.py``) are not ported yet: the server answers ``Promote`` /
``ReplicaOf`` only as their no-op on a primary and refuses the
``promote`` subcommand, naming the HA slice.
"""

from tpubloom_torch.ha.topology import EpochStore, Topology

__all__ = ["EpochStore", "Topology"]
