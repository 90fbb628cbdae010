"""Multi-tenant filter paging: device memory as a cache over host RAM
over checkpoints (``tpubloom/storage``, on the port's filters).

:class:`TenantStore` splits the flat server registry into a
registry/storage pair: each tenant is **RESIDENT** (its tensors live on
the service's device, in ``service._filters``), **WARM** (serialized via
``ckpt.snapshot_blob`` into a bounded host-RAM pool), or **COLD**
(checkpoint/op-log only). Cold-ranked residents are evicted under a
configurable device-memory budget and lazily re-hydrated on first RPC;
concurrent requests to an evicting/hydrating tenant block on a hydration
future so nobody ever sees a torn filter.

See :mod:`tpubloom_torch.storage.residency` for the design notes
(durability invariants, lock ranks, the shed-path quota story).
"""

from tpubloom_torch.storage.residency import StorageConfig, TenantStore

__all__ = ["StorageConfig", "TenantStore"]
