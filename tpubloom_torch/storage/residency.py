"""Tenant registry + tiered residency manager, on the port's filters
(``tpubloom/storage/residency.py`` with device bytes read from each
filter's tensors).

The deployment shape this reproduces is the source gem's Redis model —
many small per-tenant filters multiplexed onto one server — at card
scale: device memory is treated as an LRU-ish cache over host-RAM blobs over
on-disk checkpoints, the way an OS page cache or a database buffer pool
treats fast memory as a cache over durable storage.

Residency states (per tenant)::

    RESIDENT --evict--> WARM --trim--> COLD
        ^                 |              |
        +----hydrate------+--------------+

* **RESIDENT** — device arrays live; the tenant is in the server's
  ``_filters`` registry and serves at device speed.
* **WARM** — the filter is one ``ckpt.snapshot_blob`` blob in a bounded
  host-RAM pool; hydration is a ``restore_blob`` (host→device copy, no
  disk IO).
* **COLD** — only the durable tier holds it (checkpoint generation
  and/or op-log records); hydration restores the newest checkpoint.

Durability invariants (what makes "SIGKILL during eviction loses
nothing" true):

1. Eviction never creates a new durability obligation — every acked
   write was already op-logged (or checkpoint-covered) before its RPC
   returned. Eviction only ADDS a durable generation: after the blob is
   taken, the tenant's checkpointer is closed with a final checkpoint
   stamped at the evicted ``applied_seq``.
2. The checkpoint-keyed op-log truncation sweep treats paged tenants
   exactly like resident ones: :meth:`TenantStore.truncate_floor`
   reports the lowest seq any paged tenant still needs replayed from
   the log (``None`` = some paged tenant has no durable checkpoint at
   all, so the whole log must stay — the same rule the sweep already
   applies to resident filters without a sink). A SIGKILL at ANY point
   therefore recovers through the ordinary replay path: manifest →
   restore-on-create → op-log tail.
3. The eviction critical section runs under the victim's op lock and
   unpublishes it from the registry before releasing, so no write can
   land on device arrays the blob missed; stragglers that already
   resolved the ``_Managed`` re-check its ``evicted`` flag after
   acquiring the lock (``BloomService._op``) and re-resolve through the
   hydration path.

Quotas + fairness (the shed-path plug-in): hydration is the
expensive fault path, so it gets admission control of its own — a
global in-flight cap (``hydration_max_concurrent``) and a per-tenant
token bucket (``tenant_hydrations_per_min``). A request that would
exceed either is shed with ``RESOURCE_EXHAUSTED`` + the server's
adaptive ``retry_after_ms`` hint (the same signal the in-flight cap
emits), so a cold-tenant stampede backs off instead of churning the hot
set — and because eviction ranks by decayed key-traffic heat (the same
load signal the per-slot traffic counters follow), one-touch cold tenants
can never out-rank the hot set for residency.

Lock ranks (declared in ``tpubloom/analysis/lock_order.py``): the
manager's bookkeeping lock is ``storage.state`` and is a LEAF apart
from counter/gauge updates — it is never held across a filter/registry
lock, a device launch, or blob IO. Hydration waiters block on a plain
event holding no locks (``locks.note_blocking("storage.hydrate")``
enforces that at runtime); the eviction path's only nesting is the
pre-existing ``filter.op -> service.registry`` unpublish edge.

Device memory (the port's addition): the budget bounds what the card
holds, not only the bookkeeping. One thread evicts at a time (the
*evictor*; others that find the budget over leave it the work, so that
concurrent hydrations never evict a victim each), and a hydration
reserves its tenant's bytes and makes room for them BEFORE it restores:
the resident bytes plus the reservations of hydrations in flight stay
within the budget whenever something is evictable.

Fault points: ``storage.evict`` fires before an eviction takes the
victim's lock (an injected fault aborts the eviction cleanly — the
tenant stays resident and serving); ``storage.hydrate`` fires before a
hydration restores (nothing published — the faulted request errors and
a retry re-hydrates).
"""

from __future__ import annotations

import logging
import math
import threading
import time
from typing import Optional

from tpubloom_torch import checkpoint as ckpt
from tpubloom_torch import faults
from tpubloom_torch.obs import counters as obs_counters
from tpubloom_torch.obs import flight as obs_flight
from tpubloom_torch.obs import trace as obs_trace
from tpubloom_torch.utils import locks

log = logging.getLogger("tpubloom.storage")

#: Residency states (entry.state).
RESIDENT = "resident"
EVICTING = "evicting"
WARM = "warm"
COLD = "cold"
HYDRATING = "hydrating"


class StorageConfig:
    """Residency budget + paging policy knobs.

    ``max_resident_filters`` / ``max_resident_bytes`` cap the RESIDENT
    tier (None = that dimension unbounded; both None disables paging
    pressure but keeps the registry/bookkeeping, which is what the
    server does when the flags are omitted — storage is only attached
    when a budget is set). ``warm_pool_bytes`` bounds the host-RAM blob
    pool: over budget, the coldest WARM tenants whose state is fully
    checkpoint-covered are trimmed to COLD (tenants without a durable
    generation are never trimmed — correctness beats the budget).
    ``hydration_max_concurrent`` + ``tenant_hydrations_per_min`` are
    the shed-path quotas documented in the module docstring.
    ``heat_halflife_s`` is the decay of the key-traffic heat eviction
    ranks by."""

    def __init__(
        self,
        max_resident_filters: Optional[int] = None,
        max_resident_bytes: Optional[int] = None,
        *,
        warm_pool_bytes: int = 256 * 1024 * 1024,
        hydration_max_concurrent: int = 4,
        tenant_hydrations_per_min: int = 0,
        heat_halflife_s: float = 60.0,
    ):
        self.max_resident_filters = (
            int(max_resident_filters) if max_resident_filters else None
        )
        self.max_resident_bytes = (
            int(max_resident_bytes) if max_resident_bytes else None
        )
        self.warm_pool_bytes = int(warm_pool_bytes)
        self.hydration_max_concurrent = int(hydration_max_concurrent)
        self.tenant_hydrations_per_min = int(tenant_hydrations_per_min)
        self.heat_halflife_s = float(heat_halflife_s)


class _Tenant:
    """One tenant's residency bookkeeping (all fields guarded by the
    store's ``storage.state`` lock unless noted)."""

    __slots__ = (
        "name", "state", "create_req", "blob", "blob_bytes",
        "applied_seq", "landed_seq", "device_bytes", "last_bytes", "reserved",
        "heat", "heat_t", "q_tokens", "q_t", "busy_done",
    )

    def __init__(self, name: str):
        self.name = name
        self.state = RESIDENT
        #: CreateFilter-shaped request that rebuilds this filter
        #: (manifest format — what promotion's rebuild_manifest needs
        #: for paged tenants and what a COLD restore parses its config
        #: from)
        self.create_req: Optional[dict] = None
        #: WARM tier: the snapshot blob (host RAM), None when COLD/RESIDENT
        self.blob: Optional[bytes] = None
        self.blob_bytes = 0
        #: newest op-log seq the paged state contains (valid when not
        #: RESIDENT — the resident filter's _Managed.applied_seq wins)
        self.applied_seq = 0
        #: newest seq covered by a DURABLE checkpoint generation; None =
        #: nothing durable beyond the op log, the truncation sweep must
        #: keep this tenant's whole record history
        self.landed_seq: Optional[int] = None
        #: device footprint while resident (budget math)
        self.device_bytes = 0
        #: the footprint it had when last resident (0: never measured) —
        #: what a hydration reserves
        self.last_bytes = 0
        #: bytes reserved by an in-flight hydration (HYDRATING only)
        self.reserved = 0
        #: exponentially-decayed key traffic (the eviction rank) + its
        #: last decay timestamp
        self.heat = 0.0
        self.heat_t = time.monotonic()
        #: per-tenant hydration token bucket (quota satellite)
        self.q_tokens: Optional[float] = None
        self.q_t = time.monotonic()
        #: set while HYDRATING/EVICTING; waiters block on it (holding no
        #: locks) and then re-resolve
        self.busy_done: Optional[threading.Event] = None

    def decayed_heat(self, now: float, halflife: float) -> float:
        if halflife <= 0:
            return self.heat
        return self.heat * (0.5 ** ((now - self.heat_t) / halflife))

    def evict_rank(self, now: float, halflife: float) -> tuple:
        """Eviction order: (log2 heat band, last touch). The band
        protects the hot set — orders-of-magnitude traffic differences
        dominate — while RECENCY breaks ties inside a band. Pure
        min-heat ranking thrashes under concurrent scans: every
        worker's *in-progress* tenant (touched once so far) ranks
        below its *finished* neighbours (touched a few times), so
        concurrent workers keep evicting each other's working set —
        measured at ~20 hydrations per logical op in the smoke before
        banding, ~2 after."""
        band = int(math.log2(self.decayed_heat(now, halflife) + 1.0))
        return (band, self.heat_t)


def _device_bytes(filt) -> int:
    """Device footprint of a live filter: the bytes of the tensors that
    hold its state (every layer of a scalable stack, every slot of a
    sharded array, a sketch's grid or table) — sizes only, never a
    transfer or a launch."""
    return int(sum(t.nbytes for t in filt._state_tensors()))


class TenantStore:
    """The registry/storage pair's storage half: every tenant the server
    has ever created (resident or paged) has one entry here; the
    server's ``_filters`` dict holds only the RESIDENT tier."""

    def __init__(self, service, config: Optional[StorageConfig] = None):
        self._service = service
        self.config = config or StorageConfig()
        self._lock = locks.named_lock("storage.state")
        self._entries: dict[str, _Tenant] = {}
        self._resident_bytes = 0
        self._warm_bytes = 0
        self._hydrating = 0
        #: the thread that is evicting (one at a time), and the event its
        #: waiters block on until it is done
        self._evictor: Optional[int] = None
        self._evictor_done = threading.Event()
        self._update_gauges_locked()

    # -- bookkeeping hooks (called by the service at its commit points) ------

    def note_created(self, name: str) -> None:
        """A filter was just created/attached/installed RESIDENT —
        register (or refresh) its entry. Idempotent."""
        svc = self._service
        mf = svc._filters.get(name)
        if mf is None:
            return
        create_req = svc._manifest_req_for(name, mf.filter)
        nbytes = _device_bytes(mf.filter)
        with self._lock:
            if svc._filters.get(name) is not mf:
                # dropped (or replaced) between the lookup above and
                # this lock — filing now would resurrect a phantom
                # entry for a tenant whose forget already ran
                return
            e = self._entries.get(name)
            if e is None:
                e = self._entries[name] = _Tenant(name)
            if e.state in (EVICTING, HYDRATING):
                # a transition owns the entry's bookkeeping — refresh
                # only the rebuild recipe and let it settle its own
                # state (the evictor re-reads the registry, so it
                # operates on whatever filter is published now)
                e.create_req = create_req
                return
            was = e.device_bytes if e.state == RESIDENT else 0
            e.state = RESIDENT
            e.create_req = create_req
            self._warm_bytes -= e.blob_bytes
            e.blob, e.blob_bytes = None, 0
            e.device_bytes = nbytes
            self._resident_bytes += nbytes - was
            self._update_gauges_locked()

    def forget(self, name: str) -> None:
        """The tenant was dropped (DropFilter / retain_only). EVICTING
        entries reclaim their device bytes HERE: the evictor's filing
        block finds the entry gone and skips its own accounting, so
        skipping it here too would leak phantom resident bytes into the
        budget forever (permanent eviction pressure)."""
        with self._lock:
            e = self._entries.pop(name, None)
            if e is None:
                return
            if e.state in (RESIDENT, EVICTING):
                self._resident_bytes -= e.device_bytes
            self._warm_bytes -= e.blob_bytes
            if e.busy_done is not None:
                # a waiter parked on an in-flight transition must wake
                # NOW and discover the tenant is gone (NOT_FOUND), not
                # stall out its full wait timeout
                e.busy_done.set()
                e.busy_done = None
            self._update_gauges_locked()

    def retain_only(self, names) -> None:
        keep = set(names)
        with self._lock:
            victims = [n for n in self._entries if n not in keep]
        for n in victims:
            self.forget(n)

    def touch(self, name: str, nkeys: int = 1) -> None:
        """Record key traffic against the tenant's heat (the eviction
        rank) — called from the RPC wrapper with the request's batch
        size, so the rank follows the same load signal the per-slot
        per-slot traffic counters expose."""
        now = time.monotonic()
        hl = self.config.heat_halflife_s
        with self._lock:
            e = self._entries.get(name)
            if e is None:
                return
            e.heat = e.decayed_heat(now, hl) + max(1, int(nkeys))
            e.heat_t = now

    # -- views ---------------------------------------------------------------

    def names(self) -> list:
        with self._lock:
            return list(self._entries)

    def has(self, name: str) -> bool:
        with self._lock:
            return name in self._entries

    def max_applied_seq(self) -> int:
        """Highest op-log seq any PAGED tenant's state contains —
        promotion folds this into its adopted-seq computation so a
        bare replica's fresh log never mints seqs below a paged
        tenant's history."""
        with self._lock:
            return max(
                (e.applied_seq for e in self._entries.values()
                 if e.state not in (RESIDENT,)),
                default=0,
            )

    def summary(self) -> dict:
        with self._lock:
            counts = {RESIDENT: 0, EVICTING: 0, WARM: 0, COLD: 0, HYDRATING: 0}
            for e in self._entries.values():
                counts[e.state] += 1
            return {
                "tenants": len(self._entries),
                "resident": counts[RESIDENT] + counts[EVICTING],
                "warm": counts[WARM] + counts[HYDRATING],
                "cold": counts[COLD],
                "resident_bytes": self._resident_bytes,
                "warm_bytes": self._warm_bytes,
                "max_resident_filters": self.config.max_resident_filters,
                "max_resident_bytes": self.config.max_resident_bytes,
            }

    def create_reqs(self) -> dict:
        """name -> manifest-shaped create request for every non-RESIDENT
        tenant (promotion's rebuild_manifest — resident tenants rebuild
        from their live filters; a tenant mid-transition is in neither
        registry snapshot, so its recipe must come from here — the
        caller's setdefault keeps the live version when both exist)."""
        with self._lock:
            return {
                e.name: dict(e.create_req)
                for e in self._entries.values()
                if e.state != RESIDENT and e.create_req
            }

    def truncate_floor(self) -> Optional[int]:
        """Lowest op-log seq a paged tenant still needs from the log
        (invariant 2 in the module docstring). None = some paged tenant
        has no durable checkpoint — keep the whole log."""
        floor = None
        with self._lock:
            for e in self._entries.values():
                if e.state == RESIDENT:
                    continue  # the resident sweep already covers it
                # EVICTING counts as PAGED here, deliberately: the
                # victim is already unpublished from the registry (the
                # resident sweep no longer sees it) but its fresh
                # durable generation has not landed yet — its floor is
                # whatever the PREVIOUS filing recorded, i.e. None for
                # a first eviction, which pins the whole log for the
                # duration of the eviction window. Conservative, and
                # exactly what "SIGKILL at ANY point loses nothing"
                # requires.
                if e.landed_seq is None:
                    return None
                floor = (
                    e.landed_seq if floor is None
                    else min(floor, e.landed_seq)
                )
        return floor if floor is not None else 1 << 62

    def paged_plan_items(self, exclude) -> list:
        """``[(name, loader)]`` for every tenant NOT in ``exclude`` —
        the full-resync plan's paged half: a replica bootstrapping off
        this primary must receive paged tenants too, without forcing
        them resident. Each loader returns ``(blob, applied_seq)`` at
        send time (lazy, one blob in flight — same discipline as the
        resident half)."""
        out = []
        with self._lock:
            for e in self._entries.values():
                if e.name in exclude or e.state in (RESIDENT,):
                    continue
                out.append((e.name, self._make_loader(e.name)))
        return out

    def _make_loader(self, name: str):
        def load():
            return self.peek_blob(name)

        return load

    def peek_blob(self, name: str):
        """``(blob, applied_seq)`` of a paged tenant WITHOUT hydrating:
        WARM answers from the pool; COLD reads the newest checkpoint
        generation's bytes straight off the sink; a tenant that went
        resident since the caller planned snapshots live under its op
        lock, and an in-flight transition is waited out (no forced
        hydration just to stream a blob)."""
        deadline = time.monotonic() + 60.0
        while True:
            wait_ev = None
            with self._lock:
                e = self._entries.get(name)
                if e is None:
                    raise KeyError(name)
                if e.blob is not None:
                    return e.blob, e.applied_seq
                state, applied, create_req = e.state, e.applied_seq, e.create_req
                if state in (HYDRATING, EVICTING):
                    wait_ev = e.busy_done
            if wait_ev is not None:
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"tenant {name!r} stuck in transition — cannot "
                        f"stream its blob"
                    )
                locks.note_blocking("storage.hydrate")
                wait_ev.wait(timeout=5.0)
                continue
            if state == COLD:
                return self._sink_blob(name, create_req), applied
            # resident: take a live snapshot under the op lock
            mf = self._service._filters.get(name)
            if mf is None or getattr(mf, "evicted", False):
                # transition raced us (or a retain_only is mid-teardown)
                # — back off briefly and re-read the state instead of
                # hammering the bookkeeping lock
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"tenant {name!r} stuck in transition — cannot "
                        f"stream its blob"
                    )
                time.sleep(0.002)
                continue
            with mf.lock:
                if getattr(mf, "evicted", False):
                    continue
                _, _, blob = ckpt.snapshot_blob(
                    mf.filter, extra={"repl_seq": mf.applied_seq}
                )
                return blob, mf.applied_seq

    def _sink_blob(self, name: str, create_req) -> bytes:
        svc = self._service
        config = svc._config_of(create_req or {"name": name})
        sink = svc._sink_factory(config)
        blob = sink.get(name) if sink is not None else None
        if blob is None:
            raise RuntimeError(
                f"cold tenant {name!r} has no readable checkpoint "
                f"generation — cannot stream it"
            )
        return blob

    # -- hydration (the read side of the cache) ------------------------------

    def resolve(self, name: str, *, control_plane: bool = False):
        """The ``_get`` fault path: return the RESIDENT ``_Managed`` for
        ``name``, hydrating (or waiting on an in-flight hydration /
        eviction) as needed; ``None`` for an unknown tenant. May raise
        ``RESOURCE_EXHAUSTED`` when a hydration quota sheds the request
        (never with ``control_plane=True`` — replication/replay/admin
        paths must make progress regardless of data-plane pressure)."""
        from tpubloom_torch.server import protocol

        svc = self._service
        deadline = time.monotonic() + 120.0
        while True:
            mf = svc._filters.get(name)
            if mf is not None and not getattr(mf, "evicted", False):
                return mf
            if time.monotonic() > deadline:
                # a wedged transition must surface, not spin a worker
                # thread forever
                raise protocol.BloomServiceError(
                    "INTERNAL",
                    f"tenant {name!r} stuck in a residency transition",
                )
            wait_ev = None
            start = False
            shed_msg = None
            with self._lock:
                e = self._entries.get(name)
                if e is None:
                    return None
                if e.state in (HYDRATING, EVICTING):
                    wait_ev = e.busy_done
                elif e.state in (WARM, COLD):
                    if control_plane:
                        start = True
                    elif self._hydrating >= self.config.hydration_max_concurrent:
                        shed_msg = (
                            f"hydration concurrency cap "
                            f"{self.config.hydration_max_concurrent} "
                            f"reached — retry with backoff"
                        )
                    elif not self._quota_ok_locked(e):
                        shed_msg = (
                            f"tenant {name!r} exceeded its hydration "
                            f"quota — retry with backoff"
                        )
                    else:
                        start = True
                    if start:
                        e.state = HYDRATING
                        e.reserved = e.last_bytes
                        e.busy_done = threading.Event()
                        self._hydrating += 1
                        self._update_gauges_locked()
                # else: state RESIDENT with the registry briefly out of
                # sync (bookkeeping races the publish by a few
                # instructions) — fall through and loop
            if start:
                # the hydration runs on the faulting request's thread —
                # a storage.hydrate child span names exactly where a
                # cold-tenant request spent its time (a no-op
                # without an armed request context)
                with obs_trace.span("storage.hydrate", tenant=name):
                    return self._hydrate(name)
            if shed_msg is not None:
                # quota shed (the shed path): the same adaptive
                # retry_after_ms signal the in-flight cap emits, so a
                # cold-tenant stampede paces itself off instead of
                # churning the hot set
                hint = svc.shed_hint()
                obs_counters.incr("storage_hydrations_shed")
                svc.metrics.count("requests_shed")
                obs_flight.note(
                    "shed", source="hydration", tenant=name,
                    retry_after_ms=hint,
                )
                raise protocol.BloomServiceError(
                    "RESOURCE_EXHAUSTED", shed_msg,
                    details={"retry_after_ms": hint, "tenant": name},
                )
            if wait_ev is not None:
                # block holding NO locks (runtime-enforced) until the
                # in-flight transition settles, then re-resolve
                locks.note_blocking("storage.hydrate")
                wait_ev.wait(timeout=60.0)
                continue
            time.sleep(0.001)

    def _quota_ok_locked(self, e: _Tenant) -> bool:
        per_min = self.config.tenant_hydrations_per_min
        if per_min <= 0:
            return True
        now = time.monotonic()
        if e.q_tokens is None:
            e.q_tokens = float(per_min)
        e.q_tokens = min(
            float(per_min), e.q_tokens + per_min * (now - e.q_t) / 60.0
        )
        e.q_t = now
        if e.q_tokens < 1.0:
            return False
        e.q_tokens -= 1.0
        return True

    def _hydrate(self, name: str):
        """Restore one WARM/COLD tenant to RESIDENT (caller claimed the
        HYDRATING state). Publishes the fresh ``_Managed`` into the
        registry, then flips the entry — waiters loop until they see
        the registry entry."""
        svc = self._service
        t0 = time.perf_counter()
        try:
            faults.fire("storage.hydrate")
            # room for the reserved bytes first: the card never holds
            # the newcomer on top of a full budget
            self.ensure_budget(protect=name, wait=True)
            with self._lock:
                e = self._entries[name]
                blob, applied, create_req = e.blob, e.applied_seq, e.create_req
            if blob is not None:
                mf = svc._managed_from_blob(blob, applied)
            else:
                mf = svc._managed_from_sink(name, create_req)
            #: durable floor at hydration time — if the tenant is
            #: evicted again WITHOUT advancing past it (read-only
            #: churn), the old generation still covers everything and
            #: the eviction skips its final checkpoint (the thrash
            #: fast path: a query-only residency cycle costs no disk
            #: write)
            mf.hydration_landed_seq = e.landed_seq
            with svc._lock:
                svc._filters[name] = mf
            nbytes = _device_bytes(mf.filter)
            now = time.monotonic()
            with self._lock:
                e = self._entries.get(name)
                if e is not None:
                    e.state = RESIDENT
                    e.reserved = 0
                    self._warm_bytes -= e.blob_bytes
                    e.blob, e.blob_bytes = None, 0
                    e.device_bytes = nbytes
                    self._resident_bytes += nbytes
                    # a hydration IS an access: bump heat recency so the
                    # follow-on budget pass never picks the tenant it
                    # just paged in (self-eviction would live-lock the
                    # faulting request)
                    e.heat = e.decayed_heat(now, self.config.heat_halflife_s) + 1.0
                    e.heat_t = now
                    self._update_gauges_locked()
            if e is None:
                # the tenant was DELETED (retain_only / a racing drop)
                # while we hydrated: undo the publish — leaving the
                # resurrected filter in the registry would serve a
                # tenant the primary dropped, invisible to the
                # residency manager forever
                with svc._lock:
                    if svc._filters.get(name) is mf:
                        svc._filters.pop(name, None)
                if mf.checkpointer is not None:
                    mf.checkpointer.close(final_checkpoint=False)
                from tpubloom_torch.server import protocol

                raise protocol.BloomServiceError(
                    "NOT_FOUND",
                    f"filter {name!r} was dropped during hydration",
                )
            obs_counters.incr("storage_hydrations_total")
            svc.metrics.observe_hydration(time.perf_counter() - t0)
        except BaseException:
            with self._lock:
                e = self._entries.get(name)
                if e is not None and e.state == HYDRATING:
                    e.state = WARM if e.blob is not None else COLD
                    e.reserved = 0
            raise
        finally:
            with self._lock:
                self._hydrating -= 1
                e = self._entries.get(name)
                if e is not None and e.busy_done is not None:
                    e.busy_done.set()
                    e.busy_done = None
                self._update_gauges_locked()
        self.ensure_budget(protect=name)
        return mf

    # -- eviction (the write-back side) --------------------------------------

    def ensure_budget(self, protect: Optional[str] = None, *, wait: bool = False) -> int:
        """Evict cold-ranked residents until the budget holds; returns how
        many this call evicted. Runs on the calling thread, OUTSIDE every
        lock. One thread evicts at a time: a caller that finds another
        evictor at work leaves the budget to it (that evictor re-reads the
        budget before each victim, so it sees this caller's bytes), or,
        with ``wait`` (a hydration making room for its reservation),
        blocks holding no locks until it is done and looks again.
        ``protect`` names a tenant this pass must not pick: the hydration
        path protects the tenant it is paging in — with a full budget of
        hotter tenants the newcomer is otherwise always the min-rank
        victim, and the faulting request would hydrate/evict in a loop
        without ever being served. No-op during op-log replay (replay
        pages down ONCE at the end instead of thrashing per record)."""
        if self._service._replaying:
            return 0
        me = threading.get_ident()
        evicted = 0
        while True:
            wait_ev = None
            with self._lock:
                if self._evictor not in (None, me):
                    if not wait or not self._over_budget_locked():
                        return evicted
                    wait_ev = self._evictor_done
                else:
                    victim = self._pick_victim_locked(protect)
                    if victim is None:
                        self._release_evictor_locked(me)
                        return evicted
                    if self._evictor is None:
                        self._evictor = me
                        self._evictor_done = threading.Event()
                    victim.state = EVICTING
                    victim.busy_done = threading.Event()
                    self._update_gauges_locked()
            if wait_ev is not None:
                locks.note_blocking("storage.hydrate")
                wait_ev.wait(timeout=60.0)
                continue
            try:
                # evictions run on the thread that grew residency — the
                # span shows up under the request that paid for them
                with obs_trace.span("storage.evict", tenant=victim.name):
                    self._evict(victim.name)
                evicted += 1
            except BaseException as exc:  # noqa: BLE001 — eviction must fail soft
                # an aborted eviction (injected storage.evict fault, a
                # transient snapshot error) leaves the tenant RESIDENT
                # and serving — the budget stays over until the next
                # pressure event retries
                log.warning("eviction of %r aborted: %r", victim.name, exc)
                with self._lock:
                    e = self._entries.get(victim.name)
                    if e is not None and e.state == EVICTING:
                        e.state = RESIDENT
                        if e.busy_done is not None:
                            e.busy_done.set()
                            e.busy_done = None
                    self._release_evictor_locked(me)
                    self._update_gauges_locked()
                return evicted

    def _release_evictor_locked(self, me: int) -> None:
        if self._evictor == me:
            self._evictor = None
            self._evictor_done.set()

    def _over_budget_locked(self) -> bool:
        """Over the budget, counting the reservations of hydrations in
        flight as resident (their tenants are on their way in)."""
        cfg = self.config
        resident = sum(
            1 for e in self._entries.values()
            if e.state in (RESIDENT, EVICTING, HYDRATING)
        )
        if cfg.max_resident_filters and resident > cfg.max_resident_filters:
            return True
        reserved = sum(
            e.reserved for e in self._entries.values() if e.state == HYDRATING
        )
        if cfg.max_resident_bytes and (
            self._resident_bytes + reserved > cfg.max_resident_bytes
        ):
            return True
        return False

    def _pick_victim_locked(self, protect: Optional[str] = None) -> Optional[_Tenant]:
        if not self._over_budget_locked():
            return None
        now = time.monotonic()
        hl = self.config.heat_halflife_s
        svc = self._service
        candidates = [
            e for e in self._entries.values()
            if e.state == RESIDENT and e.name in svc._filters
            and e.name != protect
        ]
        if not candidates or (protect is None and len(candidates) <= 1):
            # without an explicit protectee, never evict the last
            # resident — the request that faulted it in is about to use
            # it. WITH one (the hydration path), evicting the only
            # other candidate is exactly right (budget-of-one paging).
            return None
        return min(candidates, key=lambda e: e.evict_rank(now, hl))

    def _evict(self, name: str) -> None:
        """One eviction: snapshot under the victim's op lock, unpublish,
        land a final durable checkpoint, file the blob WARM.

        Failure discipline: an exception BEFORE the unpublish aborts
        cleanly (ensure_budget reverts the entry to RESIDENT — the
        tenant keeps serving). From the unpublish on, the eviction is
        COMMITTED: everything after runs best-effort and the blob is
        ALWAYS filed, because a "revert" at that point would strand a
        tenant that is in neither the registry nor the warm pool."""
        svc = self._service
        faults.fire("storage.evict")
        mf = svc._filters.get(name)
        if mf is None:
            raise RuntimeError(f"victim {name!r} vanished before eviction")
        with mf.lock:
            if getattr(mf, "evicted", False):
                raise RuntimeError(f"victim {name!r} already evicted")
            _, _, blob = ckpt.snapshot_blob(
                mf.filter, extra={"repl_seq": mf.applied_seq}
            )
            applied = mf.applied_seq
            mf.evicted = True
            with svc._lock:  # declared: filter.op -> service.registry
                svc._filters.pop(name, None)
        # durable point: close the checkpointer with a final generation
        # stamped at the evicted seq (COLD-tier coverage + the
        # truncation floor). CLEAN fast path: a tenant that never
        # advanced past the durable floor it hydrated from (read-only
        # residency cycle) is already fully covered by the existing
        # generation — skip the write, keep the floor. Failure keeps
        # the WARM blob + the log tail (landed_seq stays at the last
        # generation that DID land).
        landed = None
        clean = (
            getattr(mf, "hydration_landed_seq", None) is not None
            and mf.hydration_landed_seq >= applied
        )
        if mf.checkpointer is not None:
            try:
                with mf.lock:  # exclude stragglers during the final snapshot
                    ok = mf.checkpointer.close(final_checkpoint=not clean)  # lint: allow(blocking-under-lock): the filter is already unpublished + flagged evicted — only stragglers briefly contend, exactly the DropFilter close discipline
            except Exception:  # noqa: BLE001 — eviction is committed
                ok = False
                log.exception("eviction of %r: checkpointer close failed", name)
            if ok:
                landed = applied
            else:
                # best KNOWN durable floor, not just this residency
                # cycle's: a hydrated tenant whose fresh checkpointer
                # never landed still has the generation it hydrated
                # from on disk — regressing to None would pin the whole
                # op log (and the blob WARM) for no reason
                cands = []
                meta = mf.checkpointer.last_landed_meta
                if meta is not None:
                    cands.append(int(meta.get("repl_seq") or 0))
                prior = getattr(mf, "hydration_landed_seq", None)
                if prior is not None:
                    cands.append(int(prior))
                landed = max(cands) if cands else None
                log.warning(
                    "eviction of %r: final checkpoint did not land (%r); "
                    "keeping the op-log tail past seq %s",
                    name, mf.checkpointer.last_error, landed,
                )
        with self._lock:
            e = self._entries.get(name)
            if e is None:
                # dropped concurrently — nothing to file
                return
            self._resident_bytes -= e.device_bytes
            e.last_bytes, e.device_bytes = e.device_bytes, 0
            e.applied_seq = applied
            e.landed_seq = landed
            e.blob, e.blob_bytes = blob, len(blob)
            self._warm_bytes += e.blob_bytes
            e.state = WARM
            if e.busy_done is not None:
                e.busy_done.set()
                e.busy_done = None
            self._trim_warm_locked()
            self._update_gauges_locked()
        obs_counters.incr("storage_evictions_total")
        obs_flight.note(
            "eviction", tenant=name, applied_seq=int(applied),
            landed_seq=None if landed is None else int(landed),
        )

    def _trim_warm_locked(self) -> None:
        """Warm-pool budget: demote the coldest fully-checkpoint-covered
        WARM tenants to COLD (drop the blob — the sink rebuilds it).
        Tenants whose durable tier lags their blob are pinned WARM:
        correctness beats the budget, the op log still covers the gap
        but a COLD restore would have to replay it per tenant."""
        budget = self.config.warm_pool_bytes
        if budget <= 0 or self._warm_bytes <= budget:
            return
        now = time.monotonic()
        hl = self.config.heat_halflife_s
        warm = sorted(
            (
                e for e in self._entries.values()
                if e.state == WARM and e.blob is not None
                and e.landed_seq is not None
                and e.landed_seq >= e.applied_seq
            ),
            key=lambda e: e.evict_rank(now, hl),
        )
        for e in warm:
            if self._warm_bytes <= budget:
                return
            self._warm_bytes -= e.blob_bytes
            e.blob, e.blob_bytes = None, 0
            e.state = COLD
            obs_counters.incr("storage_warm_demotions")

    # -- coordination hooks --------------------------------------------------

    def drain_busy(self, timeout: float = 30.0) -> None:
        """Block until no hydration/eviction is in flight — the
        demotion barrier's storage leg (see ``ha.promotion.
        become_replica``): a write that passed the READONLY fence may
        still be WAITING on a hydration, and the take-every-lock
        barrier only covers locks that exist. Poll-based on purpose
        (the caller holds ``service.promote``)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                busy = self._hydrating or any(
                    e.state in (HYDRATING, EVICTING)
                    for e in self._entries.values()
                )
            if not busy:
                return
            time.sleep(0.002)
        log.warning("storage drain_busy: %.0fs deadline hit", timeout)

    def _update_gauges_locked(self) -> None:
        counts = {RESIDENT: 0, EVICTING: 0, WARM: 0, COLD: 0, HYDRATING: 0}
        for e in self._entries.values():
            counts[e.state] += 1
        obs_counters.set_gauge(
            "storage_resident_filters",
            float(counts[RESIDENT] + counts[EVICTING]),
        )
        obs_counters.set_gauge(
            "storage_resident_bytes", float(self._resident_bytes)
        )
        obs_counters.set_gauge(
            "storage_warm_filters",
            float(counts[WARM] + counts[HYDRATING]),
        )
        obs_counters.set_gauge("storage_warm_bytes", float(self._warm_bytes))
        obs_counters.set_gauge("storage_cold_filters", float(counts[COLD]))
