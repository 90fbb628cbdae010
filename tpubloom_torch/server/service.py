"""The tpubloom gRPC server on the port: ``tpubloom/server/service.py``
with its filters on a CUDA card (or the CPU, when asked) and their
hand-written kernels (:mod:`tpubloom_torch.ops.sweep`).

Parity: where the reference's bottom layer is a Redis server holding the
bitmap and running Lua scripts (SURVEY.md §1 L5), this process holds the
bit arrays in device memory and runs the kernels. The Ruby front-end
talks to it through the ``:jax`` driver (clients/ruby) exactly as it talked
RESP to Redis; Python clients use :mod:`tpubloom_torch.server.client`.
The wire format, the method tables and every response field are
``tpubloom.server``'s, byte for byte.

Device: :class:`BloomService` takes ``device`` (None = the CUDA card; with
no card that is an error, never a quiet run on the CPU) and builds and
restores every filter there. ``Health`` reports ``backend`` ("cuda" or
"cpu") and the card's name under ``devices``.

The op log and replication (``oplog``, ``read_only`` with a
:class:`tpubloom_torch.repl.ReplicaApplier`, the sync quorum) and tenant
residency (``storage``) serve as in ``tpubloom``, and so does high
availability: ``Promote`` / ``ReplicaOf`` promote, demote and fence
through :mod:`tpubloom_torch.ha.promotion`, and the ``promote``
subcommand sends ``Promote``. So does cluster mode: ``cluster`` (a
:class:`tpubloom_torch.cluster.ClusterState`) or ``--cluster`` attaches
the slot map, and a migrating filter's snapshot is taken and installed on
this service's device (below).

Runtime properties:

* one lock per filter — ALL ops on a filter serialize, mirroring the
  single-threaded Redis command loop that gave the reference its race
  freedom (SURVEY.md §5 race-detection row). This is load-bearing, not
  just parity: inserts update the filter's tensor in place, so a
  lock-free concurrent query could gather from a half-updated state.
  Cross-filter parallelism is unaffected;
* per-filter async checkpointing with bounded lag (``checkpoint_every``);
* health + stats RPCs (gRPC health-check parity, SURVEY.md §5 failure row);
* graceful restart: on startup every configured filter restores its newest
  checkpoint.

Robustness:

* **overload shedding** — ``max_in_flight`` caps concurrently-executing
  data-plane RPCs; excess requests are rejected *before decode* with
  ``RESOURCE_EXHAUSTED`` + ``retry_after_ms`` instead of queueing toward
  OOM. ``Health`` (and the other cheap control-plane reads) never sheds,
  so the overload state stays observable;
* **health states** — ``Health`` reports ``SERVING`` / ``DEGRADED``
  (checkpoint write errors, corrupt checkpoint seen at restore, recent
  shedding) / ``DRAINING``, with machine-readable reasons;
* **graceful drain** — on SIGTERM the server stops admitting work
  (``DRAINING`` sheds), lets in-flight RPCs finish, takes a final
  checkpoint of every dirty filter, then exits;
* **retryable DeleteBatch** — a bounded rid→response dedup cache answers
  a replayed counting-filter delete from cache instead of
  double-decrementing (client retries reuse the logical call's rid);
* **fault points** — ``rpc.pre_handle`` / ``rpc.post_handle``
  (:mod:`tpubloom_torch.faults`) let the chaos suite simulate handler crashes
  and response-lost-after-apply without patching internals.

Replication (:mod:`tpubloom_torch.repl`):

* **op log** — with an :class:`tpubloom_torch.repl.OpLog` attached
  (``--repl-log-dir``), every mutating RPC appends one CRC32C-framed
  record at its commit point (under the filter's op lock, so log order
  equals apply order per filter). Startup replays the log over the
  restored checkpoints — per-filter ``repl_seq`` stamps in checkpoint
  headers gate the replay, so acked writes survive a crash even when
  the checkpoint lagged (AOF parity), and nothing applies twice.
  Checkpoint-keyed truncation keeps only the tail the checkpoints do
  not yet cover (bounded additionally by the slowest connected
  replica's cursor).
* **primary→replica streaming** — the ``ReplStream`` RPC
  (:mod:`tpubloom_torch.repl.primary`) serves full resyncs (live-filter
  snapshot blobs + log tail) and partial resyncs (cursor still in the
  log), PSYNC-style; connected replicas and their lag are gauges.
* **read replicas** — ``read_only=True`` (``--replica-of host:port``)
  rejects every mutating RPC with ``READONLY`` (Redis parity) while a
  :class:`tpubloom_torch.repl.ReplicaApplier` keeps local state in sync;
  reads/health/stats serve normally.
* **MONITOR parity** — the ``Monitor`` streaming RPC tails every
  finished request (optionally filtered per filter name) off the same
  commit points, via :class:`tpubloom_torch.repl.MonitorHub`.
* **adaptive retry hints** — shed responses carry a ``retry_after_ms``
  that grows with the observed shed rate (the measurable queue-pressure
  signal once the in-flight cap is pegged) and decays back to the
  configured base when the burst passes.

High availability (:mod:`tpubloom_torch.ha`):

* **promotion / demotion** — the ``Promote`` RPC (``REPLICAOF NO ONE``
  parity; also ``python -m tpubloom_torch.server promote host:port``) flips a
  replica to primary by adopting the op log and bumping the persisted
  **topology epoch**; ``ReplicaOf`` re-points (or demotes) a node. Both
  are epoch-stamped — stale epochs answer ``STALE_EPOCH`` (Raft term
  discipline), which is also how a restarted pre-failover primary gets
  fenced by a sentinel.
* **chained replicas** — ``--replica-of`` + ``--repl-log-dir`` together:
  applied records re-append to the local log in the upstream's seq
  space (:meth:`BloomService.reappend_record`), so this node serves
  ``ReplStream`` downstream and promotes in place.
* **epoch fencing on the data plane** — a mutating request stamped with
  an older topology epoch than this server's is rejected with
  ``STALE_EPOCH`` so topology-aware clients refresh instead of writing
  under a stale view.
* **replica durability** — with a state dir, the replication cursor
  (``repl_cursor.json``) and creation manifest persist; a replica
  restart restores filters from local checkpoints and PARTIAL-resyncs.

Synchronous replication (``WAIT`` / ``min-replicas-to-write``
parity):

* **replica acks** — replicas report their applied cursor back on a
  client-streaming ``ReplAck`` RPC (:func:`tpubloom_torch.repl.primary.
  repl_ack`); :class:`ReplicaSessions` tracks per-replica acked seqs
  (gauge ``repl_acked_seq{replica}``).
* **commit barrier** — with ``--min-replicas-to-write N`` (or a
  per-request ``min_replicas``), each mutating RPC blocks AFTER its
  op-log append, outside all locks, until N replicas acked the record
  (:meth:`BloomService.commit_barrier`); timeout →
  ``NOT_ENOUGH_REPLICAS`` (+ Health ``DEGRADED``), the local apply
  stands (Redis semantics — WAIT never rolls back).
* **Wait RPC** — Redis ``WAIT numreplicas timeout`` parity, keyed to
  the caller's last-write ``repl_seq``; returns the achieved count.
* a quorum-acked write is by construction on the most-caught-up
  replica, which is exactly the sentinel's promotion pick — so it
  survives a primary SIGKILL *without* the client rid re-drive.

Cluster mode (:mod:`tpubloom_torch.cluster`, Redis Cluster parity):

* **slot ownership on every keyed RPC** — with ``--cluster`` a
  :class:`tpubloom_torch.cluster.ClusterState` is attached and the wrapper
  checks ``key_slot(req["name"])`` before the handler: unowned slots
  answer ``MOVED <slot> <addr>``, migrating slots answer ``ASK`` for
  filters already handed off, importing slots serve only
  ``asking``-flagged requests, unassigned slots answer ``CLUSTERDOWN``;
* **live slot migration** — ``MigrateSlot`` streams each filter's
  snapshot blob + op-log tail to the new owner (the resync
  machinery node→node) with a dual-write window: after the snapshot,
  every committed mutating RPC on a migrating filter forwards to the
  target (original rid + source seq) BEFORE the client is acked, and
  the target's seq gate + rid dedup make re-deliveries exactly-once;
* **map admin** — ``ClusterSlots`` (client bootstrap), ``ClusterSetSlot``
  (marks + config-epoch-guarded ownership flips), driven by
  ``python -m tpubloom_torch.cluster`` (init / migrate / rebalance).
"""

from __future__ import annotations

import logging
import math
import threading
import time
import weakref
from collections import OrderedDict
from concurrent import futures
from contextlib import contextmanager
from typing import Optional

import grpc
import numpy as np
import torch

from tpubloom_torch import checkpoint as ckpt
from tpubloom_torch import faults
from tpubloom_torch.obs import counters as obs_counters
from tpubloom_torch.config import FilterConfig, IDENTITY_FIELDS, identity_mismatch
from tpubloom_torch.filter import BloomFilter, CountingBloomFilter, resolve_device
from tpubloom_torch.obs import context as obs
from tpubloom_torch.obs import blackbox as obs_blackbox
from tpubloom_torch.obs import flight as obs_flight
from tpubloom_torch.obs import trace as obs_trace
from tpubloom_torch.obs.slowlog import Slowlog, summarize_request
from tpubloom_torch.params import round_up_pow2
from tpubloom_torch.cluster import migrate as cluster_migrate
from tpubloom_torch.cluster import node as cluster_node
from tpubloom_torch.cluster import slots as cluster_slots
from tpubloom_torch.repl import monitor as repl_monitor
from tpubloom_torch.repl import primary as repl_primary
from tpubloom_torch.repl.replica import FullResyncNeeded
from tpubloom_torch.server import protocol
from tpubloom_torch.server import streams as server_streams
from tpubloom_torch.sketch import registry as sketch_registry
from tpubloom_torch.server.metrics import Metrics
from tpubloom_torch.utils import locks, tracing

log = logging.getLogger("tpubloom.server")


class _Managed:
    def __init__(self, filt, sink, checkpoint_every: int):
        import inspect

        self.filter = filt
        self.lock = locks.named_lock("filter.op")
        #: set (under ``lock``) when the storage tier evicted this
        #: filter out of the registry: a straggler that
        #: resolved the object before the eviction re-checks this flag
        #: after acquiring the lock (``BloomService._op``) and
        #: re-resolves through the hydration path instead of writing to
        #: detached device arrays
        self.evicted = False
        #: durable floor this filter hydrated from (set by the storage
        #: tier): lets a read-only residency cycle evict WITHOUT a
        #: fresh final checkpoint — see TenantStore._evict
        self.hydration_landed_seq = None
        #: newest op-log seq whose effect this filter's state contains —
        #: advanced at every logged commit, persisted into checkpoint
        #: headers (``repl_seq``), and used to gate replay/stream apply
        #: to exactly-once semantics
        self.applied_seq = 0
        # fused test-and-insert capability is a static property of the
        # filter class — probe once, not per InsertBatch request
        self.supports_presence = (
            "return_presence" in inspect.signature(filt.insert_batch).parameters
        )
        # the checkpointer reads applied_seq through a weak reference: a
        # closure over self would make a cycle (self -> checkpointer ->
        # meta_fn -> self) that holds an evicted or dropped filter's
        # device memory until Python's cyclic collector runs
        ref = weakref.ref(self)
        self.checkpointer = (
            ckpt.AsyncCheckpointer(
                filt,
                sink,
                every_n_inserts=checkpoint_every,
                meta_fn=lambda: {"repl_seq": ref().applied_seq},
            )
            if sink is not None
            else None
        )


#: RPCs that are never shed: Health must answer DURING overload or the
#: operator flies blind, the reads are cheap in-memory control-plane
#: lookups holding no device buffers, and the HA verbs (Promote /
#: ReplicaOf) must land on an overloaded cluster — a failover that can
#: be shed is not a failover.
#: Wait is deliberately NOT here: it parks a worker thread for up to its
#: timeout, so under overload it must count against --max-in-flight and
#: shed like any data-plane call (Redis WAIT is a normal command too) —
#: unsheddable Waits could exhaust the whole pool and starve Health.
#: The cluster verbs are control plane like the HA verbs: a
#: shed ClusterSlots blinds clients mid-redirect storm, and a shed
#: migration hop wedges a rebalance exactly when load made it urgent.
#: TraceGet joins the unsheddable control plane for the same
#: reason as Health: the trace of a slow request is most needed exactly
#: while the node is overloaded, and the lookup is a cheap in-memory
#: ring read holding no device buffers.
UNSHEDDABLE = frozenset(
    {"Health", "ListFilters", "SlowlogGet", "SlowlogReset", "TraceGet",
     "Promote", "ReplicaOf",
     "ClusterSlots", "ClusterSetSlot", "MigrateSlot", "MigrateInstall"}
)

#: How long after the last shed Health keeps reporting the "shedding"
#: degraded reason — long enough for a scraper/prober to catch a burst.
SHED_DEGRADED_WINDOW_S = 5.0

#: Adaptive retry_after_ms: the shed-pressure term
#: decays with this time constant, and the hint never exceeds
#: base * RETRY_AFTER_CAP_FACTOR.
PRESSURE_DECAY_S = 1.0
RETRY_AFTER_CAP_FACTOR = 32

#: Commit-point appends between checkpoint-keyed log-truncation sweeps.
TRUNCATE_EVERY_APPENDS = 64


class _TenantPagedRace(Exception):
    """A create/drop hydrated its tenant first, but an eviction paged it
    back out before the registry lock was taken. The caller
    re-hydrates and retries — building a FRESH filter (or answering
    ``existed: False``) over paged state would silently lose it."""

#: Default commit-barrier / Wait budget when neither the server flag nor
#: the request provides one (ms).
DEFAULT_MIN_REPLICAS_MAX_LAG_MS = 1000

#: A Wait RPC with timeout_ms<=0 would block a worker thread forever
#: (Redis WAIT 0 semantics); clamp to this ceiling instead.
WAIT_TIMEOUT_CAP_S = 60.0

class BloomService:
    """Method handlers; state = {name: _Managed}."""

    def __init__(
        self,
        sink_factory=None,
        *,
        slowlog_capacity: int = 128,
        max_in_flight: Optional[int] = None,
        retry_after_ms: int = 50,
        dedup_capacity: int = 1024,
        oplog=None,
        read_only: bool = False,
        epoch: Optional[int] = None,
        repl_batch_bytes: Optional[int] = None,
        listen_address: Optional[str] = None,
        min_replicas_to_write: int = 0,
        min_replicas_max_lag_ms: int = DEFAULT_MIN_REPLICAS_MAX_LAG_MS,
        cluster=None,
        coalesce=None,
        storage=None,
        trace_sample=None,
        device=None,
    ):
        """``sink_factory(config) -> sink|None`` decides where each filter
        checkpoints (None disables persistence for that filter).
        ``max_in_flight`` caps concurrently-executing sheddable RPCs
        (None/0 = unbounded); shed responses carry a ``retry_after_ms``
        hint that starts at the configured base and grows with the shed
        rate. ``dedup_capacity`` bounds the rid→response replay cache
        that makes DeleteBatch (and non-idempotent InsertBatch) safely
        retryable (0 disables it). ``oplog`` attaches a
        :class:`tpubloom_torch.repl.OpLog` (this process becomes a replication
        primary + AOF-durable); ``read_only=True`` makes it a replica
        (mutating RPCs answer ``READONLY``).

        ``min_replicas_to_write`` (Redis ``min-replicas-to-
        write`` parity) gates every mutating RPC behind a durability
        quorum: after the op-log append the handler blocks until that
        many replicas have ACKED the record's seq, for at most
        ``min_replicas_max_lag_ms`` — timeout answers
        ``NOT_ENOUGH_REPLICAS`` (Redis ``NOREPLICAS``). Requests may
        demand a STRONGER per-call quorum via ``min_replicas``.

        ``device`` is where every filter is built and restored: None is
        the CUDA card (and an error without one), ``"cpu"`` runs the plain
        PyTorch versions. ``cluster`` attaches a
        :class:`tpubloom_torch.cluster.ClusterState` (slot ownership on
        every keyed RPC, live slot migration)."""
        #: the device every filter of this service lives on, with its
        #: index pinned here: the replica's applier and the coalescer's
        #: dispatcher build and launch from threads of their own
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        #: distributed tracing: a float arms the process
        #: trace ring at that deterministic per-rid sample rate (0.0 =
        #: only forced / slowlog-worthy requests); None (the default)
        #: keeps tracing fully off — no wire fields, no per-request
        #: buffering, no measurable overhead
        if trace_sample is not None:
            obs_trace.configure(sample=float(trace_sample))
        #: last Health status answered — the flight recorder dumps on
        #: the SERVING -> DEGRADED flip
        self._last_health_status = "SERVING"
        self._filters: dict[str, _Managed] = {}
        self._lock = locks.named_lock("service.registry")
        self._sink_factory = sink_factory or (lambda config: None)
        self.metrics = Metrics()
        self.slowlog = Slowlog(capacity=slowlog_capacity)
        self.max_in_flight = max_in_flight
        self.retry_after_ms = retry_after_ms
        self._in_flight = 0
        self._admit_lock = locks.named_lock("service.admit")
        self._draining = False
        self._last_shed_time = 0.0
        #: decaying shed-rate pressure (events, half-life ~PRESSURE_DECAY_S)
        #: — the adaptive component of retry_after_ms
        self._shed_pressure = 0.0
        self._pressure_updated = time.monotonic()
        self._dedup_capacity = dedup_capacity
        self._dedup: "OrderedDict[str, dict]" = OrderedDict()
        self._dedup_lock = locks.named_lock("service.dedup")
        #: filter name -> time a corrupt checkpoint was detected during its
        #: restore; cleared once a good checkpoint lands after that moment
        self._ckpt_corrupt_seen: dict[str, float] = {}
        # -- replication --
        self.oplog = oplog
        self.read_only = read_only
        self.repl_sessions = repl_primary.ReplicaSessions()
        # -- synchronous replication --
        #: server-wide durability quorum for mutating RPCs (0 = asynchronous
        #: replication); per-request ``min_replicas`` can
        #: only strengthen it
        self.min_replicas_to_write = int(min_replicas_to_write or 0)
        #: how long the commit barrier (and a default Wait) blocks for
        #: the quorum before giving up
        self.min_replicas_max_lag_ms = int(min_replicas_max_lag_ms)
        #: last time a commit barrier timed out — Health reports
        #: DEGRADED ("not_enough_replicas") for a window after
        self._last_quorum_fail_time = 0.0
        self.monitor_hub = repl_monitor.MonitorHub()
        #: set by ReplicaApplier when this process follows a primary
        self.replica_applier = None
        self.primary_address: Optional[str] = None
        #: True while replay_oplog runs — replayed ops must not re-append
        self._replaying = False
        #: per-thread record-seq hint for handlers invoked via
        #: apply_record (replay / replica stream apply): ``_log_op``
        #: returns None there, but the response a handler caches in the
        #: rid-dedup MUST still carry the record's original ``repl_seq``
        #: — a dedup-replayed answer without it would e.g. forward a
        #: migration dual-write WITHOUT its ``src_seq``, bypassing the
        #: target's exactly-once gate (a real double-apply, found by the
        #: SIGKILL chaos test)
        self._apply_seq_hint = threading.local()
        self._appends_since_truncate = 0
        # -- high availability --
        #: topology epoch (Raft-term discipline): bumped+persisted at
        #: every promotion; stale Promote/ReplicaOf/epoch-stamped writes
        #: are rejected with STALE_EPOCH
        from tpubloom_torch.ha.topology import EpochStore

        self._epoch_store = (
            EpochStore(oplog.directory) if oplog is not None else None
        )
        self.epoch = (
            int(epoch)
            if epoch is not None
            else (self._epoch_store.load() if self._epoch_store else 0)
        )
        obs_counters.set_gauge("ha_epoch", float(self.epoch))
        obs_counters.set_gauge("ha_role", 1.0 if read_only else 0.0)
        # crash-forensics black box: stamp the node identity
        # into the mapped ring (a no-op record when the box is
        # disarmed) — every record written after this carries the
        # current topology epoch, the fleet merge's primary sort key
        obs_blackbox.set_node_meta(
            epoch=self.epoch,
            role="replica" if read_only else "primary",
        )
        #: serializes role transitions (Promote / ReplicaOf)
        self._promote_lock = locks.named_lock("service.promote")
        #: where the creation manifest lives (the op log dir on nodes
        #: with a log; a replica's durable state dir otherwise)
        self._manifest_dir: Optional[str] = (
            oplog.directory if oplog is not None else None
        )
        #: coalesce ReplStream records up to this many raw bytes per
        #: zlib frame for replicas that negotiated the capability
        self.repl_batch_bytes = repl_batch_bytes
        #: this server's announced address (sentinel/replica discovery)
        self.listen_address = listen_address
        #: replica-side cursor persistence (set by main()/become_replica)
        self.replica_state_store = None
        #: True while the local op log is fed by a ReplicaApplier
        #: (reappend_record preserves the upstream seq space) — handler-
        #: side appends are suppressed then, or they would mint
        #: conflicting seqs. Deliberately NOT the read_only flag: an
        #: in-flight write that raced a demotion past the READONLY check
        #: must still log (become_replica drains those before attaching
        #: the applier), or its ack silently vanishes from the log.
        self._stream_fed = read_only
        #: cluster mode: a
        #: :class:`tpubloom_torch.cluster.ClusterState` — slot map, ownership
        #: checks, migration forwards. None = single-shard (the
        #: pre-cluster behavior, no per-request overhead).
        self.cluster = cluster
        #: set (repr of the exception) when an op-log append fails AFTER
        #: its op applied in memory — state is now ahead of the log, so
        #: further writes are fail-stopped (Redis aborts writes on AOF
        #: write errors the same way) until an operator restarts
        self.oplog_error: Optional[str] = None
        #: ingestion coalescer: with a
        #: :class:`tpubloom_torch.server.ingest.CoalesceConfig` attached,
        #: concurrent InsertBatch/QueryBatch RPCs park in per-filter
        #: queues and flush as ONE device launch + ONE op-log append +
        #: ONE commit barrier. None = the direct per-request path.
        self._coalescer = None
        if coalesce is not None:
            from tpubloom_torch.server.ingest import IngestCoalescer

            self._coalescer = IngestCoalescer(self, coalesce).start()
        #: tiered residency manager: with a
        #: :class:`tpubloom_torch.storage.StorageConfig` attached, the flat
        #: registry becomes a registry/storage pair — ``_filters`` holds
        #: only the RESIDENT tier, cold-ranked filters are evicted under
        #: the HBM budget into host-RAM blobs / checkpoints, and
        #: :meth:`_get` lazily re-hydrates on first RPC. None = every
        #: filter resident for the process lifetime (the single-tier
        #: behavior, no per-request overhead).
        self.storage = None
        if storage is not None:
            from tpubloom_torch.storage import TenantStore

            self.storage = TenantStore(self, storage)

    @property
    def draining(self) -> bool:
        return self._draining

    # -- helpers -------------------------------------------------------------

    def _get(self, name: str) -> _Managed:
        mf = self._filters.get(name)
        if mf is not None:
            return mf
        if self.storage is not None:
            # paging fault: a WARM/COLD tenant hydrates here
            # — the caller blocks on the hydration future, so the RPC
            # wrapper and the ingest coalescer's flush path both see
            # either the whole filter or NOT_FOUND, never a torn one.
            # On the replay/stream-apply path the resolve is CONTROL
            # plane: a handler dispatched by apply_record must never be
            # quota-shed (replication progress beats data-plane
            # pressure), including its _op re-resolve after an eviction
            # race.
            mf = self.storage.resolve(name, control_plane=self._applying())
            if mf is not None:
                return mf
        raise protocol.BloomServiceError(
            "NOT_FOUND", f"filter {name!r} does not exist"
        )

    def _resident(self, name: str) -> Optional[_Managed]:
        """Registry lookup for apply/replay/admin paths: hydrates paged
        tenants on the CONTROL plane (no quota sheds — replication and
        replay must make progress regardless of data-plane pressure);
        None for unknown names."""
        mf = self._filters.get(name)
        if mf is None and self.storage is not None:
            mf = self.storage.resolve(name, control_plane=True)
        return mf

    def has_filter(self, name: str) -> bool:
        """Tenant existence across BOTH tiers (resident + paged) — what
        the cluster wrapper's ASK decision and ListFilters must see:
        an evicted tenant still exists."""
        return name in self._filters or (
            self.storage is not None and self.storage.has(name)
        )

    def _applying(self) -> bool:
        """True on the op-log replay / stream-apply path."""
        return self._replaying or (
            getattr(self._apply_seq_hint, "seq", None) is not None
        )

    @contextmanager
    def _op(self, name: str, *, write: bool = False):
        """Resolve + lock one filter, healing the lookup→evict race:
        a handler that resolved its ``_Managed`` before a
        concurrent eviction unpublished it would otherwise mutate
        detached device arrays the eviction blob missed — an acked
        write that silently vanishes. After acquiring the op lock the
        ``evicted`` flag is re-checked and a stale object re-resolves
        through the hydration path. ``write=True`` additionally
        re-checks the replica write fence UNDER the lock: a write that
        passed the wrapper's READONLY check but then waited out a
        hydration must not apply after a demotion flipped the role
        (the take-every-lock barrier only covers locks that exist)."""
        while True:
            mf = self._get(name)
            with mf.lock:
                if mf.evicted:
                    continue
                if write and self.read_only and not self._applying():
                    raise protocol.BloomServiceError(
                        "READONLY",
                        f"write to {name!r} rejected: this server became "
                        f"a read-only replica — send writes to the primary",
                        details=(
                            {"primary": self.primary_address}
                            if self.primary_address
                            else None
                        ),
                    )
                yield mf
                return

    def shed_hint(self) -> int:
        """Adaptive retry_after_ms for shed decisions taken OUTSIDE the
        admission gate (the storage tier's hydration quotas)
        — same pressure signal, same Health "shedding" window."""
        with self._admit_lock:
            self._last_shed_time = time.time()
            return self._bump_shed_pressure()

    # -- admission control (overload shedding + drain) -----------------------

    def admit(self, method: str) -> Optional[dict]:
        """Admission decision for one RPC, taken BEFORE the request is even
        decoded (a shed must cost microseconds, not a msgpack parse).

        Returns None when admitted — the caller MUST pair it with
        :meth:`release` — or a ready-to-encode error response when the
        request is shed (draining, or the in-flight cap is hit)."""
        if method in UNSHEDDABLE:
            return None
        with self._admit_lock:
            if self._draining:
                shed_code, shed_msg = "DRAINING", "server is draining"
            elif self.max_in_flight and self._in_flight >= self.max_in_flight:
                shed_code = "RESOURCE_EXHAUSTED"
                shed_msg = (
                    f"in-flight cap {self.max_in_flight} reached; retry with "
                    f"backoff"
                )
            else:
                self._in_flight += 1
                return None
            self._last_shed_time = time.time()
            retry_ms = self._bump_shed_pressure()
        self.metrics.count("requests_shed")
        # flight recorder: sheds are the first lifecycle
        # signal a post-mortem wants — noted outside the admit lock
        obs_flight.note(
            "shed", method=method, code=shed_code, retry_after_ms=retry_ms
        )
        return protocol.error_response(
            shed_code, shed_msg, details={"retry_after_ms": retry_ms}
        )

    def _bump_shed_pressure(self) -> int:
        """Adaptive retry hint (caller holds ``_admit_lock``): the first
        shed of a burst answers the configured base; each further shed
        while the pressure has not decayed grows the hint, so a thundering
        herd spreads itself out instead of re-colliding — with the
        in-flight cap pegged, the shed rate IS the queue-depth signal."""
        now = time.monotonic()
        self._shed_pressure *= math.exp(
            -(now - self._pressure_updated) / PRESSURE_DECAY_S
        )
        self._pressure_updated = now
        hint = self.retry_after_ms * (1.0 + self._shed_pressure)
        self._shed_pressure += 1.0
        hint = int(min(hint, self.retry_after_ms * RETRY_AFTER_CAP_FACTOR))
        obs_counters.set_gauge("retry_after_ms_current", hint)
        return hint

    def release(self, method: str) -> None:
        if method in UNSHEDDABLE:
            return
        with self._admit_lock:
            self._in_flight -= 1

    def begin_drain(self) -> None:
        """Stop admitting data-plane work (Health keeps answering, now
        reporting DRAINING); in-flight requests run to completion."""
        with self._admit_lock:
            self._draining = True

    # -- synchronous replication: commit barrier + Wait ------------

    def commit_barrier(self, req: dict, resp: dict) -> dict:
        """Durability gate for one mutating RPC, run by the wrapper AFTER
        the handler returned (so no filter/registry lock is held while
        blocking). The quorum target is the server's
        ``min_replicas_to_write`` or the request's ``min_replicas``,
        whichever is STRONGER; 0 (the default) is a no-op.

        The write has already applied and its record is in the op log —
        ``resp["repl_seq"]`` names it. Block until the quorum acked that
        seq; on timeout raise ``NOT_ENOUGH_REPLICAS`` (Redis
        ``NOREPLICAS``) with ``details={acked, needed, seq, applied:
        True}``: the op is NOT rolled back (Redis WAIT semantics — the
        local apply stands), the caller just knows it is not yet
        quorum-durable. A retry under the same rid answers from the
        dedup cache / seq gates and RE-WAITS on the same record instead
        of double-applying."""
        needed = max(
            self.min_replicas_to_write, int(req.get("min_replicas") or 0)
        )
        if needed <= 0:
            return resp
        seq = resp.get("repl_seq")
        if seq is None:
            if self.oplog is None:
                # without an op log there is no record a replica could
                # ever ack — refuse loudly rather than return a
                # durability ack the topology cannot honor
                raise protocol.BloomServiceError(
                    "NOT_ENOUGH_REPLICAS",
                    f"min_replicas={needed} requires replication (start "
                    f"the server with --repl-log-dir)",
                    details={"acked": 0, "needed": needed, "applied": True},
                )
            # logged nothing because the call was a NO-OP (exist_ok
            # create of an existing filter, drop of a missing one):
            # there is no new record to make durable, so the quorum has
            # nothing to say about it
            return resp
        timeout_ms = req.get("min_replicas_timeout_ms")
        if timeout_ms is None:  # explicit 0 = probe: fail unless already acked
            # the lag budget doubles as the default wait budget — but a
            # budget of 0 means the freshness gate is DISABLED (Redis
            # min-replicas-max-lag 0), not "probe every write": fall
            # back to the stock budget so quorum writes still wait
            timeout_ms = (
                self.min_replicas_max_lag_ms or DEFAULT_MIN_REPLICAS_MAX_LAG_MS
            )
        timeout_ms = int(timeout_ms)
        connected = self.repl_sessions.count()
        if connected < needed:
            # Redis min-replicas-to-write parity: with fewer replicas
            # even CONNECTED than the quorum needs, waiting is futile —
            # fail fast so an isolated primary rejects writes in
            # microseconds, not after every barrier timeout
            self._quorum_failed(needed, 0)
            raise protocol.BloomServiceError(
                "NOT_ENOUGH_REPLICAS",
                f"durability quorum needs {needed} replica(s), only "
                f"{connected} connected",
                details={"acked": 0, "needed": needed, "seq": seq,
                         "connected": connected, "applied": True},
            )
        t0 = time.perf_counter()
        # freshness gate (Redis min-replicas-max-lag parity):
        # a replica only counts toward the quorum while its last ack
        # FRAME is within the lag budget — an acked-then-silent replica
        # is history, not durability. The barrier runs outside every
        # lock (note_blocking in wait_acked enforces that at runtime).
        max_age_s = self.min_replicas_max_lag_ms / 1000.0
        acked = self.repl_sessions.wait_acked(
            seq, needed, timeout_ms / 1000.0, require_connected=needed,
            max_age=max_age_s,
        )
        self.metrics.observe_wait(time.perf_counter() - t0)
        if acked < needed:
            self._quorum_failed(needed, acked)
            details = {"acked": acked, "needed": needed, "seq": seq,
                       "timeout_ms": timeout_ms, "applied": True}
            stale = self.repl_sessions.count_acked(seq) - acked
            if stale > 0:
                # the seq IS acked somewhere, just not freshly — name
                # the distinction so operators chase the silent replica,
                # not a replication gap
                self.metrics.count("quorum_stale_acks", stale)
                details["stale_acks"] = stale
            raise protocol.BloomServiceError(
                "NOT_ENOUGH_REPLICAS",
                f"only {acked}/{needed} replica(s) freshly acked seq {seq} "
                f"within {timeout_ms}ms",
                details=details,
            )
        self.metrics.count("quorum_writes_acked")
        resp["acked_replicas"] = acked
        return resp

    def _quorum_failed(self, needed: int, acked: int) -> None:
        self._last_quorum_fail_time = time.time()
        self.metrics.count("quorum_write_failures")
        log.warning(
            "commit barrier: %d/%d replica ack(s) — write applied "
            "locally but is not quorum-durable", acked, needed,
        )

    def Wait(self, req: dict) -> dict:
        """Redis ``WAIT numreplicas timeout`` parity: block until
        ``numreplicas`` replicas have acknowledged every record up to
        ``seq`` (the caller's last write — clients send the ``repl_seq``
        their last mutating response carried; default: the current log
        head), then answer ``{nreplicas}`` — the count actually acked,
        even when short of the target (WAIT reports, it does not
        error). ``numreplicas=0`` answers immediately with the current
        count — the cheap durability probe."""
        if self.read_only:
            raise protocol.BloomServiceError(
                "UNSUPPORTED",
                "WAIT is a primary-side command (this server is a "
                "replica)",
            )
        seq = req.get("seq")
        if seq is None:
            seq = self.oplog.last_seq if self.oplog is not None else 0
        numreplicas = int(req.get("numreplicas") or 0)
        timeout_ms = req.get("timeout_ms")
        if timeout_ms is None:
            timeout_ms = self.min_replicas_max_lag_ms
        timeout_ms = int(timeout_ms)
        timeout_s = (
            WAIT_TIMEOUT_CAP_S
            if timeout_ms <= 0  # Redis WAIT-0 "forever", capped
            else min(WAIT_TIMEOUT_CAP_S, timeout_ms / 1000.0)
        )
        t0 = time.perf_counter()
        acked = self.repl_sessions.wait_acked(int(seq), numreplicas, timeout_s)
        if numreplicas > 0:
            self.metrics.observe_wait(time.perf_counter() - t0)
        return {
            "ok": True,
            "nreplicas": acked,
            "seq": int(seq),
            "epoch": self.epoch,
        }

    # -- high availability: epoch + chained re-append --------------

    def adopt_epoch(self, epoch: int) -> None:
        """Advance (never rewind) the topology epoch, persisting when a
        store is attached. Raft's term rule: whoever has seen the higher
        epoch is right about the topology."""
        if epoch <= self.epoch:
            return
        self.epoch = int(epoch)
        if self._epoch_store is not None:
            try:
                self._epoch_store.store(self.epoch)
            except OSError:
                log.exception("epoch persist failed (non-fatal)")
        obs_counters.set_gauge("ha_epoch", float(self.epoch))
        # keep the black box's epoch stamp current — the
        # post-mortem timeline orders by epoch before wall clock
        obs_blackbox.set_node_meta(epoch=self.epoch)

    def reappend_record(self, rec: dict) -> None:
        """Chained replica: re-append one upstream record VERBATIM to the
        local op log (same seq space — what makes mid-chain promotion
        cheap and lets this node serve ``ReplStream`` downstream).
        Raises ValueError on a seq gap (caller full-resyncs)."""
        if self.oplog is None or self._replaying:
            return
        faults.fire("repl.reappend")
        if self.oplog.append_record(rec):
            obs_counters.incr("repl_records_reappended")
            # checkpoint-keyed truncation must run here too — on a
            # replica, _log_op (the primary-side sweep driver) never
            # fires, and an unswept chained log grows without bound
            self._appends_since_truncate += 1
            if self._appends_since_truncate >= TRUNCATE_EVERY_APPENDS:
                self._appends_since_truncate = 0
                self._maybe_truncate_log()

    def Promote(self, req: dict) -> dict:
        """Replica→primary promotion RPC (``REPLICAOF NO ONE`` parity):
        adopt the op log, bump+persist the topology epoch, start taking
        writes and serving ``ReplStream``. Idempotent on a primary;
        ``epoch`` (optional) pins the sentinel-agreed epoch and stale
        values are rejected with ``STALE_EPOCH``."""
        from tpubloom_torch.ha import promotion

        return promotion.promote_to_primary(
            self,
            repl_log_dir=req.get("repl_log_dir"),
            epoch=req.get("epoch"),
        )

    def ReplicaOf(self, req: dict) -> dict:
        """Redis ``REPLICAOF`` parity: ``{"primary": "host:port"}``
        re-points (or demotes) this server to replicate from the given
        primary; ``primary`` absent/``"NO ONE"`` promotes instead.
        Epoch-stamped like Promote."""
        from tpubloom_torch.ha import promotion

        primary = req.get("primary")
        if primary is None or (
            isinstance(primary, str)
            and primary.strip().upper() in ("", "NO ONE")
        ):
            return promotion.promote_to_primary(
                self,
                repl_log_dir=req.get("repl_log_dir"),
                epoch=req.get("epoch"),
            )
        return promotion.become_replica(self, primary, epoch=req.get("epoch"))

    # -- cluster mode: slot map, migration -------------------------

    def _require_cluster(self):
        if self.cluster is None:
            raise protocol.BloomServiceError(
                "CLUSTER_DISABLED",
                "this server is not running in cluster mode (start it "
                "with --cluster)",
            )
        return self.cluster

    def ClusterSlots(self, req: dict) -> dict:
        """Redis ``CLUSTER SLOTS`` parity: the node's slot-map view —
        what cluster clients build their slot→shard cache from. A
        non-cluster server answers ``enabled: false`` so mixed fleets
        stay probeable."""
        if self.cluster is None:
            return {"ok": True, "enabled": False, "epoch": 0, "ranges": []}
        return {"ok": True, "enabled": True, **self.cluster.describe()}

    def ClusterSetSlot(self, req: dict) -> dict:
        """Redis ``CLUSTER SETSLOT`` parity plus the bulk ``assign``
        form (see :meth:`tpubloom_torch.cluster.ClusterState.set_slot`)."""
        return self._require_cluster().set_slot(req)

    def MigrateSlot(self, req: dict) -> dict:
        """Drive the live migration of one slot to ``target`` (source
        side; synchronous like Redis ``MIGRATE``)."""
        self._require_cluster()
        if self.read_only:
            raise protocol.BloomServiceError(
                "READONLY", "MigrateSlot must run on the shard primary"
            )
        return cluster_migrate.migrate_slot(
            self, int(req["slot"]), req.get("target")
        )

    def MigrateInstall(self, req: dict) -> dict:
        """Target side of a slot migration: adopt one filter's snapshot
        blob for an importing slot (or answer a resume probe). The
        ``src_seq`` stamp seeds the exactly-once import gate the
        dual-write forwards are checked against."""
        cluster = self._require_cluster()
        if self.read_only:
            raise protocol.BloomServiceError(
                "READONLY", "MigrateInstall must run on the shard primary"
            )
        faults.fire("cluster.migrate_apply")
        name = req["name"]
        slot = cluster_slots.key_slot(name)
        if not cluster.is_importing(slot):
            raise protocol.BloomServiceError(
                "NOT_IMPORTING",
                f"slot {slot} is not importing on this node — mark it "
                f"with ClusterSetSlot first",
                details={"slot": slot},
            )
        if req.get("probe"):
            base = cluster.gate_base(name)
            have = base if (name in self._filters and base is not None) else None
            return {"ok": True, "have": have}
        src_seq = int(req["src_seq"])
        self.install_migrated(name, req["blob"])
        cluster.seed_gate(name, src_seq)
        self.metrics.count("cluster_migrate_installs")
        return {"ok": True, "name": name, "src_seq": src_seq}

    def install_migrated(self, name: str, blob: bytes) -> None:
        """Adopt a migrating filter's snapshot on the new owner. Unlike
        the replica-side :meth:`install_snapshot`, this runs on a
        PRIMARY: the create is op-logged with a ``restored_seq`` marker
        — this shard's replicas cannot rebuild the blob's bytes from
        records, so applying that record full-resyncs them (the resync
        machinery), which carries the installed state."""
        mf = self._managed_from_blob(blob)
        create_req = self._manifest_req_for(name, mf.filter)
        with self._lock:
            old = self._filters.pop(name, None)
            # log BEFORE publishing (same rule as CreateFilter): a
            # concurrent forward on the new filter must not log below
            # the create record's seq
            self._log_op(
                "CreateFilter",
                {**create_req, "exist_ok": True, "restored_seq": -1},
                mf,
                may_truncate=False,
            )
            self._filters[name] = mf
            self._manifest_put(name, create_req)
        if old is not None and old.checkpointer:
            old.checkpointer.close(final_checkpoint=False)
        if mf.checkpointer:
            # seed a durable generation NOW: this node's restart replay
            # can only rebuild the filter from a local checkpoint — the
            # blob's bytes exist in no record stream
            with mf.lock:
                mf.checkpointer.trigger()
        if self.storage is not None:
            self.storage.note_created(name)
            self.storage.ensure_budget()

    # -- replication: op log, apply, snapshots ---------------------

    def _log_op(
        self,
        method: str,
        req: dict,
        mf: Optional[_Managed] = None,
        *,
        may_truncate: bool = True,
    ) -> Optional[int]:
        """Append one committed mutating op to the op log (no-op without
        a log, during replay, and on replicas — a chained replica's log
        is fed by :meth:`reappend_record`, which preserves the upstream
        seq space; handler-side appends would mint conflicting seqs).
        MUST be called while still holding the lock the op committed
        under — log order is apply order. ``may_truncate=False`` for
        callers holding ``self._lock`` (Create/Drop): the truncation
        sweep re-takes it and the lock is not re-entrant — their sweep
        runs on a later data-plane append. Returns the record's seq
        (``None`` when nothing was logged) — what the commit barrier
        blocks on and what mutating responses echo as ``repl_seq``."""
        if self.oplog is None or self._replaying or self._stream_fed:
            hint = getattr(self._apply_seq_hint, "seq", None)
            if mf is not None and hint is not None:
                # apply path (replay / stream apply): advance the
                # filter's seq stamp HERE, under the op lock the commit
                # runs under — a checkpoint triggered by this record's
                # own notify_inserts must stamp it, and an eviction
                # serialized after this lock section snapshots state
                # that truly CONTAINS the record.
                # (apply_record's old lock-free pre-advance let a
                # concurrent eviction stamp a seq whose effect was
                # absent — a SIGKILL after that checkpoint landed
                # would gate the record out of replay: acked write
                # durably lost.)
                mf.applied_seq = max(mf.applied_seq, hint)
            return None
        tref = obs_trace.request_ref()
        if tref is not None:
            # trace propagation through the log: replicas
            # and migration tail-replays capture this record's apply
            # regardless of their own sample rate, parented under the
            # committing request's (or flush's) root span. Handlers
            # ignore the extra key on replay; the copy keeps the
            # caller's dict untouched.
            req = {**req, "trace": {"forced": True, "span": tref[1]}}
        try:
            seq = self.oplog.append(method, req, rid=obs.current_rid())
        except Exception as e:
            # the op ALREADY applied in memory: this process is now ahead
            # of its own log. Fail-stop further writes (reads keep
            # serving) — silently continuing would diverge replicas and
            # crash-replay state with no signal.
            self.oplog_error = repr(e)
            obs_counters.incr("repl_log_append_errors")
            log.exception(
                "op log append failed for %s — write path fail-stopped",
                method,
            )
            # the "fatal" flight-recorder case: the process
            # is about to stop accepting writes — dump the lifecycle
            # ring NOW, best-effort (note touches only the declared
            # filter.op -> obs.counters edge; the dump's file IO is
            # acceptable here — this path already does log IO under
            # the same lock, and it runs once, on the way down)
            obs_flight.note("oplog_failstop", method=method, error=repr(e))
            obs_flight.dump("fatal")
            # msync the black box too: SIGKILL-safety needs
            # nothing, but a fail-stop may precede a machine going down
            obs_blackbox.sync()
            # and freeze the rings: the ring is an
            # overwrite buffer — if the process limps on serving reads,
            # healthy traffic would lap the lead-up to the fail-stop
            obs_blackbox.snapshot_rings("oplog-failstop")
            raise
        if mf is not None:
            mf.applied_seq = seq
        self._appends_since_truncate += 1
        if may_truncate and self._appends_since_truncate >= TRUNCATE_EVERY_APPENDS:
            self._appends_since_truncate = 0
            self._maybe_truncate_log()
        return seq

    def _maybe_truncate_log(self) -> None:
        """Checkpoint-keyed log GC: records every filter's newest LANDED
        checkpoint already covers are replayable from checkpoints alone
        and can go — bounded by the slowest connected replica's cursor so
        a live stream never loses its tail (backlog parity)."""
        oplog = self.oplog
        if oplog is None:
            return
        with self._lock:
            mfs = list(self._filters.values())
        safe = oplog.last_seq  # no filters: empty state replays from nothing
        for mf in mfs:
            if mf.checkpointer is None:
                return  # unpersisted filter: its whole history must stay
            meta = mf.checkpointer.last_landed_meta
            if meta is None:
                return  # nothing landed yet for this filter
            safe = min(safe, int(meta.get("repl_seq") or 0))
        if self.storage is not None:
            # paged tenants bound GC exactly like resident
            # ones: a WARM/COLD tenant's records past its durable
            # checkpoint must survive a SIGKILL (its host-RAM blob does
            # not), and one with NO durable generation pins the whole
            # log — the same rule as an unpersisted resident filter
            paged_floor = self.storage.truncate_floor()
            if paged_floor is None:
                return
            safe = min(safe, paged_floor)
        replica_floor = self.repl_sessions.min_cursor()
        if replica_floor is not None:
            safe = min(safe, replica_floor)
        if oplog.truncate_to(safe):
            self.metrics.count("repl_log_truncations")

    def apply_record(self, rec: dict) -> bool:
        """Apply one op-log record (startup replay on a primary, stream
        apply on a replica); True iff it changed state, False when the
        per-filter seq gate proved the effect already present. Exactly
        the idempotence the acceptance test pins: killing a stream
        mid-batch and replaying the records cannot double-apply."""
        faults.fire("repl.apply")
        method, seq = rec["method"], rec["seq"]
        req = dict(rec["req"])
        if rec.get("rid"):
            req["rid"] = rec["rid"]
        name = req.get("name")
        if method == "CreateFilter":
            restored_seq = req.pop("restored_seq", None)
            mf = self._filters.get(name)
            if mf is not None and mf.applied_seq >= seq:
                return False
            if self.read_only:
                if restored_seq is not None:
                    # the primary bootstrapped this filter from a
                    # checkpoint generation the replica does not have —
                    # no sequence of records reproduces those bytes
                    raise FullResyncNeeded(name)
                # a FRESH create on the primary must be fresh here too:
                # restore-on-create would resurrect the replica's own
                # stale local checkpoint of a previous same-name filter
                req["restore"] = False
            self.CreateFilter({**req, "exist_ok": True})
            mf = self._filters.get(name)
            if mf is not None:
                mf.applied_seq = max(mf.applied_seq, seq)
            return True
        if method == "DropFilter":
            # hydrate-first: the NEWER-than-this-drop seq
            # gate below must judge the real filter, not skip because
            # the tenant happens to be paged out
            mf = self._resident(name)
            if mf is not None and mf.applied_seq >= seq:
                # the live filter is NEWER than this drop (a full-resync
                # snapshot installed the re-created filter): dropping it
                # would delete state the later records cannot rebuild
                return False
            return bool(self.DropFilter(req).get("existed"))
        # storage-aware lookup: a record for an EVICTED
        # tenant hydrates it first — on a replica, stream apply must
        # land on the real state, not skip as "unknown filter"
        mf = self._resident(name)
        if mf is None:
            log.warning(
                "op-log record seq %d (%s) names unknown filter %r; skipped",
                seq, method, name,
            )
            return False
        if mf.applied_seq >= seq:
            return False
        # the seq stamp advances inside the handler's _log_op call,
        # UNDER the op lock (see there) — before notify_inserts, so a
        # checkpoint the handler triggers stamps THIS record's seq, and
        # an eviction serialized against the same lock can never
        # snapshot the stamp before the record's effect is applied
        prev = mf.applied_seq
        self._apply_seq_hint.seq = seq
        try:
            getattr(self, method)(req)
        except Exception:
            mf.applied_seq = prev
            raise
        finally:
            self._apply_seq_hint.seq = None
        # exactly-once across restarts for COALESCED replay-unsafe
        # writes: a merged record logs under the FLUSH rid,
        # so replaying it used to leave the parked requests' own rids
        # out of the dedup cache — a client re-driving an applied-but-
        # unacked frame after a crash would double-apply. The record's
        # ``parts`` name each constituent; re-seed one cached response
        # per part so a same-rid replay answers from cache. (On a
        # promoted replica this protects post-failover re-drives too.)
        for part in req.get("parts") or ():
            try:
                part_rid, part_n = part[0], int(part[1])
            except (TypeError, ValueError, IndexError):
                continue
            if part_rid:
                self._dedup_put(
                    part_rid, {"ok": True, "n": part_n, "repl_seq": seq}
                )
        return True

    def replay_oplog(self) -> dict:
        """Startup replay (primary with ``--repl-log-dir``): re-drive
        every logged op over the checkpoint-restored state. The
        per-filter ``repl_seq`` gates make this idempotent — AOF parity:
        acked writes newer than the last checkpoint come back."""
        if self.oplog is None:
            return {"applied": 0, "skipped": 0, "failed": 0}
        applied = skipped = failed = 0
        restored_from_manifest = 0
        self._replaying = True
        try:
            # manifest first: filters whose CreateFilter record was
            # truncated away (covered by a landed checkpoint) come back
            # via restore-on-create before the record tail replays
            for name, create_req in (self._manifest_read() or {}).items():
                try:
                    self.CreateFilter(
                        {**create_req, "exist_ok": True, "restore": True}
                    )
                    restored_from_manifest += 1
                except Exception:
                    log.exception(
                        "op-log manifest: re-creating filter %r failed", name
                    )
                    failed += 1
            for rec in self.oplog.read_from(0):
                try:
                    if self.apply_record(rec):
                        applied += 1
                    else:
                        skipped += 1
                except Exception:
                    log.exception(
                        "op-log replay: record seq %d (%s) failed",
                        rec.get("seq"), rec.get("method"),
                    )
                    failed += 1
        finally:
            self._replaying = False
        if self.storage is not None:
            # replay forced every manifest tenant resident (records can
            # only apply to live filters); page back down to the HBM
            # budget ONCE now instead of thrashing per record
            self.storage.ensure_budget()
        self.metrics.count("repl_replay_applied", applied)
        return {
            "applied": applied,
            "skipped": skipped,
            "failed": failed,
            "restored_from_manifest": restored_from_manifest,
        }

    def snapshot_plan(self):
        """Full-resync payload: ``(names, iterator, plan_seq)`` from ONE
        registry snapshot — the iterator lazily yields ``(name, blob,
        applied_seq)`` per filter, each snapshot taken under its op lock
        so the blob and its seq stamp are consistent. Lazy on purpose: a
        blob can be filter-sized, so only one is in flight at a time
        (the stream sends it before the next is built).

        ``plan_seq`` is the log head read under the registry lock —
        creates commit (log + publish) under that same lock, so every
        record for a filter OUTSIDE ``names`` has ``seq > plan_seq``.
        The resync tail cursor must be clamped to it: per-filter
        ``applied_seq`` stamps taken later can run ahead of the plan and
        would otherwise skip those creates."""
        with self._lock:
            items = list(self._filters.items())
            plan_seq = self.oplog.last_seq if self.oplog is not None else 0
        # paged tenants stream too — a bootstrapping replica
        # must receive the WHOLE tenant set, and paging them in just to
        # stream them out would churn the hot set; their loaders answer
        # from the warm pool / the sink at send time
        paged = (
            self.storage.paged_plan_items(exclude={n for n, _ in items})
            if self.storage is not None
            else []
        )

        def gen():
            for name, mf in items:
                with mf.lock:
                    # an mf evicted between plan and send still works:
                    # the object is a consistent snapshot of its state
                    # at eviction, and every later record streams from
                    # the log tail — same story as any other filter
                    _, _, blob = ckpt.snapshot_blob(mf.filter)
                    applied_seq = mf.applied_seq
                yield name, blob, applied_seq
            for name, load in paged:
                blob, applied_seq = load()
                yield name, blob, applied_seq

        names = [name for name, _ in items] + [name for name, _ in paged]
        return names, gen(), plan_seq

    def install_snapshot(self, name: str, blob: bytes, applied_seq: int) -> None:
        """Replica bootstrap: adopt a primary's filter snapshot wholesale
        (config comes from the blob header — the primary's config IS the
        truth), replacing any local filter of that name."""
        mf = self._managed_from_blob(blob, applied_seq)
        with self._lock:
            old = self._filters.pop(name, None)
            self._filters[name] = mf
            # a replica with durable state (cursor persistence)
            # must be able to restore this filter at restart too
            self._manifest_put(name, self._manifest_req_for(name, mf.filter))
        if old is not None and old.checkpointer:
            old.checkpointer.close(final_checkpoint=False)
        if self.storage is not None:
            self.storage.note_created(name)
            self.storage.ensure_budget()
        self.metrics.count("repl_snapshots_installed")

    def retain_only(self, names) -> None:
        """Post-full-resync: a resync is a state reset, so filters the
        primary no longer has must go (their checkpoints stay in the
        local sink untouched)."""
        keep = set(names)
        with self._lock:
            victims = [
                (n, mf) for n, mf in self._filters.items() if n not in keep
            ]
            for n, _ in victims:
                del self._filters[n]
                self._manifest_remove(n)
        for n, mf in victims:
            if mf.checkpointer:
                mf.checkpointer.close(final_checkpoint=False)
        if self.storage is not None:
            # paged tenants the primary no longer has must go too
            self.storage.retain_only(names)

    # -- storage tier: hydration builders -------------------------

    def _config_of(self, create_req: dict) -> FilterConfig:
        """The (base) FilterConfig a manifest-shaped create request
        describes — what the storage tier keys sinks by."""
        req = dict(create_req)
        name = req["name"]
        if req.get("scalable"):
            base, _ = self._parse_scalable(req, name)
            return base
        return self._parse_config(req, name)

    def _managed_from_blob(self, blob: bytes, applied_seq=0) -> _Managed:
        """Rebuild a ``_Managed`` from one snapshot blob — the blob's
        stored config is the truth. The single recipe behind WARM
        hydration, replica snapshot installs, and migration
        installs."""
        filt = ckpt.restore_blob(blob, device=self.device)
        config = filt.base_config if hasattr(filt, "layers") else filt.config
        sink = self._sink_factory(config)
        mf = _Managed(filt, sink, getattr(config, "checkpoint_every", 0))
        mf.applied_seq = int(applied_seq or 0)
        return mf

    def _managed_from_sink(self, name: str, create_req) -> _Managed:
        """COLD hydration: restore the newest durable checkpoint
        generation (the eviction path landed one stamped at the evicted
        ``applied_seq``, so no op-log tail needs replaying here — every
        later write hydrated first by construction)."""
        req = dict(create_req or {})
        req["name"] = name
        if req.get("scalable"):
            base, policy = self._parse_scalable(req, name)
            sink = self._sink_factory(base)
            restored = (
                self._tracked_restore(
                    name, base, sink,
                    scalable_expect=policy, expect_scalable=True,
                )
                if sink is not None
                else None
            )
            config = base
        else:
            config = self._parse_config(req, name)
            sink = self._sink_factory(config)
            restored = (
                self._tracked_restore(name, config, sink, expect_scalable=False)
                if sink is not None
                else None
            )
        if restored is None:
            raise protocol.BloomServiceError(
                "INTERNAL",
                f"cold tenant {name!r} has no restorable checkpoint "
                f"generation — hydration impossible (durable tier lost?)",
            )
        mf = _Managed(restored, sink, config.checkpoint_every)
        mf.applied_seq = int(
            getattr(restored, "_restored_meta", {}).get("repl_seq", 0) or 0
        )
        return mf

    # -- RPC handlers (dict in, dict out) ------------------------------------

    def _health_reasons(self) -> list:
        """Machine-readable degraded reasons (empty = healthy)."""
        reasons = []
        with self._lock:
            filters = list(self._filters.items())
        for name, mf in filters:
            if mf.checkpointer is None:
                self._ckpt_corrupt_seen.pop(name, None)
                continue
            if mf.checkpointer.last_error is not None:
                reasons.append(f"checkpoint_error:{name}")
            seen = self._ckpt_corrupt_seen.get(name)
            if seen is not None:
                landed = mf.checkpointer.last_checkpoint_time
                if landed is not None and landed > seen:
                    # a good generation has been written since the corrupt
                    # one was quarantined — the degradation is over
                    self._ckpt_corrupt_seen.pop(name, None)
                else:
                    reasons.append(f"checkpoint_corrupt:{name}")
        if time.time() - self._last_shed_time < SHED_DEGRADED_WINDOW_S:
            reasons.append("shedding")
        if self.min_replicas_to_write > 0:
            connected = self.repl_sessions.count()
            if connected < self.min_replicas_to_write:
                # an isolated primary under min-replicas-to-write is
                # refusing writes RIGHT NOW — the operator must see why
                reasons.append(
                    f"min_replicas:{connected}/{self.min_replicas_to_write}"
                )
        if time.time() - self._last_quorum_fail_time < SHED_DEGRADED_WINDOW_S:
            reasons.append("not_enough_replicas")
        ra = self.replica_applier
        if ra is not None and ra.link not in ("connected", "syncing"):
            # a replica serving reads off a dead link is serving stale
            # data — say so, machine-readably
            reasons.append(f"replication_link:{ra.link}")
        if self.oplog_error is not None:
            reasons.append("oplog_append_error")
        return reasons

    def _device_names(self) -> list:
        """Health's ``devices``: the card's name per visible card on a
        CUDA service, the device's own name otherwise."""
        if self.device.type == "cuda":
            return [
                torch.cuda.get_device_name(i)
                for i in range(torch.cuda.device_count())
            ]
        return [str(self.device)]

    def Health(self, req: dict) -> dict:
        reasons = self._health_reasons()
        if self._draining:
            status = "DRAINING"
        elif reasons:
            status = "DEGRADED"
        else:
            status = "SERVING"
        # flight recorder: health flips are lifecycle
        # events, and the SERVING -> DEGRADED flip is one of the
        # moments a post-mortem needs the ring ON DISK — the process
        # may be about to get killed by its orchestrator. The flip
        # check-and-set runs under the admit lock (taken right below
        # anyway) so concurrent Health probes agree on ONE flip — one
        # note, one dump; the note/dump themselves run outside it.
        with self._admit_lock:
            in_flight = self._in_flight
            prev = self._last_health_status
            flipped = status != prev
            self._last_health_status = status
        if flipped:
            obs_flight.note(
                "health", status=status, previous=prev,
                reasons=list(reasons),
            )
            if status == "DEGRADED":
                obs_flight.dump("degraded")
                obs_blackbox.sync()
                # snapshot the rings too: the live
                # rings keep overwriting oldest-first, so the history
                # LEADING UP to this incident would be gone by the time
                # anyone looks — freeze a copy next to them (bounded)
                obs_blackbox.snapshot_rings("degraded")
        resp = {
            "ok": True,
            "status": status,
            "reasons": reasons,
            "backend": self.device.type,
            "devices": self._device_names(),
            "filters": len(self._filters),
            "in_flight": in_flight,
            "max_in_flight": self.max_in_flight,
            "role": "replica" if self.read_only else "primary",
            "epoch": self.epoch,
            # wire-encoding capability advertisement: clients
            # negotiate the zero-copy `fixed` key encoding off this
            "encodings": list(protocol.ENCODINGS),
        }
        if self.listen_address:
            resp["listen"] = self.listen_address
        if self.storage is not None:
            resp["storage"] = self.storage.summary()
        if self.cluster is not None:
            resp["cluster"] = self.cluster.summary()
        if self.replica_applier is not None and self.read_only:
            resp["replication"] = self.replica_applier.status()
            if self.oplog is not None:  # chained: serves downstream too
                resp["replication"]["log"] = self.oplog.stats()
                resp["replication"]["replicas"] = (
                    self.repl_sessions.describe()
                )
        elif self.oplog is not None:
            resp["replication"] = {
                "log": self.oplog.stats(),
                "replicas": self.repl_sessions.describe(),
            }
        return resp

    @staticmethod
    def _parse_config(req: dict, name: str) -> FilterConfig:
        if "config" in req:
            return FilterConfig.from_dict({**req["config"], "key_name": name})
        return FilterConfig.from_capacity(
            req["capacity"], req["error_rate"], key_name=name,
            **req.get("options", {}),
        )

    @staticmethod
    def _parse_scalable(req: dict, name: str):
        """``req["scalable"]`` (truthy; optionally ``{"growth", "tightening"}``)
        -> (base template FilterConfig, growth-policy dict)."""
        sc = req.get("scalable")
        sc = sc if isinstance(sc, dict) else {}
        if req.get("capacity") is None or req.get("error_rate") is None:
            raise protocol.BloomServiceError(
                "INVALID_ARGUMENT",
                "scalable filters are sized by capacity + error_rate",
            )
        opts = dict(req.get("options", {}))
        # template m is a placeholder (layers derive their own) but must
        # satisfy config validation for blocked layouts
        m0 = max(64, int(opts.get("block_bits") or 0))
        base = FilterConfig(m=m0, k=1, key_name=name, **opts)
        policy = {
            "capacity": int(req["capacity"]),
            "error_rate": float(req["error_rate"]),
            "growth": int(sc.get("growth", 2)),
            "tightening": float(sc.get("tightening", 0.5)),
        }
        return base, policy

    @staticmethod
    def _policy_of(filt) -> dict:
        """Growth-policy dict of a live scalable filter (response echo +
        exist_ok comparison)."""
        return {
            "capacity": filt.capacity,
            "error_rate": filt.error_rate,
            "growth": filt.growth,
            "tightening": filt.tightening,
        }

    def _tracked_restore(self, name: str, config, sink, **kwargs):
        """checkpoint.restore, but remember when the walk had to skip
        corrupt generations for this filter — Health reports the filter
        DEGRADED until a good checkpoint lands after that moment."""
        before = obs_counters.get("ckpt_corrupt_detected")
        restored = ckpt.restore(config, sink, device=self.device, **kwargs)
        if obs_counters.get("ckpt_corrupt_detected") > before:
            self._ckpt_corrupt_seen[name] = time.time()
            self.metrics.count("restores_with_corrupt_generations")
        return restored

    def CreateFilter(self, req: dict) -> dict:  # lint: allow(replay-safety): replay converges on state (a retried create finds the filter registered and never double-builds); exist_ok attaches idempotently, a bare-create retry answers EXISTS — loud, not corrupting. No per-request device state to cache
        for _ in range(4):
            if self.storage is not None:
                # page a WARM/COLD tenant in FIRST: exist_ok
                # attaches and config-mismatch checks must compare
                # against the real filter — a bare-create over paged
                # state would otherwise silently rebuild it empty
                self.storage.resolve(req["name"], control_plane=True)
            try:
                resp = self._create(req)
            except _TenantPagedRace:
                continue  # evicted between hydrate and registry lock
            if self.storage is not None and resp.get("ok"):
                self.storage.note_created(req["name"])
                self.storage.ensure_budget()
            return resp
        raise protocol.BloomServiceError(
            "INTERNAL",
            f"create of {req['name']!r} kept racing evictions — retry",
        )

    def _create(self, req: dict) -> dict:
        name = req["name"]
        want_scalable = bool(req.get("scalable"))
        with self._lock:
            if name in self._filters:
                existing_filt = self._filters[name].filter
                existing = existing_filt.config
                existing_scalable = hasattr(existing_filt, "layers")
                if req.get("exist_ok", False):
                    # Attaching to an existing filter must mean the SAME
                    # filter — a silent mismatch would e.g. pour 1e8 keys
                    # into a 1e3-capacity array while the caller believes
                    # it requested 1% FPR. A bare attach (no config/capacity
                    # given) adopts the existing config as-is.
                    has_params = "config" in req or req.get("capacity") is not None
                    if (want_scalable or has_params) and (
                        want_scalable != existing_scalable
                    ):
                        raise protocol.BloomServiceError(
                            "CONFIG_MISMATCH",
                            f"filter {name!r} exists as "
                            f"{'scalable' if existing_scalable else 'fixed-size'}, "
                            f"requested {'scalable' if want_scalable else 'fixed-size'}",
                        )
                    if want_scalable:
                        # verify every parameter the request actually
                        # carries (a bare attach carries none; the stock
                        # client always transmits growth/tightening, so
                        # a changed default is caught even w/o capacity)
                        sc = req.get("scalable")
                        sc = sc if isinstance(sc, dict) else {}
                        requested = {}
                        if req.get("capacity") is not None:
                            requested["capacity"] = int(req["capacity"])
                        if req.get("error_rate") is not None:
                            requested["error_rate"] = float(req["error_rate"])
                        if "growth" in sc:
                            requested["growth"] = int(sc["growth"])
                        if "tightening" in sc:
                            requested["tightening"] = float(sc["tightening"])
                        live = self._policy_of(existing_filt)
                        field = next(
                            (f for f, v in requested.items() if live[f] != v),
                            None,
                        )
                        if field is None and req.get("options"):
                            opts = dict(req["options"])
                            m0 = max(64, int(opts.get("block_bits") or 0))
                            base = FilterConfig(m=m0, k=1, key_name=name, **opts)
                            field = identity_mismatch(
                                existing, base,
                                ckpt.IDENTITY_FIELDS_SCALABLE + ("key_len",),
                            )
                        if field is not None:
                            raise protocol.BloomServiceError(
                                "CONFIG_MISMATCH",
                                f"scalable filter {name!r} exists with a "
                                f"different {field}",
                            )
                    elif has_params:
                        config = self._parse_config(req, name)
                        field = identity_mismatch(
                            existing, config, IDENTITY_FIELDS + ("key_len",)
                        )
                        if field is not None:
                            raise protocol.BloomServiceError(
                                "CONFIG_MISMATCH",
                                f"filter {name!r} exists with {field}="
                                f"{getattr(existing, field)}, requested "
                                f"{getattr(config, field)}",
                            )
                    resp = {
                        "ok": True,
                        "existed": True,
                        "config": existing.to_dict(),
                    }
                    if existing_scalable:
                        resp["scalable"] = self._policy_of(existing_filt)
                    return resp
                raise protocol.BloomServiceError(
                    "ALREADY_EXISTS", f"filter {name!r} exists"
                )
            if self.storage is not None and self.storage.has(name):
                # not in the registry, but the storage tier KNOWS the
                # tenant: it was evicted between the caller's hydrate
                # and this lock — never rebuild fresh over paged state
                raise _TenantPagedRace(name)
            if want_scalable:
                return self._create_scalable(req, name)
            config = self._parse_config(req, name)
            sink = self._sink_factory(config)
            restored = None
            if sink is not None and req.get("restore", True):
                try:
                    restored = self._tracked_restore(  # lint: allow(blocking-under-lock): create/drop commit points must serialize under the registry lock, and restore-on-create IS this create's commit; creates are control-plane-rare
                        name, config, sink, expect_scalable=False
                    )
                except ValueError as e:
                    raise protocol.BloomServiceError("CKPT_MISMATCH", str(e))
            if restored is not None:
                filt = restored
            elif sketch_registry.is_sketch(config):
                # sketch kinds construct through the kind registry — the
                # same factory checkpoint._build_filter restores through,
                # so the two can never diverge
                filt = sketch_registry.build(config, self.device)
            elif config.shards > 1:
                # handles flat/blocked x plain/counting layouts (the same
                # routing order as checkpoint.restore — the two MUST agree
                # or a restart would reinterpret checkpoint bytes under a
                # different position spec). On the card: one slot per
                # visible card; elsewhere one slot on the device
                from tpubloom_torch.parallel.sharded import ShardedBloomFilter

                filt = ShardedBloomFilter(
                    config,
                    None if self.device.type == "cuda" else [self.device],
                )
            elif config.counting and config.block_bits:
                from tpubloom_torch.filter import BlockedCountingBloomFilter

                filt = BlockedCountingBloomFilter(config, self.device)
            elif config.counting:
                filt = CountingBloomFilter(config, self.device)
            elif config.block_bits:
                from tpubloom_torch.filter import BlockedBloomFilter

                filt = BlockedBloomFilter(config, self.device)
            else:
                filt = BloomFilter(config, self.device)
            mf = _Managed(filt, sink, config.checkpoint_every)
            mf.applied_seq = int(
                getattr(filt, "_restored_meta", {}).get("repl_seq", 0) or 0
            )
            # log BEFORE publishing: _get reads _filters lock-free, so a
            # concurrent insert on the new filter must not be able to log
            # a seq below the create record's
            seq = self._log_create(req, mf, restored)
            self._filters[name] = mf
            self.metrics.count("filters_created")
            resp = {
                "ok": True,
                "existed": False,
                "restored_seq": getattr(filt, "_restored_seq", None),
                "config": config.to_dict(),
            }
            if seq is not None:
                resp["repl_seq"] = seq
            return resp

    def _log_create(self, req: dict, mf: _Managed, restored) -> Optional[int]:
        """Op-log a landed CreateFilter (+ the creation manifest). A
        create that bootstrapped state from a checkpoint is stamped
        ``restored_seq`` — replicas cannot reproduce those bytes from
        records, so applying such a record triggers a full resync (the
        snapshot carries the state)."""
        logged = {k: v for k, v in req.items()
                  if k not in ("rid", "min_replicas",
                               "min_replicas_timeout_ms",
                               "asking", "src_seq", "epoch")}
        if restored is not None:
            logged["restored_seq"] = getattr(restored, "_restored_seq", None)
        seq = self._log_op("CreateFilter", logged, mf, may_truncate=False)
        self._manifest_put(req["name"], {k: v for k, v in logged.items()
                                         if k != "restored_seq"})
        return seq

    # -- creation manifest ---------------------------------------------------
    #
    # Checkpoint-keyed truncation may drop a live filter's CreateFilter
    # record while newer records for it remain in the log (the create is
    # covered by a landed checkpoint; the tail is not). Replay would then
    # skip those records as "unknown filter" — losing acked writes. The
    # manifest is the durable live-filter set next to the log: replay
    # re-creates (restore=True, pulling the covering checkpoint) from it
    # FIRST, then drives the record tail over that.

    def _manifest_path(self) -> Optional[str]:
        if self._manifest_dir is None:
            return None
        import os

        return os.path.join(self._manifest_dir, "manifest.json")

    @staticmethod
    def _manifest_req_for(name: str, filt) -> dict:
        """Reconstruct a CreateFilter request from a LIVE filter — for
        manifest entries with no original request at hand (snapshot-
        installed filters on replicas, manifest rebuild at promotion)."""
        if hasattr(filt, "layers"):  # scalable
            base = filt.base_config.to_dict()
            opts = {
                k: v for k, v in base.items() if k not in ("m", "k", "key_name")
            }
            return {
                "name": name,
                "capacity": filt.capacity,
                "error_rate": filt.error_rate,
                "options": opts,
                "scalable": {
                    "growth": filt.growth,
                    "tightening": filt.tightening,
                },
            }
        return {"name": name, "config": filt.config.to_dict()}

    def rebuild_manifest(self) -> None:
        """Rewrite the creation manifest from the live filter set — a
        promotion that opened a FRESH log dir must seed it with the
        filters the replica already holds, or a later restart's replay
        would not know to restore them."""

        def mutate(manifest: dict) -> None:
            manifest.clear()
            with self._lock:
                items = list(self._filters.items())
            for name, mf in items:
                manifest[name] = self._manifest_req_for(name, mf.filter)
            if self.storage is not None:
                # paged tenants exist too: a promotion that
                # dropped them from the manifest would lose them at the
                # next restart's replay
                for name, req in self.storage.create_reqs().items():
                    manifest.setdefault(name, req)

        self._manifest_write(mutate)

    def _manifest_put(self, name: str, create_req: dict) -> None:
        self._manifest_write(lambda m: m.__setitem__(name, create_req))

    def _manifest_remove(self, name: str) -> None:
        self._manifest_write(lambda m: m.pop(name, None))

    def _manifest_write(self, mutate) -> None:
        """Read-mutate-write the manifest atomically (callers hold
        ``self._lock``, which serializes create/drop commit points)."""
        path = self._manifest_path()
        if path is None or self._replaying:
            return
        import json
        import os

        try:
            manifest = self._manifest_read() or {}
            mutate(manifest)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(manifest, f)
            os.replace(tmp, path)
        except Exception:
            log.exception("op-log creation manifest write failed")

    def _manifest_read(self) -> Optional[dict]:
        path = self._manifest_path()
        if path is None:
            return None
        import json
        import os

        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                return json.load(f)
        except Exception:
            log.exception("op-log creation manifest unreadable; ignoring")
            return None

    def _create_scalable(self, req: dict, name: str) -> dict:
        """Scalable-filter CreateFilter branch (caller holds self._lock).

        Parity: the scalable/layered filter is the reference's Lua-lineage
        capability (SURVEY.md §2.3); serving + restore-on-create makes it a
        first-class server citizen like the fixed-size variants."""
        from tpubloom_torch.scalable import ScalableBloomFilter

        base, policy = self._parse_scalable(req, name)
        sink = self._sink_factory(base)
        restored = None
        if sink is not None and req.get("restore", True):
            try:
                restored = self._tracked_restore(
                    name, base, sink,
                    scalable_expect=policy, expect_scalable=True,
                )
            except ValueError as e:
                raise protocol.BloomServiceError("CKPT_MISMATCH", str(e))
        if restored is not None:
            filt = restored
        else:
            filt = ScalableBloomFilter(
                policy["capacity"],
                policy["error_rate"],
                config=base,
                growth=policy["growth"],
                tightening=policy["tightening"],
                device=self.device,
            )
        mf = _Managed(filt, sink, base.checkpoint_every)
        mf.applied_seq = int(
            getattr(filt, "_restored_meta", {}).get("repl_seq", 0) or 0
        )
        seq = self._log_create(req, mf, restored)  # before publish — see CreateFilter
        self._filters[name] = mf
        self.metrics.count("filters_created")
        resp = {
            "ok": True,
            "existed": False,
            "restored_seq": getattr(filt, "_restored_seq", None),
            "config": base.to_dict(),
            "scalable": policy,
        }
        if seq is not None:
            resp["repl_seq"] = seq
        return resp

    def DropFilter(self, req: dict) -> dict:  # lint: allow(replay-safety): replay converges — a retried drop of the now-missing name answers {existed: False}, which clients already treat as success (drop of missing is a no-op by contract)
        for _ in range(4):
            if self.storage is not None:
                # page in first: the drop must log + take its
                # final checkpoint over the REAL state, and a paged
                # tenant must not answer {existed: False}
                self.storage.resolve(req["name"], control_plane=True)
            try:
                # the storage entry is forgotten INSIDE _drop's registry
                # critical section — forgetting after the lock released
                # would race a concurrent re-create of the same name and
                # delete the NEW tenant's entry
                return self._drop(req)
            except _TenantPagedRace:
                continue  # evicted between hydrate and registry lock
        raise protocol.BloomServiceError(
            "INTERNAL",
            f"drop of {req['name']!r} kept racing evictions — retry",
        )

    def _drop(self, req: dict) -> dict:
        seq = None
        with self._lock:
            mf = self._filters.pop(req["name"], None)
            if (
                mf is None
                and self.storage is not None
                and self.storage.has(req["name"])
            ):
                # evicted between the caller's hydrate and this lock —
                # a paged tenant must not answer {existed: False}
                raise _TenantPagedRace(req["name"])
            if mf is not None:
                # inside the lock: a concurrent CreateFilter of the same
                # name must not log its create before this drop
                seq = self._log_op(
                    "DropFilter",
                    {k: v for k, v in req.items()
                     if k not in ("rid", "min_replicas",
                                  "min_replicas_timeout_ms",
                                  "asking", "src_seq", "epoch")},
                    may_truncate=False,
                )
                self._manifest_remove(req["name"])
                if self.storage is not None:
                    # under the registry lock — a re-create of the same
                    # name serializes AFTER this forget (see DropFilter)
                    self.storage.forget(req["name"])
        if mf is None:
            return {"ok": True, "existed": False}
        if mf.checkpointer:
            final = req.get("final_checkpoint", True)
            with mf.lock:  # exclude donating inserts during the final snapshot
                landed = mf.checkpointer.close(final_checkpoint=final)  # lint: allow(blocking-under-lock): the filter is already unpublished from the registry — only straggler in-flight RPCs contend, and they must not donate mid-snapshot
            if final and not landed:
                # the filter is gone from memory either way — the caller
                # asked for a durability point and must know it was missed
                raise protocol.BloomServiceError(
                    "CKPT_FAILED",
                    "final checkpoint did not land: "
                    + repr(mf.checkpointer.last_error),
                )
        resp = {"ok": True, "existed": True}
        if seq is not None:
            resp["repl_seq"] = seq
        return resp

    def ListFilters(self, req: dict) -> dict:
        with self._lock:
            names = set(self._filters)
        if self.storage is not None:
            # evicted tenants still exist — paging is transparent
            names.update(self.storage.names())
        return {"ok": True, "filters": sorted(names)}

    # -- keyed-batch helpers: fixed wire encoding + coalescing ----

    @staticmethod
    def _fixed_rows(req: dict):
        """``uint8[n, width]`` view of a request's ``keys_fixed`` buffer
        (zero-copy — ``np.frombuffer`` over the decoded msgpack bin), or
        None for msgpack-list requests."""
        fx = protocol.fixed_keys(req)
        if fx is None:
            return None
        data, width, n = fx
        return np.frombuffer(data, np.uint8).reshape(n, width)

    @classmethod
    def _keys_list(cls, req: dict) -> list:
        """Materialized key list under either encoding — the fallback
        for paths that need per-key bytes (presence, key_policy,
        filters without a packed API)."""
        keys = req.get("keys")
        if keys is not None:
            return keys
        rows = cls._fixed_rows(req)
        if rows is None:
            return []
        return [rows[i].tobytes() for i in range(rows.shape[0])]

    @staticmethod
    def _op_keys(req: dict) -> dict:
        """The key payload for this request's op-log record, in its
        original encoding (replay + replica apply handle both)."""
        if "keys" in req:
            return {"keys": req["keys"]}
        return {"keys_fixed": req["keys_fixed"]}

    @staticmethod
    def _staged_ok(mf: _Managed) -> bool:
        """Whether the filter may take the staged/packed fast paths.
        Single-chip filters always may; sharded filters may too —
        their staged overrides fire the per-shard ``shard.*``
        fault points themselves and stage a REPLICATED H2D split from
        the shard_map launch (``staged_fault_points`` marks that the
        raw launch no longer bypasses the chaos surface)."""
        return hasattr(mf.filter, "stage_batch") and (
            getattr(mf.filter.config, "shards", 1) <= 1
            or getattr(mf.filter, "staged_fault_points", False)
        )

    @classmethod
    def _packed_ok(cls, mf: _Managed, rows) -> bool:
        """Whether the fixed-width rows can take the filter's zero-copy
        packed path (keys wider than key_len fall back to the list path
        so ``key_policy`` applies there)."""
        return (
            rows is not None
            and cls._staged_ok(mf)
            and hasattr(mf.filter, "insert_packed")
            and rows.shape[1] <= getattr(mf.filter.config, "key_len", 0)
        )

    def _coalesce_eligible(self, req: dict, method: str = "InsertBatch") -> bool:
        """Whether this request may park in the ingestion coalescer.
        Excluded: replay/stream-apply (exactly-once is seq-gated per
        RECORD there), the dispatcher's own fallback re-drives, and
        migration forwards (``asking``/``src_seq`` must hit the import
        gate per-request). ``Clear`` carries no key payload and is
        eligible bare (delete/clear coalesce too)."""
        c = self._coalescer
        if c is None or not c.running or c.in_dispatcher():
            return False
        if self._replaying or getattr(self._apply_seq_hint, "seq", None) is not None:
            return False
        if req.get("asking") or req.get("src_seq") is not None:
            return False
        if method != "Clear" and not isinstance(
            req.get("keys"), list
        ) and not isinstance(req.get("keys_fixed"), dict):
            return False
        return True

    @staticmethod
    def _insert_replay_unsafe(mf: _Managed, want_presence: bool) -> bool:
        """True when a REPLAYED insert that already landed would corrupt
        the answer: counting filters scatter-ADD (double-increment),
        scalable filters double-count layer fill, and a presence replay
        reports the batch's own keys as pre-existing. These answer
        retries from the rid cache instead (the same
        machinery that makes DeleteBatch retryable). Sketch kinds carry
        their own classification in the kind registry:
        multiset cuckoo adds and CMS increments both corrupt on replay."""
        return bool(
            want_presence
            or getattr(mf.filter.config, "counting", False)
            or hasattr(mf.filter, "layers")
            or sketch_registry.replay_unsafe_insert(mf.filter.config)
        )

    def InsertBatch(self, req: dict) -> dict:
        mf = self._get(req["name"])
        want_presence = bool(req.get("return_presence"))
        replay_unsafe = self._insert_replay_unsafe(mf, want_presence)
        rid = req.get("rid")
        if replay_unsafe:
            cached = self._dedup_get(rid)
            if cached is not None:
                self.metrics.count("insert_dedup_hits")
                return cached
        if self._coalesce_eligible(req):
            # a parked request holds no filter: its flush resolves one,
            # and an eviction meanwhile must free the victim's device
            # memory, not wait for this handler to return
            del mf
            resp = self._coalescer.submit(
                "InsertBatch", req, replay_unsafe=replay_unsafe
            )
            if resp is not None:
                return resp
            # coalescer stopped between the check and the park — direct
        nkeys = protocol.batch_size(req)
        rows = self._fixed_rows(req)
        with self._op(req["name"], write=True) as mf, tracing.request_span(
            "InsertBatch", batch=nkeys, rid=obs.current_rid()
        ):
            presence = None
            if want_presence:
                keys = self._keys_list(req)
                # fused test-and-insert (blocked filters run it as one
                # device pass; others fall back to query-then-insert)
                if mf.supports_presence:
                    presence = mf.filter.insert_batch(
                        keys, return_presence=True
                    )
                else:
                    presence = mf.filter.include_batch(keys)
                    mf.filter.insert_batch(keys)
            elif self._packed_ok(mf, rows):
                # fixed wire encoding: the raw buffer reshapes straight
                # into the hash kernels' [B, L] layout — no per-key loop
                mf.filter.insert_packed(rows)
            else:
                mf.filter.insert_batch(self._keys_list(req))
            # honest-FULL verdicts: a cuckoo insert can reject
            # keys; collect the per-key flags under the op lock so the
            # response never claims an insert the kernel refused
            full = self._take_insert_full(mf)
            # log BEFORE notify_inserts: notify may trigger a checkpoint
            # whose snapshot contains this batch — its repl_seq stamp
            # (sampled from applied_seq at trigger time) must therefore
            # already include this op, or a crash-replay re-applies it
            seq = self._log_op(
                "InsertBatch", {"name": req["name"], **self._op_keys(req)}, mf
            )
            if seq is None:
                # apply path (replay / stream apply): echo the record's
                # own seq so the dedup-cached response stays seq-stamped
                seq = getattr(self._apply_seq_hint, "seq", None)
            if mf.checkpointer:
                mf.checkpointer.notify_inserts(nkeys)
        self.metrics.count("keys_inserted", nkeys)
        resp = {"ok": True, "n": nkeys}
        if seq is not None:
            resp["repl_seq"] = seq
        if presence is not None:
            resp["presence"] = np.packbits(np.asarray(presence)).tobytes()
        if full is not None:
            resp["full"] = full
        if replay_unsafe:
            self._dedup_put(rid, resp)
        return resp

    @staticmethod
    def _take_insert_full(mf: _Managed):
        """Packed not-inserted bitmap of the filter's last insert, or
        None for kinds whose inserts cannot fail. MUST run under the op
        lock, right after the insert — the flags are per-launch state."""
        taker = getattr(mf.filter, "take_insert_flags", None)
        if taker is None:
            return None
        flags = taker()
        if flags is None or flags.all():
            return None
        return np.packbits(~np.asarray(flags, dtype=bool)).tobytes()

    def QueryBatch(self, req: dict) -> dict:
        self._get(req["name"])
        if self._coalesce_eligible(req):
            resp = self._coalescer.submit("QueryBatch", req)
            if resp is not None:
                return resp
        nkeys = protocol.batch_size(req)
        rows = self._fixed_rows(req)
        with self._op(req["name"]) as mf, tracing.request_span(
            "QueryBatch", batch=nkeys, rid=obs.current_rid()
        ):
            # see class docstring: donation makes the lock mandatory
            if rows is not None and self._packed_ok(mf, rows) and hasattr(
                mf.filter, "include_packed"
            ):
                hits = mf.filter.include_packed(rows)
            else:
                hits = mf.filter.include_batch(self._keys_list(req))
        self.metrics.count("keys_queried", nkeys)
        with obs.phase("encode"):
            packed = np.packbits(hits).tobytes()
        return {"ok": True, "hits": packed, "n": nkeys}

    def _dedup_get(self, rid) -> Optional[dict]:
        if not rid or not self._dedup_capacity:
            return None
        with self._dedup_lock:
            resp = self._dedup.get(rid)
            if resp is not None:
                self._dedup.move_to_end(rid)
        return resp

    def _dedup_put(self, rid, resp: dict) -> None:
        if not rid or not self._dedup_capacity:
            return
        with self._dedup_lock:
            self._dedup[rid] = resp
            self._dedup.move_to_end(rid)
            while len(self._dedup) > self._dedup_capacity:
                self._dedup.popitem(last=False)

    def DeleteBatch(self, req: dict) -> dict:
        mf = self._get(req["name"])
        # attribute presence is not the signal (ShardedBloomFilter carries
        # delete_batch for all layouts and raises on non-counting): the
        # config decides — counting bloom filters and the sketch kinds
        # whose registry row says supports_delete (cuckoo; a CMS cannot
        # un-count) — and everything else stays code UNSUPPORTED
        deletable = getattr(
            mf.filter.config, "counting", False
        ) or sketch_registry.supports_delete(mf.filter.config)
        if not deletable or not hasattr(mf.filter, "delete_batch"):
            raise protocol.BloomServiceError(
                "UNSUPPORTED",
                "delete requires a counting filter or a deletable kind (cuckoo)",
            )
        # Retry safety: a delete is a counter
        # DECREMENT — a replay of one that already landed would decrement
        # twice (-> false negatives). Client retries reuse the logical
        # call's rid, so a bounded rid->response cache turns the replay
        # into a cache hit instead of a second apply. (Retries from one
        # client are sequential, so the lookup/apply pair doesn't need to
        # be atomic across requests.)
        rid = req.get("rid")
        cached = self._dedup_get(rid)
        if cached is not None:
            self.metrics.count("delete_dedup_hits")
            return cached
        if self._coalesce_eligible(req, "DeleteBatch"):
            # delete-only flushes ride the scheduler — one
            # launch + one merged log record + one barrier per flush;
            # deletes are always replay-unsafe (decrements), so every
            # demuxed response is dedup-cached under its rid. The parked
            # request holds no filter (see InsertBatch)
            del mf
            resp = self._coalescer.submit(
                "DeleteBatch", req, replay_unsafe=True
            )
            if resp is not None:
                return resp
        nkeys = protocol.batch_size(req)
        with self._op(req["name"], write=True) as mf:
            out = mf.filter.delete_batch(self._keys_list(req))
            seq = self._log_op(
                "DeleteBatch", {"name": req["name"], **self._op_keys(req)}, mf
            )
        if seq is None:  # apply path: keep the dedup response seq-stamped
            seq = getattr(self._apply_seq_hint, "seq", None)
        self.metrics.count("keys_deleted", nkeys)
        resp = {"ok": True, "n": nkeys}
        if out is not None and sketch_registry.is_sketch(mf.filter.config):
            # cuckoo reports per-key "a stored copy existed" (a False
            # flags a delete of a never-added key — a contract violation
            # worth surfacing, not masking)
            resp["deleted"] = np.packbits(np.asarray(out, dtype=bool)).tobytes()
        if seq is not None:
            resp["repl_seq"] = seq
        self._dedup_put(rid, resp)
        return resp

    def Clear(self, req: dict) -> dict:  # lint: allow(replay-safety): replay converges — clearing twice IS cleared (idempotent zeroing); the retried response's fresh repl_seq is STRONGER for barrier re-waits, not weaker
        self._get(req["name"])
        if self._coalesce_eligible(req, "Clear"):
            resp = self._coalescer.submit("Clear", req)
            if resp is not None:
                return resp
        with self._op(req["name"], write=True) as mf:
            mf.filter.clear()
            seq = self._log_op("Clear", {"name": req["name"]}, mf)
        resp = {"ok": True}
        if seq is not None:
            resp["repl_seq"] = seq
        return resp

    # -- sketch plane: RedisBloom CF.*/CMS.*/TOPK.* parity ----
    #
    # The *Reserve verbs are CreateFilter with a kind-specific geometry;
    # the data verbs delegate to the bloom data-plane handlers after a
    # kind check, so coalescing, rid dedup, quorum barriers, READONLY,
    # STALE_EPOCH, MOVED/ASK, replication, and tracing are inherited —
    # never re-implemented per kind.

    def _kind_checked(self, name: str, kinds: tuple, verb: str) -> _Managed:
        """Resolve + type-check a filter for a kind-specific verb
        (Redis WRONGTYPE parity: CF.ADD on a bloom key is an error)."""
        mf = self._get(name)
        kind = sketch_registry.kind_of(mf.filter.config)
        if kind not in kinds:
            raise protocol.BloomServiceError(
                "WRONG_TYPE",
                f"{verb} needs a {'/'.join(kinds)} filter; "
                f"{name!r} is kind {kind!r}",
            )
        return mf

    @staticmethod
    def _sketch_create_req(req: dict, config: dict) -> dict:
        """CreateFilter request for a reserve verb: the kind-specific
        geometry plus the caller's durability/routing envelope (rid,
        quorum, epoch, migration hints) passed through untouched."""
        out = {
            "name": req["name"],
            "config": config,
            "exist_ok": bool(req.get("exist_ok")),
        }
        if "restore" in req:
            out["restore"] = req["restore"]
        for field in ("rid", "min_replicas", "min_replicas_timeout_ms",
                      "epoch", "asking", "src_seq"):
            if field in req:
                out[field] = req[field]
        return out

    def CFReserve(self, req: dict) -> dict:  # lint: allow(replay-safety): pure CreateFilter delegation — create replay converges (exist_ok attach / ALREADY_EXISTS), no per-key state to double-apply
        """Create a cuckoo filter sized for ``capacity`` keys."""
        capacity = int(req["capacity"])
        if capacity <= 0:
            raise protocol.BloomServiceError(
                "INVALID_ARGUMENT", "capacity must be positive"
            )
        # size for ~84% slot load — the practical ceiling of a
        # bucket-size-4 table before FULL rejections set in
        slots = max(64, round_up_pow2(math.ceil(capacity / 0.84)))
        config = {"kind": "cuckoo", "m": slots, "k": 2,
                  **req.get("options", {})}
        return self.CreateFilter(self._sketch_create_req(req, config))

    def CFAdd(self, req: dict) -> dict:  # lint: allow(replay-safety): delegates to InsertBatch, which owns the rid-dedup cache (cuckoo inserts classify replay-unsafe via the kind registry)
        """Add keys to a cuckoo filter; resp ``full`` flags rejects."""
        self._kind_checked(req["name"], ("cuckoo",), "CFAdd")
        return self.InsertBatch(req)

    def CFDel(self, req: dict) -> dict:  # lint: allow(replay-safety): delegates to DeleteBatch, which owns the rid-dedup cache
        """Delete one stored copy per key from a cuckoo filter."""
        self._kind_checked(req["name"], ("cuckoo",), "CFDel")
        return self.DeleteBatch(req)

    def CFExists(self, req: dict) -> dict:
        """Membership on a cuckoo filter (QueryBatch with a kind check)."""
        self._kind_checked(req["name"], ("cuckoo",), "CFExists")
        return self.QueryBatch(req)

    def CMSInitByDim(self, req: dict) -> dict:  # lint: allow(replay-safety): pure CreateFilter delegation — see CFReserve
        """Create a count-min sketch with explicit [depth, width] dims.
        width rounds UP to a whole-uint32 multiple of 32 (strictly more
        counters — the configured error bound stays an upper bound)."""
        width, depth = int(req["width"]), int(req["depth"])
        if width <= 0 or not (1 <= depth <= 64):
            raise protocol.BloomServiceError(
                "INVALID_ARGUMENT", "need width > 0 and depth in [1, 64]"
            )
        width = ((width + 31) // 32) * 32
        config = {"kind": "cms", "m": width, "k": depth,
                  **req.get("options", {})}
        return self.CreateFilter(self._sketch_create_req(req, config))

    def CMSIncrBy(self, req: dict) -> dict:
        """Increment key counts. Unit increments (the common streaming
        shape) ARE InsertBatch and ride the coalescer unmodified;
        weighted increments take a direct pass that answers the
        POST-update estimates (Redis CMS.INCRBY parity)."""
        self._kind_checked(req["name"], ("cms", "topk"), "CMSIncrBy")
        incs = req.get("increments")
        nkeys = protocol.batch_size(req)
        if incs is not None and len(incs) != nkeys:
            raise protocol.BloomServiceError(
                "INVALID_ARGUMENT", f"{len(incs)} increments for {nkeys} keys"
            )
        if incs is None or all(int(i) == 1 for i in incs):
            return self.InsertBatch(
                {k: v for k, v in req.items() if k != "increments"}
            )
        # weighted path: a replayed increment double-counts, so the rid
        # cache answers retries (same contract as DeleteBatch)
        rid = req.get("rid")
        cached = self._dedup_get(rid)
        if cached is not None:
            self.metrics.count("insert_dedup_hits")
            return cached
        with self._op(req["name"], write=True) as mf, tracing.request_span(
            "CMSIncrBy", batch=nkeys, rid=obs.current_rid()
        ):
            try:
                counts = mf.filter.increment_batch(
                    self._keys_list(req), [int(i) for i in incs]
                )
            except ValueError as e:
                raise protocol.BloomServiceError("INVALID_ARGUMENT", str(e))
            # log BEFORE notify_inserts — same checkpoint-stamp ordering
            # as InsertBatch; the record carries the increments so a
            # replica / crash replay re-applies the exact weights
            seq = self._log_op(
                "CMSIncrBy",
                {"name": req["name"], **self._op_keys(req),
                 "increments": [int(i) for i in incs]},
                mf,
            )
            if seq is None:
                seq = getattr(self._apply_seq_hint, "seq", None)
            if mf.checkpointer:
                mf.checkpointer.notify_inserts(nkeys)
        self.metrics.count("keys_inserted", nkeys)
        resp = {"ok": True, "n": nkeys, "counts": [int(c) for c in counts]}
        if seq is not None:
            resp["repl_seq"] = seq
        self._dedup_put(rid, resp)
        return resp

    def CMSQuery(self, req: dict) -> dict:
        """Point estimates (only ever >= the true count)."""
        self._kind_checked(req["name"], ("cms", "topk"), "CMSQuery")
        nkeys = protocol.batch_size(req)
        with self._op(req["name"]) as mf, tracing.request_span(
            "CMSQuery", batch=nkeys, rid=obs.current_rid()
        ):
            counts = mf.filter.estimate_batch(self._keys_list(req))
        self.metrics.count("keys_queried", nkeys)
        return {"ok": True, "n": nkeys, "counts": [int(c) for c in counts]}

    def TopKReserve(self, req: dict) -> dict:  # lint: allow(replay-safety): pure CreateFilter delegation — see CFReserve
        """Create a top-``topk`` heavy-hitter sketch (CMS-backed)."""
        heap = int(req["topk"])
        if heap <= 0:
            raise protocol.BloomServiceError(
                "INVALID_ARGUMENT", "topk must be positive"
            )
        width = ((int(req.get("width", 2048)) + 31) // 32) * 32
        depth = int(req.get("depth", 5))
        if width <= 0 or not (1 <= depth <= 64):
            raise protocol.BloomServiceError(
                "INVALID_ARGUMENT", "need width > 0 and depth in [1, 64]"
            )
        config = {"kind": "topk", "m": width, "k": depth, "topk": heap,
                  **req.get("options", {})}
        return self.CreateFilter(self._sketch_create_req(req, config))

    def TopKAdd(self, req: dict) -> dict:  # lint: allow(replay-safety): delegates to InsertBatch, which owns the rid-dedup cache (topk inserts classify replay-unsafe via the kind registry)
        """Count occurrences into a top-k sketch (unit increments)."""
        self._kind_checked(req["name"], ("topk",), "TopKAdd")
        return self.InsertBatch(req)

    def TopKList(self, req: dict) -> dict:
        """Current heavy hitters, estimate-descending."""
        self._kind_checked(req["name"], ("topk",), "TopKList")
        with self._op(req["name"]) as mf:
            items = mf.filter.topk_list()
        return {
            "ok": True,
            "items": [{"key": k, "count": c} for k, c in items],
        }

    def Stats(self, req: dict) -> dict:
        if "name" in req:
            with self._op(req["name"]) as mf:
                st = mf.filter.stats() if hasattr(mf.filter, "stats") else {}
            if mf.checkpointer:
                st["checkpoints_written"] = mf.checkpointer.checkpoints_written
                st["checkpoint_seq"] = mf.checkpointer.seq
                st["checkpoint"] = mf.checkpointer.obs_stats()
            return {"ok": True, "stats": st}
        return {"ok": True, "server": self.metrics.snapshot()}

    def SlowlogGet(self, req: dict) -> dict:
        """Redis ``SLOWLOG GET [n]`` parity: slowest requests first, each
        with method, args summary, batch size, duration, request id,
        timestamp, and the per-phase breakdown."""
        n = req.get("n")
        return {
            "ok": True,
            "entries": self.slowlog.entries(None if n is None else int(n)),
        }

    def SlowlogReset(self, req: dict) -> dict:
        """Redis ``SLOWLOG RESET`` parity."""
        return {"ok": True, "cleared": self.slowlog.reset()}

    def TraceGet(self, req: dict) -> dict:
        """Distributed-tracing lookup: every span THIS node
        recorded for one trace id (= the client rid), plus coalescer
        flush spans that LINK it and their children. Cross-node
        assembly is the client's job (``ClusterClient.trace``).

        The looked-up id travels as ``trace_rid`` — the bare ``rid``
        field is the TRANSPORT correlation id every client stamps per
        call, which would otherwise clobber the lookup key; raw callers
        that stamp no correlation id may still use ``rid``."""
        rid = req.get("trace_rid") or req.get("rid")
        if not isinstance(rid, str) or not rid:
            raise protocol.BloomServiceError(
                "INVALID_ARGUMENT",
                "TraceGet needs {trace_rid: <request id>}",
            )
        return {
            "ok": True,
            "rid": rid,
            "enabled": obs_trace.enabled(),
            "spans": obs_trace.get_trace(rid),
        }

    def gauge_snapshot(self) -> list:
        """Per-filter gauge readings for the Prometheus exposition: each
        entry = {filter, stats, shard_fill?, checkpoint?}. Reads run under
        the filter's op lock — a gauge must never read a device buffer a
        donating insert is recycling."""
        with self._lock:
            filters = list(self._filters.items())
        out = []
        for name, mf in filters:
            with mf.lock:
                if mf.evicted:
                    continue  # paged out mid-walk — no device gauges
                st = mf.filter.stats() if hasattr(mf.filter, "stats") else {}
                # sharded stats() already paid the per-shard popcount —
                # don't run the O(m) reduction twice under the op lock
                shard_fill = st.get("fill_ratio_per_shard")
                if shard_fill is None and hasattr(mf.filter, "shard_fill_ratios"):
                    shard_fill = mf.filter.shard_fill_ratios()
            out.append(
                {
                    "filter": name,
                    "stats": st,
                    "shard_fill": shard_fill,
                    "checkpoint": (
                        mf.checkpointer.obs_stats() if mf.checkpointer else None
                    ),
                }
            )
        return out

    def Checkpoint(self, req: dict) -> dict:
        with self._op(req["name"]) as mf:
            # snapshot copy must not race a donating insert
            if not mf.checkpointer:
                raise protocol.BloomServiceError(
                    "UNSUPPORTED", "filter has no checkpoint sink"
                )
            triggered = mf.checkpointer.trigger()
        if req.get("wait", True):
            if not mf.checkpointer.flush():
                raise protocol.BloomServiceError(
                    "CKPT_TIMEOUT", "in-flight checkpoint write did not finish"
                )
            if not triggered:
                # an older snapshot was in flight — it predates this call's
                # durability point, so take a fresh one now that it's done.
                with mf.lock:
                    triggered = mf.checkpointer.trigger()
                if not mf.checkpointer.flush():
                    raise protocol.BloomServiceError(
                        "CKPT_TIMEOUT", "checkpoint write did not finish"
                    )
            if mf.checkpointer.last_error is not None:
                raise protocol.BloomServiceError(
                    "CKPT_FAILED", repr(mf.checkpointer.last_error)
                )
        return {"ok": True, "triggered": triggered, "seq": mf.checkpointer.seq}

    def shutdown(self) -> None:
        """Final checkpoint of every managed filter. Callers doing a full
        graceful drain should ``begin_drain()`` + stop the gRPC server
        first so no insert races the final snapshots."""
        self.begin_drain()
        if self._coalescer is not None:
            # flush + complete every parked request BEFORE the final
            # snapshots (their writers were admitted pre-drain)
            self._coalescer.close()
        with self._lock:
            filters = list(self._filters.items())
        for name, mf in filters:
            if mf.checkpointer:
                with mf.lock:  # let in-flight inserts drain first
                    landed = mf.checkpointer.close(final_checkpoint=True)  # lint: allow(blocking-under-lock): shutdown path — admission is already draining, the final snapshot must exclude donating inserts
                if not landed:
                    log.error(
                        "final checkpoint for filter %r did not land: %r",
                        name, mf.checkpointer.last_error,
                    )


def _wrap(service: BloomService, method_name: str):
    handler = getattr(service, method_name)

    def unary_unary(request: bytes, context) -> bytes:
        t0 = time.perf_counter()
        with obs.request(method_name) as rctx:
            req_name = None
            # readonly + admission first, before decode: a rejection must
            # stay cheap when the server is drowning
            if service.read_only and method_name in protocol.MUTATING_METHODS:
                resp = protocol.error_response(
                    "READONLY",
                    f"{method_name} rejected: this server is a read-only "
                    f"replica — send writes to the primary",
                    details=(
                        {"primary": service.primary_address}
                        if service.primary_address
                        else None
                    ),
                )
                rctx.summary = "(readonly)"
                service.metrics.count("readonly_rejected")
            elif (
                service.oplog_error is not None
                and method_name in protocol.MUTATING_METHODS
            ):
                # fail-stop after an op-log append error: memory is ahead
                # of the log; accepting more writes would widen the
                # divergence silently (Redis MISCONF parity)
                resp = protocol.error_response(
                    "LOG_WRITE_FAILED",
                    f"{method_name} rejected: op log append failed "
                    f"({service.oplog_error}); writes are stopped until "
                    f"the log is writable and the server restarts",
                )
                rctx.summary = "(log-failstop)"
                service.metrics.count("log_failstop_rejected")
            elif (shed := service.admit(method_name)) is not None:
                resp = shed
                rctx.summary = "(shed)"
            else:
                try:
                    faults.fire("rpc.pre_handle")
                    with obs.phase("decode"):
                        req = protocol.decode(request)
                    # correlate with the client's id when it sent one; the
                    # context pre-generated a server-side id otherwise
                    if isinstance(req.get("rid"), str) and req["rid"]:
                        rctx.rid = req["rid"]
                    rctx.batch = protocol.batch_size(req)
                    rctx.summary = summarize_request(method_name, req)
                    # distributed tracing: decide capture
                    # now that the client rid (and any propagated trace
                    # context) is known — forced by the wire field, or
                    # the deterministic per-rid sample; slowlog-worthy
                    # requests are additionally captured at finish.
                    # TraceGet never traces itself: an assembly's
                    # lookup fan-out must not pollute (or evict from)
                    # the ring it is reading.
                    tmeta = req.get("trace")
                    if not isinstance(tmeta, dict):
                        tmeta = None
                    if method_name != "TraceGet":
                        obs_trace.arm_request(
                            rctx,
                            forced=bool(tmeta and tmeta.get("forced")),
                            parent=tmeta.get("span") if tmeta else None,
                        )
                    name = req.get("name")
                    req_name = name if isinstance(name, str) else None
                    if service.storage is not None and req_name is not None:
                        # key-weighted tenant heat — the
                        # eviction rank follows the same load signal
                        # the per-slot traffic counters expose
                        service.storage.touch(req_name, rctx.batch or 1)
                    # topology-epoch fence: a mutating request
                    # stamped with an OLDER epoch than this server's was
                    # routed under a pre-failover view — reject so the
                    # client refreshes its topology instead of writing
                    # under a stale map
                    req_epoch = req.get("epoch")
                    if (
                        req_epoch is not None
                        and method_name in protocol.MUTATING_METHODS
                        and int(req_epoch) < service.epoch
                    ):
                        service.metrics.count("stale_epoch_rejected")
                        raise protocol.BloomServiceError(
                            "STALE_EPOCH",
                            f"request epoch {req_epoch} predates the "
                            f"current topology epoch {service.epoch} — "
                            f"refresh your topology",
                            details={"epoch": service.epoch},
                        )
                    # cluster slot-ownership check: MOVED /
                    # ASK / CLUSTERDOWN redirects BEFORE the handler;
                    # the importing side's seq gate short-circuits
                    # re-delivered migration forwards (exactly-once)
                    gate_dup = False
                    src_seq = None
                    keyed = (
                        service.cluster is not None
                        and isinstance(req_name, str)
                        and method_name in cluster_node.KEYED_METHODS
                    )

                    def slot_check():
                        service.cluster.check(
                            req_name,
                            asking=bool(req.get("asking")),
                            exists=service.has_filter(req_name),
                            primary_address=(
                                service.primary_address
                                if service.read_only
                                else None
                            ),
                        )

                    if keyed:
                        slot_check()
                        if rctx.batch:
                            # per-slot key-traffic counters
                            # (ROADMAP item 6): rebalance
                            # decisions can be load-driven instead of
                            # slot-count-driven. Dynamic series —
                            # declared via DYNAMIC_PREFIXES in obs.names
                            obs_counters.incr(
                                "cluster_slot_keys_total_"
                                f"{cluster_slots.key_slot(req_name)}",
                                rctx.batch,
                            )
                        if (
                            method_name in protocol.MUTATING_METHODS
                            and req.get("asking")
                            and req.get("src_seq") is not None
                        ):
                            if (
                                service.cluster.is_importing(
                                    cluster_slots.key_slot(req_name)
                                )
                                and service.cluster.gate_base(req_name)
                                is None
                            ):
                                # importing but no gate yet: the
                                # snapshot install is still in flight
                                # (or was lost to a restart) — applying
                                # now would land on state the install
                                # is about to REPLACE, silently losing
                                # the write. Refuse; the source's
                                # forward fails and the client re-drives
                                # under the same rid until the gate
                                # exists.
                                raise protocol.BloomServiceError(
                                    "IMPORT_NOT_READY",
                                    f"filter {req_name!r} has no import "
                                    f"gate yet (snapshot install in "
                                    f"flight) — retry",
                                )
                            # atomic claim: the tail replay and the live
                            # dual-write may deliver the SAME record
                            # concurrently — only one claim wins, the
                            # other acks as a dup without re-applying
                            faults.fire("cluster.migrate_apply")
                            if service.cluster.gate_claim(
                                req_name, int(req["src_seq"])
                            ):
                                src_seq = int(req["src_seq"])
                            else:
                                gate_dup = True
                                service.metrics.count("cluster_forward_dups")
                    if gate_dup:
                        # the forwarded record is already contained here
                        # (snapshot coverage / earlier delivery): ack
                        # without re-applying. Prefer the dedup cache's
                        # FULL response (an earlier delivery through the
                        # handler cached it, presence bits and this
                        # node's repl_seq included) over the bare ack.
                        cached = service._dedup_get(req.get("rid"))
                        resp = cached if cached is not None else {
                            "ok": True,
                            "migrate_dup": True,
                            "n": protocol.batch_size(req),
                        }
                    else:
                        try:
                            resp = handler(req)
                        except BaseException as e:
                            if src_seq is not None:
                                # the apply itself failed: the record is
                                # NOT contained — a re-delivery must pass
                                service.cluster.gate_unclaim(
                                    req_name, src_seq
                                )
                            if keyed and getattr(e, "code", None) == "NOT_FOUND":
                                # the slot's handoff finalized and retired
                                # the local copy after the check above (a
                                # request parked in the coalescer meets
                                # that window most): nothing applied here,
                                # so answer the redirect the map gives now
                                slot_check()
                            raise
                    # a coalesced response already paid its flush's
                    # shared barrier and was proven outside
                    # any dual-write window under the op lock — pop the
                    # marker and skip both. The dedup-cached copy is
                    # stored WITHOUT the marker, so a same-rid retry
                    # re-waits through the normal barrier below.
                    coalesced_done = isinstance(resp, dict) and bool(
                        resp.pop("_coalesced", False)
                    )
                    # durability gate: block OUTSIDE every
                    # lock until the quorum acked this write's record;
                    # a dedup-cache replay re-enters here with the
                    # cached repl_seq and re-waits on the same record
                    # (a barrier timeout does NOT unclaim: the apply
                    # stands, only its quorum ack is missing)
                    if (
                        not gate_dup
                        and not coalesced_done
                        and method_name in protocol.MUTATING_METHODS
                        and resp.get("ok")
                    ):
                        with obs_trace.span("barrier.wait"):
                            resp = service.commit_barrier(req, resp)
                        if service.cluster is not None:
                            # dual-write window: a mutating op
                            # on a migrating filter must land on the
                            # target BEFORE the client is acked
                            resp = cluster_migrate.forward_op(
                                service, method_name, req, resp
                            )
                    # post-apply fault: the handler's effect landed but the
                    # response is "lost" — the case rid-dedup must absorb
                    faults.fire("rpc.post_handle")
                except protocol.BloomServiceError as e:
                    resp = protocol.error_response(e.code, e.message, e.details)
                except Exception as e:  # surface, don't kill the channel
                    log.exception("RPC %s failed", method_name)
                    resp = protocol.error_response(
                        "INTERNAL", f"{type(e).__name__}: {e}"
                    )
                finally:
                    service.release(method_name)
            try:
                with obs.phase("encode"):
                    raw = protocol.encode(resp)
            except Exception as e:  # unserializable handler output: keep
                log.exception("RPC %s response encode failed", method_name)
                raw = protocol.encode(  # the structured error contract
                    protocol.error_response(
                        "INTERNAL",
                        f"response encode failed: {type(e).__name__}: {e}",
                    )
                )
            duration_s = time.perf_counter() - t0
            service.metrics.observe_rpc(
                method_name, duration_s, rctx.phases, rid=rctx.rid
            )
            if obs_trace.enabled() and method_name != "TraceGet":
                # commit the request's span tree: sampled/
                # forced requests always, and slowlog-worthy ones even
                # unsampled — asked BEFORE the slowlog entry lands so
                # the predicate is not perturbed by this request itself
                code = "OK"
                if isinstance(resp, dict) and not resp.get("ok", False):
                    code = (resp.get("error") or {}).get("code", "UNKNOWN")
                tattrs: dict = {"method": method_name, "code": code}
                if req_name:
                    tattrs["filter"] = req_name
                    if service.cluster is not None:
                        tattrs["slot"] = cluster_slots.key_slot(req_name)
                if rctx.batch:
                    tattrs["batch"] = int(rctx.batch)
                if isinstance(resp, dict) and resp.get("repl_seq") is not None:
                    tattrs["seq"] = int(resp["repl_seq"])
                obs_trace.finish_request(
                    rctx, duration_s, attrs=tattrs,
                    # the slowlog probe (a lock round trip) only
                    # matters when the request is NOT already armed
                    slow=(
                        not rctx.trace_armed
                        and service.slowlog.would_record(duration_s)
                    ),
                )
            service.slowlog.record(
                method=method_name,
                duration_s=duration_s,
                rid=rctx.rid,
                batch=rctx.batch,
                args=rctx.summary,
                phases=rctx.phases,
            )
            if service.monitor_hub.active:
                # MONITOR parity: one structured event per finished
                # request (key payloads stay redacted to the summary)
                service.monitor_hub.publish(
                    {
                        "kind": "op",
                        "ts": time.time(),
                        "method": method_name,
                        "name": req_name,
                        "rid": rctx.rid,
                        "batch": rctx.batch,
                        "args": rctx.summary,
                        "duration_s": duration_s,
                        "ok": bool(resp.get("ok", False)),
                    }
                )
        return raw

    return grpc.unary_unary_rpc_method_handler(unary_unary)


#: Streaming RPC name -> generator(service, req, context).
_STREAM_BEHAVIORS = {
    "ReplStream": repl_primary.repl_stream,
    "Monitor": repl_monitor.monitor_stream,
}

#: Client-streaming RPC name -> behavior(service, request_iterator,
#: context) -> response dict.
_CLIENT_STREAM_BEHAVIORS = {
    "ReplAck": repl_primary.repl_ack,
}


#: Bidi-streaming RPC name -> behavior(service, request_iterator,
#: context) -> yields encoded ack frames (the streaming
#: ingest plane; see :mod:`tpubloom_torch.server.streams`).
_BIDI_STREAM_BEHAVIORS = {
    "InsertStream": server_streams.insert_stream,
    "QueryStream": server_streams.query_stream,
}


def _wrap_bidi_stream(service: BloomService, method_name: str):
    behavior = _BIDI_STREAM_BEHAVIORS[method_name]

    def stream_stream(request_iterator, context):
        service.metrics.count(f"stream_{method_name}_opened")
        # frames are decoded/encoded INSIDE the behavior: the receiver
        # thread consumes raw request frames while this handler thread
        # drains the per-stream ack queue — per-frame semantic errors
        # answer as error ACKS (the stream survives); only a transport
        # break or an injected stream.recv/stream.ack fault tears the
        # stream down (the client reconnects and replays unacked
        # frames under their original rids)
        yield from behavior(service, request_iterator, context)

    return grpc.stream_stream_rpc_method_handler(stream_stream)


def _wrap_client_stream(service: BloomService, method_name: str):
    behavior = _CLIENT_STREAM_BEHAVIORS[method_name]

    def stream_unary(request_iterator, context) -> bytes:
        service.metrics.count(f"stream_{method_name}_opened")
        # an injected repl.ack_recv (or any bug) propagates: grpc fails
        # the RPC and the replica re-opens its ack stream on heartbeat
        return protocol.encode(behavior(service, request_iterator, context))

    return grpc.stream_unary_rpc_method_handler(stream_unary)


def _wrap_stream(service: BloomService, method_name: str):
    gen_fn = _STREAM_BEHAVIORS[method_name]

    def unary_stream(request: bytes, context):
        try:
            req = protocol.decode(request) if request else {}
        except Exception:
            req = {}
        service.metrics.count(f"stream_{method_name}_opened")
        # an injected repl.stream_send fault (or any bug) propagates out
        # of the generator: grpc surfaces a stream error and the replica
        # reconnects — exactly the mid-batch-kill chaos case
        for msg in gen_fn(service, req, context):
            yield protocol.encode(msg)

    return grpc.unary_stream_rpc_method_handler(unary_stream)


def build_server(
    service: BloomService,
    address: str = "127.0.0.1:50051",
    max_workers: int = 16,
) -> tuple[grpc.Server, int]:
    """Create (not start) a grpc.Server with the BloomService mounted.

    Returns ``(server, bound_port)``; pass port 0 in ``address`` for an
    ephemeral port. ``max_workers`` sizes the handler thread pool: every
    connected replica parks TWO workers for its stream lifetimes
    (ReplStream out + ReplAck in), and blocked Wait/commit-
    barrier calls hold theirs too — size generously.
    """
    handlers = {m: _wrap(service, m) for m in protocol.METHODS}
    handlers.update(
        {m: _wrap_stream(service, m) for m in protocol.STREAM_METHODS}
    )
    handlers.update(
        {
            m: _wrap_client_stream(service, m)
            for m in protocol.CLIENT_STREAM_METHODS
        }
    )
    handlers.update(
        {
            m: _wrap_bidi_stream(service, m)
            for m in protocol.BIDI_STREAM_METHODS
        }
    )
    generic = grpc.method_handlers_generic_handler(protocol.SERVICE, handlers)
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        options=list(protocol.CHANNEL_OPTIONS),
    )
    server.add_generic_rpc_handlers((generic,))
    port = server.add_insecure_port(address)
    return server, port


def _inspect_quarantine_main(argv: list) -> int:
    """``python -m tpubloom_torch.server inspect-quarantine <ckpt_dir>
    [--purge] [--json]`` — operator view of the corrupt-checkpoint
    quarantine."""
    import argparse
    import json as _json

    parser = argparse.ArgumentParser(
        prog="tpubloom_torch.server inspect-quarantine",
        description="list / purge quarantined corrupt checkpoint blobs",
    )
    parser.add_argument("directory", help="the checkpoint directory")
    parser.add_argument(
        "--purge", action="store_true", help="delete every quarantined blob"
    )
    parser.add_argument(
        "--json", action="store_true", dest="as_json",
        help="machine-readable output",
    )
    args = parser.parse_args(argv)
    report = ckpt.inspect_quarantine(args.directory, purge=args.purge)
    if args.as_json:
        print(_json.dumps(report))
    else:
        print(
            f"quarantine {report['quarantine_dir']}: "
            f"{len(report['entries'])} blob(s), {report['total_bytes']} bytes"
        )
        for e in report["entries"]:
            print(
                f"  {e['file']:40s} {e['bytes']:>12d}B  "
                f"{time.strftime('%Y-%m-%d %H:%M:%S', time.localtime(e['mtime']))}"
                f"  {e['diagnosis']}"
            )
        if args.purge:
            print(f"purged {report['purged']} blob(s)")
    return 0


def _promote_main(argv: list) -> int:
    """``python -m tpubloom_torch.server promote <address> [--epoch N]
    [--repl-log-dir DIR]`` — manual replica→primary promotion (Redis
    ``REPLICAOF NO ONE`` parity): sends the ``Promote`` RPC to the
    given replica. ``--repl-log-dir`` names the log dir the REMOTE
    process should open when it was started without one (chained
    replicas already have theirs)."""
    import argparse
    import json as _json

    from tpubloom_torch.server.client import BloomClient

    parser = argparse.ArgumentParser(
        prog="tpubloom_torch.server promote",
        description="promote a running replica to primary",
    )
    parser.add_argument("address", help="host:port of the replica")
    parser.add_argument(
        "--epoch", type=int, default=None,
        help="pin the topology epoch (default: the replica bumps its own)",
    )
    parser.add_argument(
        "--repl-log-dir", default=None,
        help="op-log dir the replica should adopt when it has none",
    )
    args = parser.parse_args(argv)
    req: dict = {}
    if args.epoch is not None:
        req["epoch"] = args.epoch
    if args.repl_log_dir:
        req["repl_log_dir"] = args.repl_log_dir
    with BloomClient(args.address) as client:
        resp = client._rpc("Promote", req)
    print(_json.dumps(resp))
    return 0


def main(argv: Optional[list] = None) -> None:
    """``python -m tpubloom_torch.server [port] [checkpoint_dir]
    [--device cuda|cpu] [--metrics-port N] [--slowlog-capacity N]
    [--max-in-flight N] [--drain-grace S] [--coalesce-max-keys N]
    [--coalesce-max-wait-us U] [--trace-sample R] [--repl-log-dir DIR]
    [--repl-fsync POLICY] [--replica-of HOST:PORT]
    [--min-replicas-to-write N] [--min-replicas-max-lag-ms M]
    [--max-resident-filters N] [--max-resident-bytes B]
    [--storage-warm-bytes B] [--hydration-max-concurrent N]
    [--tenant-hydrations-per-min N]``

    The flags of ``python -m tpubloom.server``. ``--repl-log-dir`` attaches
    the op log (replayed at start); ``--replica-of`` runs a read-only
    replica that bootstraps from its local state
    (``bootstrap_from_local``) and then follows the primary;
    ``--min-replicas-to-write`` gates writes behind the sync quorum;
    ``--max-resident-*`` page tenants under a device-memory budget.
    ``--replica-of`` + ``--repl-log-dir`` together run a CHAINED replica:
    applied records re-append to the local log, ``ReplStream`` serves
    downstream replicas, and promotion is cheap. ``--cluster`` attaches a
    :class:`tpubloom_torch.cluster.ClusterState` whose slot map persists
    beside the op log (or the checkpoint dir; neither: memory only); seed
    it with ``python -m tpubloom_torch.cluster init``. With no card and no
    ``--device cpu`` the server exits with ``resolve_device``'s error.

    Subcommands: ``inspect-quarantine <dir>``, ``promote <address>``.
    """
    import argparse
    import signal
    import sys as _sys

    argv = list(_sys.argv[1:]) if argv is None else list(argv)
    if argv and argv[0] == "inspect-quarantine":
        raise SystemExit(_inspect_quarantine_main(argv[1:]))
    if argv and argv[0] == "promote":
        raise SystemExit(_promote_main(argv[1:]))

    parser = argparse.ArgumentParser(
        prog="tpubloom_torch.server",
        description="tpubloom gRPC server on PyTorch (CUDA card or CPU)",
    )
    parser.add_argument("port", nargs="?", type=int, default=50051)
    parser.add_argument("checkpoint_dir", nargs="?", default=None)
    parser.add_argument(
        "--device",
        default=None,
        help="where the filters live: 'cuda' (the default: the CUDA card; "
        "an error without one) or 'cpu' (the plain PyTorch versions)",
    )
    parser.add_argument(
        "--metrics-port",
        type=int,
        default=None,
        help="serve Prometheus text format at http://0.0.0.0:PORT/metrics "
        "(0 picks an ephemeral port; omit to disable)",
    )
    parser.add_argument(
        "--slowlog-capacity",
        type=int,
        default=128,
        help="how many slowest requests SlowlogGet retains (default 128)",
    )
    parser.add_argument(
        "--max-in-flight",
        type=int,
        default=None,
        help="cap on concurrently-executing data-plane RPCs; excess "
        "requests are shed with RESOURCE_EXHAUSTED + retry_after_ms "
        "(default: unbounded)",
    )
    parser.add_argument(
        "--drain-grace",
        type=float,
        default=15.0,
        help="seconds to let in-flight RPCs finish on SIGTERM/SIGINT "
        "before final checkpoints (default 15)",
    )
    parser.add_argument(
        "--repl-log-dir",
        default=None,
        help="append every mutating RPC to a CRC32C-framed op log in this "
        "directory (AOF parity: startup replays it over the restored "
        "checkpoints) and serve the ReplStream RPC to replicas",
    )
    parser.add_argument(
        "--repl-fsync",
        action="store_true",
        help="fsync the op log on every append (Redis appendfsync-always "
        "parity; default: OS page cache)",
    )
    parser.add_argument(
        "--replica-of",
        default=None,
        metavar="HOST:PORT",
        help="run as a read-only replica of the given primary: stream and "
        "apply its op log, serve reads, answer writes with READONLY. "
        "Combine with --repl-log-dir for a CHAINED replica (re-appends "
        "applied records locally, serves ReplStream downstream, promotes "
        "cheaply)",
    )
    parser.add_argument(
        "--repl-batch-bytes",
        type=int,
        default=None,
        help="coalesce ReplStream records into zlib-compressed frames of "
        "up to N raw bytes for replicas that negotiated the capability "
        "(WAN links; default: one record per message)",
    )
    parser.add_argument(
        "--announce",
        default=None,
        metavar="HOST:PORT",
        help="address to announce to primaries/sentinels (Redis "
        "replica-announce parity; default 127.0.0.1:<port>)",
    )
    parser.add_argument(
        "--min-replicas-to-write",
        type=int,
        default=0,
        metavar="N",
        help="synchronous-replication quorum (Redis min-replicas-to-write "
        "parity): each mutating RPC blocks after its op-log append until "
        "N replicas acknowledge the record; timeout answers "
        "NOT_ENOUGH_REPLICAS. Requires --repl-log-dir. Default 0 (async)",
    )
    parser.add_argument(
        "--cluster",
        action="store_true",
        help="run in cluster mode (Redis Cluster parity): every "
        "keyed RPC is checked against the hash-slot map (MOVED/ASK "
        "redirects), the ClusterSlots/ClusterSetSlot/MigrateSlot verbs "
        "are served, and the map persists beside the op log (or the "
        "checkpoint dir). Seed assignments with `python -m "
        "tpubloom_torch.cluster init`",
    )
    parser.add_argument(
        "--coalesce-max-keys",
        type=int,
        default=0,
        metavar="N",
        help="enable the cross-connection ingestion coalescer: "
        "concurrent InsertBatch/QueryBatch RPCs park in per-filter "
        "queues and flush as ONE device launch + ONE op-log append + "
        "ONE commit barrier once N keys are parked (or the wait budget "
        "expires). 0 disables (the default, per-request path)",
    )
    parser.add_argument(
        "--coalesce-max-wait-us",
        type=int,
        default=500,
        metavar="U",
        help="coalescer flush deadline: a parked request never waits "
        "longer than this for batch-mates (default 500us)",
    )
    parser.add_argument(
        "--max-resident-filters",
        type=int,
        default=0,
        metavar="N",
        help="multi-tenant paging: keep at most N filters "
        "RESIDENT in device HBM; cold-ranked filters are evicted to a "
        "host-RAM blob pool (and their checkpoints) and lazily "
        "re-hydrated on first RPC. 0 disables paging (the default, "
        "every filter resident for the process lifetime)",
    )
    parser.add_argument(
        "--max-resident-bytes",
        type=int,
        default=0,
        metavar="B",
        help="HBM residency budget in approximate filter bytes — the "
        "byte-denominated twin of --max-resident-filters (either or "
        "both may be set; 0 = unbounded)",
    )
    parser.add_argument(
        "--storage-warm-bytes",
        type=int,
        default=256 * 1024 * 1024,
        metavar="B",
        help="host-RAM blob pool budget for WARM (evicted) filters; "
        "over budget the coldest fully-checkpointed blobs are trimmed "
        "to COLD (checkpoint-only). Default 256MiB",
    )
    parser.add_argument(
        "--hydration-max-concurrent",
        type=int,
        default=4,
        metavar="N",
        help="at most N tenant hydrations in flight; further cold-"
        "tenant requests are shed with RESOURCE_EXHAUSTED + "
        "retry_after_ms (default 4)",
    )
    parser.add_argument(
        "--tenant-hydrations-per-min",
        type=int,
        default=0,
        metavar="N",
        help="per-tenant hydration quota (token bucket): a tenant "
        "thrashing in and out of residency faster than this is shed "
        "with retry_after_ms while hot tenants keep serving. 0 "
        "disables (the default)",
    )
    parser.add_argument(
        "--min-replicas-max-lag-ms",
        type=int,
        default=DEFAULT_MIN_REPLICAS_MAX_LAG_MS,
        metavar="M",
        help="how long the commit barrier (and a Wait with no timeout) "
        "waits for the replica quorum before giving up "
        f"(default {DEFAULT_MIN_REPLICAS_MAX_LAG_MS})",
    )
    parser.add_argument(
        "--trace-sample",
        type=float,
        default=None,
        metavar="R",
        help="distributed tracing: capture span trees for "
        "this deterministic per-rid fraction of requests (0.0 = only "
        "forced/slowlog-worthy ones) into the bounded per-node ring "
        "served by TraceGet and /trace?rid=. Omit to disable tracing "
        "entirely (the default: no wire fields, no overhead)",
    )
    parser.add_argument(
        "--flight-dir",
        default=None,
        metavar="DIR",
        help="flight-recorder dump directory (default: the op-log dir "
        "or checkpoint dir, else $TPUBLOOM_FLIGHT_DIR); lifecycle-event "
        "dumps land here on SIGTERM, fatal write-path errors and Health "
        "DEGRADED flips",
    )
    parser.add_argument(
        "--blackbox-dir",
        default=None,
        metavar="DIR",
        help="crash-forensics black box: map the SIGKILL-"
        "surviving flight/trace rings under DIR/blackbox/ (default: "
        "the op-log dir, else the checkpoint dir, else an explicit "
        "--flight-dir — NOT $TPUBLOOM_FLIGHT_DIR, which many processes "
        "share; no state dir at all leaves the box off). Read dead "
        "nodes with `python -m tpubloom_torch.obs.blackbox DIR`",
    )
    parser.add_argument(
        "--no-blackbox",
        action="store_true",
        help="disable the crash-forensics black box even when a state "
        "dir is available",
    )
    args = parser.parse_args(argv)
    if args.min_replicas_to_write and not args.repl_log_dir:
        parser.error("--min-replicas-to-write requires --repl-log-dir")
    ckpt_dir = args.checkpoint_dir
    sink_factory = (
        (lambda config: ckpt.FileSink(ckpt_dir)) if ckpt_dir else (lambda config: None)
    )
    logging.basicConfig(level=logging.INFO)
    faults.load_env()
    for armed in faults.active():
        log.warning("fault injection armed: %s", armed)
    oplog = None
    if args.repl_log_dir:
        from tpubloom_torch.repl import OpLog

        oplog = OpLog(args.repl_log_dir, fsync=args.repl_fsync)
    announce = args.announce or f"127.0.0.1:{args.port}"
    cluster_state = None
    if args.cluster:
        from tpubloom_torch.cluster.node import ClusterState

        cluster_state = ClusterState(
            announce, state_dir=args.repl_log_dir or ckpt_dir
        )
        log.info(
            "cluster mode: %s (map epoch %d)",
            announce, cluster_state.epoch(),
        )
    storage_config = None
    if args.max_resident_filters > 0 or args.max_resident_bytes > 0:
        from tpubloom_torch.storage import StorageConfig

        if not ckpt_dir:
            parser.error(
                "--max-resident-filters/--max-resident-bytes require a "
                "checkpoint_dir (the COLD tier needs a durable sink)"
            )
        storage_config = StorageConfig(
            max_resident_filters=args.max_resident_filters or None,
            max_resident_bytes=args.max_resident_bytes or None,
            warm_pool_bytes=args.storage_warm_bytes,
            hydration_max_concurrent=args.hydration_max_concurrent,
            tenant_hydrations_per_min=args.tenant_hydrations_per_min,
        )
        log.info(
            "multi-tenant paging: max %s resident filter(s) / %s bytes",
            args.max_resident_filters or "unbounded",
            args.max_resident_bytes or "unbounded",
        )
    coalesce = None
    if args.coalesce_max_keys > 0:
        from tpubloom_torch.server.ingest import CoalesceConfig

        coalesce = CoalesceConfig(
            max_keys=args.coalesce_max_keys,
            max_wait_us=args.coalesce_max_wait_us,
        )
        log.info(
            "ingestion coalescer: flush at %d keys / %dus",
            args.coalesce_max_keys, args.coalesce_max_wait_us,
        )
    # flight recorder: dumps land beside the durable state
    # (or wherever CI's TPUBLOOM_FLIGHT_DIR points) — post-mortems of
    # chaos failures stop depending on scraping a live /metrics
    import os as _os

    flight_dir = (
        args.flight_dir
        or _os.environ.get(obs_flight.DUMP_DIR_ENV)
        or args.repl_log_dir
        or ckpt_dir
    )
    if flight_dir:
        obs_flight.configure(dump_dir=flight_dir)
    # crash-forensics black box: the mapped rings live in a
    # NODE-PRIVATE state dir (ring file names are fixed so a restart
    # reattaches to its own pre-crash history — a shared dir like
    # $TPUBLOOM_FLIGHT_DIR would collide across processes, so it is
    # deliberately not a fallback here)
    blackbox_dir = (
        None
        if args.no_blackbox
        else (
            args.blackbox_dir
            or args.repl_log_dir
            or ckpt_dir
            or args.flight_dir
        )
    )
    if blackbox_dir:
        obs_blackbox.configure(blackbox_dir, node={"addr": announce})
    service = BloomService(
        sink_factory=sink_factory,
        slowlog_capacity=args.slowlog_capacity,
        max_in_flight=args.max_in_flight,
        oplog=oplog,
        read_only=bool(args.replica_of),
        repl_batch_bytes=args.repl_batch_bytes,
        listen_address=announce,
        min_replicas_to_write=args.min_replicas_to_write,
        min_replicas_max_lag_ms=args.min_replicas_max_lag_ms,
        cluster=cluster_state,
        coalesce=coalesce,
        storage=storage_config,
        trace_sample=args.trace_sample,
        device=args.device,
    )
    if oplog is not None:
        stats = service.replay_oplog()
        log.info(
            "op log %s: replayed %d record(s) (%d already covered by "
            "checkpoints, %d failed), next seq %d",
            args.repl_log_dir, stats["applied"], stats["skipped"],
            stats["failed"], oplog.last_seq + 1,
        )
    applier = None
    if args.replica_of:
        from tpubloom_torch.repl import (
            ReplicaApplier,
            ReplicaStateStore,
            bootstrap_from_local,
        )

        # replica durability: the cursor + manifest
        # live beside the op log (chained) or the checkpoint sink — a
        # restart partial-resyncs instead of always paying a full resync
        state_dir = args.repl_log_dir or ckpt_dir
        store = ReplicaStateStore(state_dir) if state_dir else None
        service.replica_state_store = store
        if service._manifest_dir is None and state_dir:
            service._manifest_dir = state_dir
        cursor, log_id = bootstrap_from_local(service, store)
        applier = ReplicaApplier(
            service,
            args.replica_of,
            state_store=store,
            listen_address=announce,
            initial_cursor=cursor,
            initial_log_id=log_id,
        ).start()
        log.info(
            "replicating from %s (read-only%s%s)",
            args.replica_of,
            ", chained" if oplog is not None else "",
            f", resuming at seq {cursor}" if cursor is not None else "",
        )
    server, bound = build_server(service, f"0.0.0.0:{args.port}")
    server.start()
    # power-on record: every state dir's black box carries
    # at least this — the anchor a post-mortem needs to know WHICH
    # process (role, epoch, address) wrote the final events before a
    # SIGKILL that ran no handler
    obs_flight.note(
        "boot",
        role="replica" if args.replica_of else "primary",
        epoch=int(service.epoch),
        addr=announce,
    )
    log.info("tpubloom server listening on :%d (checkpoints: %s)", bound, ckpt_dir)
    metrics_server = None
    if args.metrics_port is not None:
        from tpubloom_torch.obs.httpd import start_metrics_server

        metrics_server = start_metrics_server(service, port=args.metrics_port)
        log.info(
            "prometheus exposition on http://0.0.0.0:%d/metrics",
            metrics_server.port,
        )

    # Graceful drain: SIGTERM/SIGINT -> stop admitting (new
    # requests shed as DRAINING; clients pace off retry_after_ms and find
    # the replacement process), finish in-flight work, write a final
    # checkpoint of every filter, then exit. Acked-but-unflushed state
    # survives the roll.
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda signum, frame: stop.set())
    stop.wait()
    log.info("drain: refusing new work, finishing in-flight requests...")
    # flight recorder: dump FIRST — the drain itself may
    # wedge, and the whole point is having the lifecycle ring on disk
    # when the process stops being scrapeable
    obs_flight.note("drain", grace_s=float(args.drain_grace))
    obs_flight.dump("sigterm")
    # black box msync: the drain note above already landed
    # in the mapped ring lock-free; flushing here covers the machine-
    # crash-during-drain case
    obs_blackbox.sync()
    service.begin_drain()
    # Notice window BEFORE the port closes: grpc's stop() rejects new RPCs
    # at the transport, so without this pause clients would only ever see
    # raw UNAVAILABLE — never the structured DRAINING shed (with
    # retry_after_ms) or a DRAINING Health answer that tells them this is
    # a roll, not an outage.
    time.sleep(min(2.0, args.drain_grace / 3))
    server.stop(grace=args.drain_grace).wait()
    # a runtime Promote/ReplicaOf may have replaced (or dropped) the
    # startup applier and op log — drain whatever is CURRENT
    live_applier = service.replica_applier or applier
    if live_applier is not None:
        live_applier.stop()
    log.info("drain: final checkpoints...")
    service.shutdown()
    if service.oplog is not None:
        service.oplog.close()
    elif oplog is not None:
        oplog.close()
    if service.cluster is not None:
        service.cluster.close()
    if metrics_server is not None:
        metrics_server.close()
    log.info("drain complete; exiting")
