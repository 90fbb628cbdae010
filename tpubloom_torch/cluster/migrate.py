"""Live slot migration — source-side driver.

Moving slot S from node A (owner) to node B reuses the resync
machinery node→node: each filter in S ships as one
``ckpt.snapshot_blob`` stamped with the source-log seq it covers, and
everything after that seq reaches B through **dual-write forwarding** —
the same "snapshot + tail" shape the primary→replica full resync uses,
with the op-log tail taking over when a migration resumes.

The protocol, per slot:

1. **Mark** — A sets ``migrating[S] = B`` locally and pushes
   ``importing[S] = A`` to B (``ClusterSetSlot``). From here on, A
   answers ``ASK S B`` for filters of S it does not hold, and B serves
   S only for ``asking``-flagged requests.
2. **Per filter** — under the filter's op lock A snapshots the blob,
   records ``snap_seq`` (the filter's applied source-log seq), and arms
   the dual-write forward *before releasing the lock*: every mutating
   RPC that commits after the snapshot forwards to B (original rid +
   its ``src_seq``) before it is acked, so no acked write can exist
   only on A. The blob then installs on B (``MigrateInstall``), which
   seeds B's exactly-once gate at ``snap_seq``.

   **Resume** (the SIGKILL-the-source case): if B already holds the
   filter from an interrupted migration, A probes its gate base and —
   when the source log still has that cursor — replays just the op-log
   tail for that filter instead of re-shipping the blob. Records the
   snapshot or an earlier delivery already covers are skipped by B's
   seq gate; concurrent duplicate deliveries share the original rid, so
   the rid-dedup cache keeps counting filters from double-applying.
3. **Finalize** — B adopts ownership at ``epoch+1`` (``ClusterSetSlot
   node``), then A does; A now answers ``MOVED S B`` and retires its
   local copies with logged drops (so A's shard replicas drop them
   too). Forward entries stay armed for straggling in-flight writes —
   they land on B as ordinary (owner-served) writes.

Fault points: ``cluster.migrate_send`` fires before every install/tail
send on the source; ``cluster.migrate_apply`` fires in the target's
``MigrateInstall``/gated-forward paths.

Known limitation (deliberate scope cut, tracked in ROADMAP item 1):
forwards are exactly-once (seq gate + rid dedup) but NOT commit-order
serialized — they run per-RPC outside all locks. Two concurrent writes
to the SAME key from different clients inside one migration window
(e.g. an insert racing a delete on a counting filter) can therefore
apply in opposite orders on source and target and settle differently.
This is an app-level race even without migration (the filter lock
arbitrates it invisibly); Redis sidesteps it by blocking the key during
MIGRATE, which this design trades away for a non-blocking window.
Workloads that need cross-client same-key ordering should quiesce those
keys during a rebalance.
"""

from __future__ import annotations

import logging

import grpc

from tpubloom_torch import faults
from tpubloom_torch.cluster import slots as slots_mod
from tpubloom_torch.obs import counters as _counters
from tpubloom_torch.obs import flight as obs_flight
from tpubloom_torch.obs import trace as obs_trace
from tpubloom_torch.server import protocol

log = logging.getLogger("tpubloom.cluster")

#: gRPC budget for one snapshot install (blobs can be filter-sized).
INSTALL_TIMEOUT_S = 120.0
FORWARD_TIMEOUT_S = 30.0


def migrate_slot(service, slot: int, target: str) -> dict:
    """Drive the migration of one slot to ``target`` (the
    ``MigrateSlot`` handler body; runs synchronously in the RPC
    thread, like Redis ``MIGRATE``)."""
    cluster = service.cluster
    if not isinstance(slot, int) or not 0 <= slot < slots_mod.NUM_SLOTS:
        raise protocol.BloomServiceError(
            "INVALID_ARGUMENT", f"slot must be in [0, {slots_mod.NUM_SLOTS})"
        )
    if service.oplog is None:
        # the exactly-once handoff is seq-gated by SOURCE-LOG seqs:
        # without a log the dual-write forwards would carry no src_seq
        # and the snapshot-overlap window could double-apply counting
        # filters — refuse, like --min-replicas-to-write does
        raise protocol.BloomServiceError(
            "UNSUPPORTED",
            "slot migration requires an op log on the source (start the "
            "server with --repl-log-dir): dual-write forwards are "
            "exactly-once only when seq-stamped from it",
        )
    if not target or target == cluster.self_addr:
        raise protocol.BloomServiceError(
            "INVALID_ARGUMENT", f"migration target {target!r} must be a "
            f"different node"
        )
    owner = cluster.owner(slot)
    if owner != cluster.self_addr:
        raise protocol.BloomServiceError(
            "MOVED" if owner else "CLUSTERDOWN",
            f"slot {slot} is owned by {owner!r}, not this node",
            details={"slot": slot, "addr": owner},
        )
    # flight recorder: migrations are exactly the lifecycle
    # events a post-mortem of a rebalance gone wrong needs sequenced
    obs_flight.note("migration", slot=int(slot), target=target,
                    stage="start")
    # 1. mark both sides (idempotent on re-drive; the epoch stamp lets
    # an up-to-date target refuse a STALE source's re-opened handoff)
    cluster.set_slot(
        {"slot": slot, "state": "migrating", "addr": target,
         "epoch": cluster.epoch()}
    )
    cluster.call(
        target,
        "ClusterSetSlot",
        {"slot": slot, "state": "importing", "addr": cluster.self_addr,
         "epoch": cluster.epoch()},
    )
    with service._lock:
        tenants = set(service._filters)
    if service.storage is not None:
        # paged tenants belong to the slot too — an evicted
        # filter that silently stayed behind would be unreachable the
        # moment the slot finalizes at the new owner
        tenants.update(service.storage.names())
    names = sorted(n for n in tenants if slots_mod.key_slot(n) == slot)
    stats = {"snapshots": 0, "tail_records": 0}
    for name in names:
        _migrate_filter(service, name, target, stats)
    # 3. finalize: target first (Redis SETSLOT NODE order), then local —
    # between the two flips both nodes route traffic to the target
    new_epoch = cluster.epoch() + 1
    cluster.call(
        target,
        "ClusterSetSlot",
        {"slot": slot, "state": "node", "addr": target, "epoch": new_epoch},
    )
    cluster.set_slot(
        {"slot": slot, "state": "node", "addr": target, "epoch": new_epoch}
    )
    # 4. retire the local copies with LOGGED drops (shard replicas drop
    # too). Forward entries stay armed: an in-flight write that raced
    # the flip still reaches the target.
    for name in names:
        try:
            service.DropFilter({"name": name, "final_checkpoint": False})
        except protocol.BloomServiceError:
            log.exception("retiring migrated filter %r failed", name)
    _counters.incr("cluster_migrations_completed")
    _counters.incr("cluster_filters_migrated", len(names))
    obs_flight.note("migration", slot=int(slot), target=target,
                    stage="finalized", epoch=int(new_epoch),
                    filters=len(names))
    log.info(
        "slot %d migrated to %s at epoch %d (%d filter(s), %d snapshot(s), "
        "%d tail record(s))",
        slot, target, new_epoch, len(names), stats["snapshots"],
        stats["tail_records"],
    )
    return {
        "ok": True,
        "slot": slot,
        "target": target,
        "epoch": new_epoch,
        "filters_moved": len(names),
        **stats,
    }


def _migrate_filter(service, name: str, target: str, stats: dict) -> None:
    """Move one filter: resume via the op-log tail when the target
    already holds it, else snapshot + arm the dual-write."""
    from tpubloom_torch import checkpoint as ckpt

    cluster = service.cluster
    faults.fire("cluster.migrate_send")
    base = None
    try:
        probe = cluster.call(
            target, "MigrateInstall", {"name": name, "probe": True}
        )
        base = probe.get("have")
    except (grpc.RpcError, protocol.BloomServiceError):
        base = None
    # storage-aware lookup (control plane — never quota-shed):
    # a paged tenant hydrates for its handoff — the snapshot-under-op-
    # lock + dual-write arming below need the live filter. (Hydrate-on-
    # MOVED — handing off the checkpoint POINTER for a COLD tenant
    # instead of streaming the blob — is the documented stretch, not
    # built yet.)
    mf = service._resident(name)
    if mf is None:
        return  # dropped concurrently — nothing to move
    oplog = service.oplog
    if base is not None and oplog is not None and oplog.has_cursor(int(base)):
        # resume: the target's gate says its state covers the source log
        # up to `base` and the log still holds the tail — arm the
        # dual-write FIRST (everything committed after this line
        # forwards live), then replay the gap. Overlap between the two
        # is absorbed by the target's seq gate.
        cluster.begin_forwarding(name, target)
        head = oplog.last_seq
        n = 0
        for rec in oplog.read_from(int(base)):
            if rec["seq"] > head:
                break
            if rec["req"].get("name") != name:
                continue
            if rec["method"] not in protocol.MUTATING_METHODS:
                continue
            faults.fire("cluster.migrate_send")
            _forward_record(cluster, target, rec)
            n += 1
        stats["tail_records"] += n
        _counters.incr("cluster_migrate_tail_records", n)
        return
    # snapshot path: blob + seq stamp + forward arming are one atomic
    # step under the op lock — a write serialized after the snapshot is
    # by construction a write the wrapper will forward
    with mf.lock:
        _, _, blob = ckpt.snapshot_blob(mf.filter)
        snap_seq = mf.applied_seq
        cluster.begin_forwarding(name, target)
    faults.fire("cluster.migrate_send")
    cluster.call(
        target,
        "MigrateInstall",
        {"name": name, "blob": blob, "src_seq": snap_seq},
        timeout=INSTALL_TIMEOUT_S,
    )
    stats["snapshots"] += 1
    _counters.incr("cluster_migrate_snapshots_sent")


def _forward_record(cluster, target: str, rec: dict) -> None:
    """Replay one source-log record on the target as an ``asking``
    request in the original rid, stamped with its source seq for the
    exactly-once gate."""
    req = {
        k: v
        for k, v in rec["req"].items()
        if k not in ("restored_seq", "epoch")
    }
    req["asking"] = True
    req["src_seq"] = rec["seq"]
    if rec.get("rid"):
        req["rid"] = rec["rid"]
    cluster.call(target, rec["method"], req, timeout=FORWARD_TIMEOUT_S)


def forward_op(service, method: str, req: dict, resp: dict) -> dict:
    """Dual-write hook, called by the RPC wrapper AFTER a mutating RPC
    committed (and cleared its durability barrier, outside all locks):
    when the filter is mid-migration, the op must land on the target
    BEFORE the client is acked — an acked write existing only on the
    source is exactly the loss the handoff must exclude.

    A forward failure fails the RPC with ``MIGRATE_FORWARD_FAILED``
    (``applied: true`` — Redis WAIT-style: the local apply stands). The
    client retries under the same rid: the source answers the replay
    from its dedup cache / idempotent apply and this hook forwards
    again; the target's seq gate + rid dedup make the re-delivery
    exactly-once."""
    cluster = service.cluster
    name = req.get("name")
    if cluster is None or not isinstance(name, str):
        return resp
    target = cluster.forward_target(name)
    if target is None:
        return resp
    fwd = {
        k: v
        for k, v in req.items()
        if k not in ("epoch", "min_replicas", "min_replicas_timeout_ms",
                     "asking", "src_seq", "restored_seq")
    }
    fwd["asking"] = True
    if resp.get("repl_seq") is not None:
        fwd["src_seq"] = int(resp["repl_seq"])
    try:
        # the dual-write hop is part of the request's latency story —
        # a child span names the target so "where did my write spend
        # 30ms" has an answer during migration windows
        with obs_trace.span("cluster.forward", target=target):
            cluster.call(target, method, fwd, timeout=FORWARD_TIMEOUT_S)
    except (grpc.RpcError, protocol.BloomServiceError) as e:
        _counters.incr("cluster_forward_failures")
        details = {"applied": True, "target": target}
        if fwd.get("src_seq") is not None:
            # the re-drive needs the record's seq: if the handoff
            # finalizes mid-re-drive, the MOVED follow-up applies at
            # the new owner and MUST carry src_seq or a record the
            # snapshot already contains would apply twice
            details["src_seq"] = fwd["src_seq"]
        raise protocol.BloomServiceError(
            "MIGRATE_FORWARD_FAILED",
            f"{method} applied locally but its migration forward to "
            f"{target} failed ({e}); retry under the same rid",
            details=details,
        )
    _counters.incr("cluster_forwards")
    resp["forwarded"] = True
    return resp
