"""Replica→primary promotion and primary→replica demotion: the port of
``tpubloom/ha/promotion.py``, answer for answer.

``promote_to_primary`` is the heart of the HA story: it flips a running
read-only replica into a write-accepting primary by **adopting the op
log** —

* a **chained** replica (``--replica-of`` + ``--repl-log-dir``) already
  re-appends every applied record to its own log in the upstream's seq
  space, so promotion just stops the applier and starts accepting
  writes: the log is the log. The upstream's log identity is recorded
  as an **alias** (Redis replid2 parity) valid up to the promotion
  point, so survivors of the old primary partial-resync instead of
  paying a full resync;
* a **bare** replica opens a fresh log seeded at its applied seq (the
  caller supplies ``repl_log_dir``); survivors exactly as caught up
  partial-resync through the alias, everyone else full-resyncs.

Either way the **topology epoch** bumps and persists beside the adopted
log (:class:`tpubloom_torch.ha.topology.EpochStore`): the promotion is
fencing-grade durable — a later restart still knows it won epoch N, and
an older primary restarting with epoch < N is demoted on sight by any
sentinel (``ReplicaOf``). Passing ``epoch`` pins the value (the sentinel
quorum's agreed epoch); a stale pin is rejected with ``STALE_EPOCH``
(Raft's "term wins arguments" discipline — a vote from epoch N-1 cannot
move a node that has seen N).

``become_replica`` is the inverse (Redis ``REPLICAOF host port``): fence
writes immediately, re-point (or start) the applier, carry the cursor so
the link can partial-resync. A demoted old primary keeps its log; if it
diverged past the promotion point, the alias window check forces the
full resync that discards the divergent tail.

Fault point ``ha.promote`` fires before any state changes.
"""

from __future__ import annotations

import logging
import threading

from tpubloom_torch import faults
from tpubloom_torch.ha.topology import EpochStore
from tpubloom_torch.obs import blackbox as obs_blackbox
from tpubloom_torch.obs import counters as _counters
from tpubloom_torch.obs import flight as obs_flight

log = logging.getLogger("tpubloom_torch.ha")


def _role_gauges(service) -> None:
    _counters.set_gauge("ha_role", 1.0 if service.read_only else 0.0)
    _counters.set_gauge("ha_epoch", float(service.epoch))


def promote_to_primary(service, *, repl_log_dir=None, epoch=None) -> dict:
    """Flip ``service`` (a read-only replica) to primary; idempotent on
    an existing primary. See the module docstring for the contract."""
    from tpubloom_torch.server import protocol

    faults.fire("ha.promote")
    with service._promote_lock:
        if epoch is not None and int(epoch) <= service.epoch:
            if not service.read_only and int(epoch) == service.epoch:
                # the exact promotion that made us primary, replayed
                # (sentinel retry): answer it idempotently
                return {
                    "ok": True,
                    "already_primary": True,
                    "epoch": service.epoch,
                    "log_id": service.oplog.log_id if service.oplog else None,
                }
            raise protocol.BloomServiceError(
                "STALE_EPOCH",
                f"promotion epoch {epoch} is not newer than the current "
                f"epoch {service.epoch}",
                details={"epoch": service.epoch},
            )
        if not service.read_only:
            if epoch is not None:
                service.adopt_epoch(int(epoch))
            return {
                "ok": True,
                "already_primary": True,
                "epoch": service.epoch,
                "log_id": service.oplog.log_id if service.oplog else None,
            }

        applier = service.replica_applier
        upstream_id = None
        if applier is not None:
            upstream_id = applier.log_id
            applier.stop()
        if service.storage is not None:
            # a tenant mid-eviction is in NEITHER tier — not
            # in the registry (unpublished) and its storage entry's
            # applied_seq/create_req not yet filed — so the adopted-seq
            # max below and rebuild_manifest would both miss it. Settle
            # in-flight transitions first (same discipline as
            # become_replica's demotion barrier).
            service.storage.drain_busy()
        with service._lock:
            mfs = list(service._filters.values())
        adopted = max(
            [applier.cursor or 0 if applier is not None else 0]
            + [mf.applied_seq for mf in mfs]
            + [service.oplog.last_seq if service.oplog is not None else 0]
            # paged tenants' history counts too: a bare
            # replica's fresh log must not mint seqs below an evicted
            # tenant's applied state
            + [service.storage.max_applied_seq()
               if service.storage is not None else 0]
        )

        if service.oplog is None:
            if not repl_log_dir:
                raise protocol.BloomServiceError(
                    "NO_LOG_DIR",
                    "promotion needs an op log: start the replica with "
                    "--repl-log-dir (chained) or pass repl_log_dir in the "
                    "Promote request",
                )
            from tpubloom_torch.repl import OpLog

            service.oplog = OpLog(repl_log_dir, start_seq=adopted)
            service._manifest_dir = service.oplog.directory
            service.rebuild_manifest()
            service.oplog.set_alias(upstream_id, adopted)
        else:
            # chained: the local log IS the adopted log (same seq space
            # as the upstream) — alias its identity up to our head so
            # old-primary cursors stay partially resumable
            service.oplog.set_alias(upstream_id, service.oplog.last_seq)

        store = EpochStore(service.oplog.directory)
        new_epoch = (
            int(epoch)
            if epoch is not None
            else max(service.epoch, store.load()) + 1
        )
        service._epoch_store = store
        service.adopt_epoch(new_epoch)

        service.read_only = False
        service._stream_fed = False  # handlers own the log again
        service.replica_applier = None
        service.primary_address = None
        _counters.incr("ha_role_transitions")
        _counters.incr("ha_promotions")
        # flight recorder: role flips are the spine of any
        # failover post-mortem (note() under the promote lock only
        # touches obs.counters — the declared service.promote ->
        # obs.counters edge, same as the incrs above)
        obs_flight.note("role_change", role="primary", epoch=int(new_epoch))
        # black-box node identity: post-promotion records in
        # the mapped ring must carry the new role + epoch
        obs_blackbox.set_node_meta(role="primary", epoch=int(new_epoch))
        _role_gauges(service)
        log.info(
            "promoted to primary: epoch %d, adopted seq %d, log %s (%s)",
            new_epoch, adopted, service.oplog.directory,
            service.oplog.log_id,
        )
        service.metrics.count("ha_promotions")
        return {
            "ok": True,
            "already_primary": False,
            "epoch": new_epoch,
            "adopted_seq": adopted,
            "log_id": service.oplog.log_id,
        }


def become_replica(service, primary_address: str, *, epoch=None) -> dict:
    """Point ``service`` at ``primary_address`` as a read-only replica
    (Redis ``REPLICAOF host port``): fences writes immediately, then
    re-points (or starts) the stream applier carrying the current cursor
    so the link partial-resyncs when the new primary's log (or its
    post-promotion alias) still covers it."""
    from tpubloom_torch.repl.replica import ReplicaApplier, ReplicaStateStore
    from tpubloom_torch.server import protocol

    with service._promote_lock:
        if epoch is not None:
            if int(epoch) < service.epoch:
                raise protocol.BloomServiceError(
                    "STALE_EPOCH",
                    f"ReplicaOf epoch {epoch} is older than the current "
                    f"epoch {service.epoch}",
                    details={"epoch": service.epoch},
                )
            service.adopt_epoch(int(epoch))
        old = service.replica_applier
        if (
            service.read_only
            and old is not None
            and old.primary_address == primary_address
            and old.link != "stopped"
        ):
            return {
                "ok": True,
                "unchanged": True,
                "primary": primary_address,
                "epoch": service.epoch,
            }
        was_primary = not service.read_only
        # fence FIRST: from this moment every mutating RPC answers
        # READONLY (pointing at the new primary), even while the old
        # applier is still draining
        service.read_only = True
        service.primary_address = primary_address
        if was_primary:
            # drain the in-flight writers that passed the READONLY check
            # before the fence: each holds its filter lock (or the
            # registry lock for create/drop) across apply AND log, so
            # taking every lock once is a barrier — after it, every
            # acked write is in the log. Only THEN may the applier take
            # the log over (reappend preserves the upstream seq space;
            # a handler appending after that would mint a conflict).
            if service.storage is not None:
                # a write that passed the READONLY check may
                # still be WAITING on a tenant hydration — its filter
                # lock does not exist yet, so the take-every-lock
                # barrier below cannot cover it. Settle in-flight
                # hydrations/evictions first; the straggler then hits
                # the write-side fence re-check under the op lock
                # (service._op) and bounces READONLY instead of
                # applying unlogged.
                service.storage.drain_busy()
            with service._lock:
                mfs = list(service._filters.values())
            for mf in mfs:
                with mf.lock:
                    pass
            if service._coalescer is not None:
                # writes PARKED in the ingestion coalescer
                # passed the READONLY check but hold no filter lock yet,
                # so the barrier above does not cover them — drain the
                # queues so their flushes log in the old seq space
                # before the applier takes the log over
                service._coalescer.drain_parked()
        cursor = log_id = None
        if old is not None:
            old.stop()
            cursor, log_id = old.cursor, old.log_id
        elif service.oplog is not None:
            # demoted primary: its log head is exactly its state — if it
            # never diverged past the promotion point, the new primary's
            # alias lets this resume as a partial resync
            cursor, log_id = service.oplog.last_seq, service.oplog.log_id
        if service.replica_state_store is None and service.oplog is not None:
            service.replica_state_store = ReplicaStateStore(
                service.oplog.directory
            )
        applier = ReplicaApplier(
            service,
            primary_address,
            state_store=service.replica_state_store,
            listen_address=service.listen_address,
            initial_cursor=cursor,
            initial_log_id=log_id,
        ).start()
        _counters.incr("ha_role_transitions")
        if was_primary:
            _counters.incr("ha_demotions")
            service.metrics.count("ha_demotions")
        obs_flight.note(
            "role_change", role="replica", primary=primary_address,
            epoch=int(service.epoch), was_primary=bool(was_primary),
        )
        obs_blackbox.set_node_meta(role="replica", epoch=int(service.epoch))
        _role_gauges(service)
        log.info(
            "now replicating from %s (epoch %d, cursor %s, was_primary=%s)",
            primary_address, service.epoch, cursor, was_primary,
        )
        return {
            "ok": True,
            "unchanged": False,
            "primary": primary_address,
            "epoch": service.epoch,
            "was_primary": was_primary,
        }
