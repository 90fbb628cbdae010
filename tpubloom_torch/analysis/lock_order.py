"""Declared lock-ORDER manifest vs. the runtime acquisition graph.

A stdlib-only copy of ``tpubloom/analysis/lock_order.py`` aimed at the
port. The armed tracker (:mod:`tpubloom_torch.utils.locks`) records every
``a → b`` acquisition edge and flags cycles. But a cycle only appears
once BOTH orders exist — a brand-new edge that will deadlock against
next month's code lands silently. So the intended lock ordering is
DECLARED here, and any runtime edge outside the manifest is a finding:
new nesting is a reviewed design decision, not an accident.

The manifest is a set of ``(outer, inner)`` lock-CLASS pairs (the names
given to :func:`tpubloom_torch.utils.locks.named_lock` and friends,
which are the reference's names). It equals the reference's manifest
apart from the edges in :data:`DIFFERS_FROM_REFERENCE`, each with the
reason the port differs; every declared edge carries the one-line
reason (the minting code path) it exists. ``cluster.state`` stays a
leaf apart from its gauge updates: nothing may be acquired under it,
because migration forwards do network IO.

Checking:

* :func:`diff_edges` / :func:`check_report` / :func:`check_live` —
  library API over a tracker report;
* ``python -m tpubloom_torch.analysis.lock_order [report.json|dir ...]``
  — operator CLI over ``lockcheck-*.json`` exit reports
  (``$TPUBLOOM_LOCK_CHECK_DIR``); exit 1 on undeclared edges. ``--list``
  prints the manifest;
* ``python -m tpubloom_torch.analysis`` — the unified check folds this
  diff and the static tree lint into one exit code.

Growing the manifest is the point, not a failure: when a new edge is
legitimate, add it here together with the code that mints it.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Iterable, Optional

#: The declared acquisition order: (outer, inner) = "inner may be
#: acquired while outer is held". Everything else is a finding.
#:
#: A speculatively-declared edge is a place a real cycle can hide, so
#: every edge carries the one-line reason it exists (the code path that
#: mints it); an edge you cannot annotate is an edge you should not
#: declare. Edges deliberately absent: ``repl.applier_call ->
#: {filter.op, repl.oplog, service.registry, ckpt.trigger,
#: faults.registry}`` (records apply OUTSIDE the applier's call lock —
#: it guards only the stream/ack handles), ``repl.sessions ->
#: repl.oplog`` (ReplStream reads the log head BEFORE entering the
#: sessions condition), and ``X -> obs.counters`` for faults.registry,
#: obs.slowlog, service.dedup, ckpt.trigger, ckpt.redis_sink,
#: repl.monitor_hub, repl.ack_sender, sentinel.topo_events and
#: cluster.client (their counters are bumped outside their lock regions).
ALLOWED_EDGES = frozenset(
    {
        # -- op-log commit points: the append happens under the
        #    lock its op committed under
        # handlers append from _log_op inside `with mf.lock`
        ("filter.op", "repl.oplog"),
        # _log_create / DropFilter append inside the registry lock (a
        # concurrent create/drop of the same name must serialize with
        # the record order)
        ("service.registry", "repl.oplog"),
        # -- the checkpoint-keyed truncation sweep (every 64 appends,
        #    _maybe_truncate_log) runs from _log_op — i.e. under the
        #    committing filter's op lock — and:
        # ...snapshots the registry for the per-filter landed floors.
        # The REVERSE order must never be declared: registry holders
        # always release before taking an op lock (create/drop/gauge
        # walks), which is what keeps this a DAG
        ("filter.op", "service.registry"),
        # ...bounds GC by the slowest replica's cursor —
        # repl_sessions.min_cursor() takes the sessions condition.
        # Reachable on every 64th append, even where no armed test
        # has crossed the boundary on one filter yet
        ("filter.op", "repl.sessions"),
        # ...counts repl_log_truncations via Metrics.count (obs.metrics
        # lock) while the op lock is still held
        ("filter.op", "obs.metrics"),
        # notify_inserts/trigger take the trigger lock at the handler
        # commit point, under the filter's op lock
        ("filter.op", "ckpt.trigger"),
        # -- counters under commit/bookkeeping locks (each one a
        #    deliberate "incr while held" site, not a blanket allowance)
        # handlers count keys/dedup hits + log-append errors while the
        # op lock is held
        ("filter.op", "obs.counters"),
        # create/drop count filters_created etc. inside the registry
        ("service.registry", "obs.counters"),
        # registry-held walks (gauge_snapshot) file per-filter gauges
        ("service.registry", "obs.metrics"),
        # OpLog._update_gauges_locked sets repl_log_* gauges inside the
        # log condition on every append/truncate
        ("repl.oplog", "obs.counters"),
        # shed/admission accounting inside the admit lock
        ("service.admit", "obs.counters"),
        # Metrics methods (count/observe/snapshot) read global counters
        # while holding the metrics registry lock
        ("obs.metrics", "obs.counters"),
        # the client breaker counts state flips inside its lock
        ("client.breaker", "obs.counters"),
        # topology adoption counts pushes/refreshes under client.topology
        ("client.topology", "obs.counters"),
        # wait_acked maintains the wait_blocked_current gauge inside the
        # sessions condition
        ("repl.sessions", "obs.counters"),
        # repl_ack_stream_reopened incremented under the applier's call
        # lock when the ack stream is found broken
        ("repl.applier_call", "obs.counters"),
        # sentinel SDOWN/vote/failover accounting under sentinel.state
        ("sentinel.state", "obs.counters"),
        # slot-ownership gauges set inside cluster.state
        ("cluster.state", "obs.counters"),
        # parked-request gauge + coalesce counters inside the queue
        # condition
        ("ingest.queue", "obs.counters"),
        # -- fault points firing inside commit sections (the fire()
        #    armed-path takes faults.registry to consume the policy
        #    budget; reachable whenever a point is armed under a held
        #    commit lock — chaos suites do exactly that)
        # shard.*/ingest fault points fire under the filter op lock
        ("filter.op", "faults.registry"),
        # OpLog.append fires repl.append inside the log condition
        ("repl.oplog", "faults.registry"),
        # registry-held appends (_log_create, DropFilter) transit the
        # same repl.append firing with the registry still held
        ("service.registry", "faults.registry"),
        # -- replication plumbing: the applier's call lock
        #    guards the stream/ack HANDLES (records apply outside it)
        # opening/closing an _AckSender under the call lock touches the
        # ack sender's coalescing condition
        ("repl.applier_call", "repl.ack_sender"),
        # -- promotion / demotion re-plumb the service under the
        #    promote lock
        # rebuild_manifest + epoch adoption walk the registry
        ("service.promote", "service.registry"),
        # become_replica's take-every-lock write fence
        ("service.promote", "filter.op"),
        # op-log adoption (OpLog open/set_alias) under the promote lock
        ("service.promote", "repl.oplog"),
        # demotion stops / promotion starts the applier (its call lock)
        ("service.promote", "repl.applier_call"),
        # ...and the applier teardown closes the ack sender
        ("service.promote", "repl.ack_sender"),
        # role transitions count promotions/demotions while still
        # holding the promote lock
        ("service.promote", "obs.counters"),
        # become_replica counts ha_demotions through Metrics (the
        # obs.metrics lock) while still holding the promote lock
        ("service.promote", "obs.metrics"),
        # the demotion barrier drains parked coalesced writes under the
        # promote lock (become_replica — see ingest.drain_parked, which
        # deliberately POLLS instead of waiting on the condition)
        ("service.promote", "ingest.queue"),
        # -- storage tier: the residency manager's
        #    bookkeeping lock is a LEAF apart from counter/gauge
        #    updates — it is never held across a filter/registry lock,
        #    a device launch, or blob IO (hydration waiters block on a
        #    plain event holding nothing; the eviction critical section
        #    reuses the pre-existing filter.op -> service.registry
        #    unpublish edge)
        # gauge/counter updates inside _update_gauges_locked /
        # _trim_warm_locked run under storage.state
        ("storage.state", "obs.counters"),
        # the checkpoint-keyed truncation sweep (under the committing
        # filter's op lock, see filter.op -> service.registry above)
        # reads the PAGED tenants' durable floor too
        ("filter.op", "storage.state"),
        # _create/_drop re-check "does the storage tier still know this
        # tenant" UNDER the registry lock (the hydrate-then-create
        # TOCTOU guard: an eviction between the caller's hydrate and
        # this lock must retry, not rebuild fresh over paged state).
        # Cycle-free: storage code never acquires the registry while
        # holding storage.state (publishes/unpublishes happen outside
        # its bookkeeping lock)
        ("service.registry", "storage.state"),
        # become_replica's demotion barrier drains in-flight
        # hydrations/evictions (drain_busy — polls on purpose), the
        # promotion path folds paged tenants into rebuild_manifest and
        # the adopted-seq computation — all under service.promote
        ("service.promote", "storage.state"),
        # -- cluster mode: the migration snapshots
        #    under the filter lock and arms the dual-write there;
        #    cluster.state itself is a LEAF apart from gauge updates —
        #    node→node RPCs always run outside it.
        #    Sharded filters through the coalescer add NO new edges
        #    by design: the per-shard chaos surface is fault
        #    POINTS (shard.*), not locks — the staged launches fire
        #    them under the existing filter.op -> faults.registry edge,
        #    and the replicated H2D staging is lock-free (verified by
        #    the armed test_ingest module's manifest diff)
        ("filter.op", "cluster.state"),
    }
)


#: Edges of the reference's manifest (``tpubloom/analysis/lock_order.py``)
#: that the port does not declare, each with the reason.
DIFFERS_FROM_REFERENCE = {
    ("filter.op", "native.build"): "the port has no native key packer "
    "(its pack_keys is a numpy scatter), so no native.build lock exists",
}


def diff_edges(edges: Iterable[tuple]) -> list:
    """Runtime edges not covered by the manifest, as finding dicts."""
    findings = []
    for edge in sorted(set(map(tuple, edges))):
        if tuple(edge) not in ALLOWED_EDGES:
            findings.append(
                {
                    "kind": "undeclared-lock-edge",
                    "edge": list(edge),
                    "message": (
                        f"runtime acquisition {edge[0]!r} -> {edge[1]!r} "
                        f"is not in the declared lock-order manifest "
                        f"(tpubloom_torch/analysis/lock_order.py) — declare it "
                        f"deliberately or fix the nesting"
                    ),
                }
            )
    return findings


def edges_of_report(report: dict) -> list:
    """``[(from, to), ...]`` out of one lockcheck report dict (the
    :func:`tpubloom_torch.utils.locks.report` shape / exit-report JSON)."""
    return [(e["from"], e["to"]) for e in report.get("edges", ())]


def check_report(report: dict) -> list:
    return diff_edges(edges_of_report(report))


def check_live() -> list:
    """Diff the in-process tracker's graph (armed test sessions)."""
    from tpubloom_torch.utils import locks

    return check_report(locks.report())


def _iter_report_paths(paths: Iterable[str]) -> list:
    out = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(glob.glob(os.path.join(p, "lockcheck-*.json"))))
        else:
            out.append(p)
    return out


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tpubloom_torch.analysis.lock_order",
        description="diff runtime lock-acquisition graphs against the "
        "declared lock-order manifest",
    )
    parser.add_argument(
        "paths", nargs="*",
        help="lockcheck-*.json reports (or directories of them); default: "
        "$TPUBLOOM_LOCK_CHECK_DIR",
    )
    parser.add_argument(
        "--list", action="store_true", dest="list_manifest",
        help="print the declared manifest and exit",
    )
    parser.add_argument("--json", action="store_true", dest="as_json")
    args = parser.parse_args(argv)
    if args.list_manifest:
        for outer, inner in sorted(ALLOWED_EDGES):
            print(f"{outer} -> {inner}")
        return 0
    paths = args.paths or [os.environ.get("TPUBLOOM_LOCK_CHECK_DIR", "")]
    paths = [p for p in paths if p]
    if not paths:
        parser.error("no report paths given and TPUBLOOM_LOCK_CHECK_DIR unset")
    findings: list = []
    n_reports = 0
    for path in _iter_report_paths(paths):
        try:
            with open(path) as f:
                report = json.load(f)
        except (OSError, ValueError) as e:
            findings.append(
                {
                    "kind": "unreadable-report",
                    "message": f"{path}: {e}",
                }
            )
            continue
        n_reports += 1
        for finding in check_report(report):
            findings.append({**finding, "report": path})
    if args.as_json:
        print(json.dumps(findings, indent=2))
    else:
        for f in findings:
            print(f"[{f['kind']}] {f['message']}"
                  + (f"  ({f['report']})" if "report" in f else ""))
        print(
            f"tpubloom_torch.analysis.lock_order: {len(findings)} finding(s) "
            f"across {n_reports} report(s)"
        )
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
