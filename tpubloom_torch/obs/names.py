"""Central catalog of every counter/gauge name the process emits.

Before this module the metric vocabulary lived wherever the ``incr``/
``set_gauge``/``metrics.count`` call sites happened to be — a typo'd
name minted a brand-new series nobody's dashboards watched, and a
renamed one silently orphaned the old series. This catalog is the
single declaration point: ``python -m tpubloom.analysis.lint`` verifies
that every literal metric name used anywhere in ``tpubloom/`` is
declared here EXACTLY ONCE (and in the right kind), and that every
declared name is actually emitted somewhere — so the catalog can't rot
into wishful documentation.

Names built at runtime (per-fault, per-method, per-replica series)
can't be checked literal-by-literal; their shapes are declared in
:data:`DYNAMIC_PREFIXES` so the exposition layer and dashboards still
have one place to look.

Declaration rules the lint enforces:

* a name appears in exactly one of :data:`COUNTERS` / :data:`GAUGES`;
* every literal first argument to ``counters.incr``, ``metrics.count``
  (counter kind) or ``counters.set_gauge`` (gauge kind) in
  ``tpubloom/`` is declared under that kind;
* every declared name has at least one emit site in ``tpubloom/``.
"""

from __future__ import annotations

#: Monotone event counts (rendered as Prometheus ``counter``).
COUNTERS = (
    "blackbox_records_dropped",
    "blackbox_records_written",
    "breaker_closed",
    "breaker_opened",
    "ckpt_corrupt_detected",
    "ckpt_quarantine_evicted",
    "ckpt_restore_read_errors",
    "client_ask_redirects",
    "client_moved_redirects",
    "client_primary_redirects",
    "client_replica_fallbacks",
    "client_slot_refreshes",
    "client_topology_pushes",
    "client_topology_refreshes",
    "cluster_ask_redirects",
    "cluster_filters_migrated",
    "cluster_forward_dups",
    "cluster_forward_entries_expired",
    "cluster_forward_failures",
    "cluster_forwards",
    "cluster_migrate_installs",
    "cluster_migrate_snapshots_sent",
    "cluster_migrate_tail_records",
    "cluster_migrations_completed",
    "cluster_moved_redirects",
    "cms_keys_incremented",
    "cuckoo_full_rejections",
    "cuckoo_kicks_total",
    "delete_dedup_hits",
    "faults_injected",
    "filters_created",
    "flight_dumps_written",
    "flight_events_recorded",
    "geometry_probe_compiles",  # lint: allow(metric-registry): the reference's TPU geometry chooser compiles Mosaic probes; the Hopper kernels have no sweep window to choose, so the port keeps the name for /metrics parity and never emits it
    "geometry_probe_demotions",  # lint: allow(metric-registry): a demotion is the reference's geometry chooser falling back after a failed probe compile; the port has no chooser, so the name stays for /metrics parity and is never emitted
    "ha_demotions",
    "ha_promotions",
    "ha_role_transitions",
    "ingest_clear_flushes",
    "ingest_delete_flushes",
    "ingest_fallback_direct",
    "ingest_flushes",
    "ingest_fused_flushes",
    "ingest_keys_coalesced",
    "ingest_plain_flushes",
    "ingest_query_flushes",
    "ingest_requests_coalesced",
    "ingest_split_flushes",
    "insert_dedup_hits",
    "keys_deleted",
    "keys_inserted",
    "keys_queried",
    "log_failstop_rejected",
    "monitor_events_dropped",
    "query_gather_launches",  # lint: allow(metric-registry): the reference counts each blocked query by the path it took (sweep or gather); the port has one query kernel, counted as query_sweep_launches (filter.py _query), so this stays 0 for /metrics parity
    "query_sweep_launches",
    "quorum_stale_acks",
    "quorum_write_failures",
    "quorum_writes_acked",
    "readonly_rejected",
    "repl_ack_decode_errors",
    "repl_ack_stream_reopened",
    "repl_acks_dropped",
    "repl_acks_received",
    "repl_acks_sent",
    "repl_batched_frames_received",
    "repl_bootstrap_partial_resyncs",
    "repl_full_resyncs",
    "repl_log_append_errors",
    "repl_log_corrupt_dropped",
    "repl_log_torn_tail_truncated",
    "repl_log_truncations",
    "repl_partial_resyncs",
    "repl_reconnects",
    "repl_records_applied",
    "repl_records_reappended",
    "repl_records_skipped",
    "repl_records_streamed",
    "repl_replay_applied",
    "repl_snapshots_installed",
    "repl_stream_batched_bytes_raw",
    "repl_stream_batched_bytes_wire",
    "repl_stream_batched_frames",
    "repl_stream_cut_identity_rotated",
    "requests_shed",
    "restores_with_corrupt_generations",
    "sentinel_failovers",
    "sentinel_failovers_adopted",
    "sentinel_fenced",
    "sentinel_odown_agreed",
    "sentinel_sdown_entered",
    "sentinel_topology_pushes",
    "sentinel_votes_granted",
    "stale_epoch_rejected",
    "storage_evictions_total",
    "storage_hydrations_shed",
    "storage_hydrations_total",
    "storage_warm_demotions",
    "stream_acks_total",
    "stream_credit_shrinks",
    "stream_credit_throttles",
    "stream_frame_dedup_hits",
    "stream_frames_total",
    "topk_heap_updates",
    "trace_requests_sampled",
    "trace_spans_recorded",
)

#: Last-write-wins levels (rendered as Prometheus ``gauge``).
GAUGES = (
    "client_breaker_state",
    "cluster_config_epoch",
    "cluster_slots_importing",
    "cluster_slots_migrating",
    "cluster_slots_owned",
    "ha_epoch",
    "ha_role",
    "ingest_parked_current",
    "monitor_subscribers",
    "repl_connected_replicas",
    "repl_lag_seconds",
    "repl_lag_seq",
    "repl_log_bytes",
    "repl_log_segments",
    "repl_log_seq",
    "repl_max_replica_lag_seq",
    "retry_after_ms_current",
    "sentinel_known_replicas",
    "sentinel_last_election_votes",
    "sentinel_sdown",
    "storage_cold_filters",
    "storage_resident_bytes",
    "storage_resident_filters",
    "storage_warm_bytes",
    "storage_warm_filters",
    "stream_connected_current",
    "trace_buffer_spans",
    "wait_blocked_current",
)

#: Per-request phase spans (the counter-registry pattern
#: extended to the phase vocabulary). Every literal name passed to
#: ``obs.phase(...)`` / ``ctx.add_phase(...)`` must be declared here;
#: the lint's ``phase-registry`` check closes both directions so the
#: slowlog, ``bench.py``'s ``e2e_phases`` tail and the per-phase
#: latency histograms keep naming the same stages. Semantics are
#: documented where the spans are minted: :mod:`tpubloom_torch.obs.context`.
PHASES = (
    "decode",
    "host_prep",
    "h2d",
    "kernel",
    "kernel_query",
    "d2h",
    "encode",
)

#: Phase names minted at runtime, prefix-declared like the metric
#: DYNAMIC_PREFIXES below: the pattern and where it comes from.
PHASE_DYNAMIC_PREFIXES = (
    ("kernel_shard", "per-device mesh-launch completion phases "
     "(tpubloom.parallel.sharded, ROADMAP 1(c)) — kernel_shard<i> is "
     "the time from fence start to device i's completion; the first "
     "jump names the straggler"),
)

#: Distributed-tracing span vocabulary (the phase-registry
#: pattern extended to spans). Every literal name passed to
#: ``trace.span(...)`` / ``trace.record_span(...)`` must be declared
#: here; the lint's ``trace-registry`` check closes both directions so
#: ``TraceGet`` trees, the ``/trace`` view and dashboards keep naming
#: the same stages. Semantics:
#:
#: * ``client.hop``      — one client-side RPC attempt window (Python
#:   ``BloomClient._rpc`` incl. every cluster MOVED/ASK hop and
#:   migration re-drive; attrs name the method + dialed address)
#: * ``ingest.park``     — a request waiting in the coalescer's queue
#:   for its flush to complete (child of the request's root span)
#: * ``ingest.flush``    — ONE coalesced flush (its own trace id;
#:   ``links`` name every parked request's root span, so N-to-1
#:   batching stays explainable; kernel phases + the barrier are its
#:   children)
#: * ``ingest.stream_recv`` — one streamed data frame's receive-and-
#:   park window on the bidi ingest plane: decode through
#:   park (or inline direct-path completion), under the FRAME's rid so
#:   the flush's links still resolve; attrs carry method/seq/parked
#: * ``barrier.wait``    — the synchronous-replication commit barrier
#:   (direct path: child of the request; coalesced: child of the flush)
#: * ``cluster.forward`` — a migration dual-write forward to the slot's
#:   import target
#: * ``repl.apply``      — a replica applying one op-log record, stamped
#:   with the ORIGIN rid (attrs carry seq/method/filter)
#: * ``storage.hydrate`` / ``storage.evict`` — tenant paging transitions
#:   on the faulting request's path
#: * ``sentinel.vote_down`` / ``sentinel.promote`` /
#:   ``sentinel.topology`` — one failover election's RPCs:
#:   the leading sentinel records a span per peer vote
#:   request, per Promote attempt and per AnnounceTopology push, all
#:   under one election trace id (``Sentinel.last_election_rid``), so
#:   an election is traceable span-by-span, not just as one flight
#:   event. Spilled to the black box — elections are crash forensics
#:   by definition.
#:
#: ``client.call`` is deliberately ABSENT from this registry: it is the
#: synthetic shared root ``trace.assemble`` fabricates client-side so a
#: multi-hop MOVED/ASK/re-drive call renders as one tree — it is never
#: emitted into any ring, so it has no emit site to close over.
SPANS = (
    "client.hop",
    "ingest.park",
    "ingest.flush",
    "ingest.stream_recv",
    "barrier.wait",
    "cluster.forward",
    "repl.apply",
    "storage.hydrate",
    "storage.evict",
    "sentinel.vote_down",
    "sentinel.promote",
    "sentinel.topology",
)

#: Span names minted at runtime, prefix-declared like the phase/metric
#: dynamic prefixes: the pattern and where it comes from.
SPAN_DYNAMIC_PREFIXES = (
    ("rpc.", "per-RPC server root spans — rpc.<Method> is the whole "
     "handler window (tpubloom.obs.trace.finish_request; attrs carry "
     "filter/slot/batch/seq/verdict code)"),
    ("phase.", "the obs.context phase timers promoted to child spans "
     "— phase.<name> for every name in PHASES/PHASE_DYNAMIC_PREFIXES "
     "(tpubloom.obs.trace.commit_children)"),
)

#: Profiler-range vocabulary (the trace-registry pattern extended to
#: the ``torch.profiler`` ranges of :class:`tpubloom_torch.obs.context.
#: Range`): a range is named ``tpubloom_torch.<name>``, and every
#: literal ``tpubloom_torch.`` name passed to ``Range(...)`` or
#: ``.child(...)`` has its ``<name>`` declared here; the lint's
#: ``range-registry`` check closes both directions. Semantics:
#:
#: * ``filter.<method>`` — one call of a filter's entry point
#:   (``tpubloom_torch/filter.py``); the staged and batch methods' phases
#:   and the kernel wrappers' ranges nest inside
#: * ``sweep.plan``    — a kernel wrapper's planning on the host: the
#:   kernel's choice (crossover), the scratch plan asked of the C library,
#:   the library lookup
#: * ``sweep.alloc``   — the wrapper's ``torch.empty`` of verdicts and scratch
#: * ``sweep.enqueue`` — the device guard, the stream and the ``ctypes``
#:   call into the C entry: every kernel, memset and runtime call of the
#:   wrapper's call lies inside it
RANGES = (
    "filter.insert_arrays",
    "filter.include_arrays",
    "filter.clear",
    "filter.insert_batch",
    "filter.include_batch",
    "filter.insert_packed",
    "filter.include_packed",
    "filter.stage_batch",
    "filter.launch_insert",
    "filter.launch_query",
    "sweep.plan",
    "sweep.alloc",
    "sweep.enqueue",
)

#: Range names minted per call site or at runtime, prefix-declared like
#: the span prefixes: the pattern and where it comes from.
RANGE_DYNAMIC_PREFIXES = (
    ("sweep.", "one call of a public kernel wrapper of tpubloom_torch.ops."
     "sweep, sweep.<wrapper> (routed calls under the same name); its own "
     "time is the tensor checks, its children sweep.plan / sweep.alloc / "
     "sweep.enqueue"),
    ("phase.", "the obs.context phase timers on the profiler's clock — "
     "phase.<name> for every name in PHASES/PHASE_DYNAMIC_PREFIXES, with "
     "or without a request"),
)

#: Flight-recorder event vocabulary: the lifecycle events
#: ``tpubloom.obs.flight.note`` records — rare, structured, dumped to
#: JSON on SIGTERM / fatal / DEGRADED-flip / on demand. Same
#: trace-registry closure as SPANS.
#:
#: * ``shed``           — an admission or hydration-quota shed
#: * ``breaker``        — a client circuit-breaker state flip
#: * ``role_change``    — promotion / demotion (attrs: role, epoch)
#: * ``election``       — a sentinel failover election completed
#: * ``migration``      — a slot migration started / finalized
#: * ``eviction``       — the storage tier paged a tenant out
#: * ``health``         — the Health status flipped (attrs: status,
#:   reasons) — the DEGRADED flip also triggers a dump
#: * ``oplog_failstop`` — an op-log append error fail-stopped writes
#:   (also triggers a dump: this is the "fatal" case)
#: * ``drain``          — SIGTERM/SIGINT drain began (dump follows)
#: * ``boot``           — the process came up (attrs: role, epoch,
#:   addr) — an aircraft recorder logs power-on; with the black box
#:   every state dir's ring carries at least this, so a
#:   post-mortem can anchor "which process wrote these final events"
#: * ``stream``         — a bidi ingest stream's lifecycle:
#:   ``phase=connect`` on open, ``phase=kill`` when the
#:   transport/fault path breaks the stream mid-flight, and
#:   ``phase=replay`` when a reconnected client's re-sent frame is
#:   answered from the rid-dedup cache — the three beats a post-mortem
#:   needs to see exactly-once replay actually happen
EVENTS = (
    "shed",
    "breaker",
    "role_change",
    "election",
    "migration",
    "eviction",
    "health",
    "oplog_failstop",
    "drain",
    "boot",
    "stream",
)

#: Shapes of names minted at runtime (not literal-checkable): the
#: pattern, its kind, and where it comes from.
DYNAMIC_PREFIXES = (
    ("fault_", "counter", "per-point injection counts (tpubloom.faults)"),
    ("stream_", "counter", "per-streaming-RPC open counts (service wrapper)"),
    ("cluster_slot_keys_total_", "counter",
     "per-slot key traffic on keyed RPCs (service wrapper, cluster "
     "mode) — the load signal slot rebalancing should follow"),
)

COUNTER_SET = frozenset(COUNTERS)
GAUGE_SET = frozenset(GAUGES)
