"""Replication & changefeed subsystem.

The reference gem's durability/scale-out story is Redis's: an
append-only op log (AOF), primary→replica streaming (PSYNC), read-only
replicas (``READONLY``), and the ``MONITOR`` firehose. This package is
that story for tpubloom:

* :mod:`tpubloom_torch.repl.record` — CRC32C-framed op records (one per
  mutating RPC, with seq + rid for idempotent replay);
* :mod:`tpubloom_torch.repl.log` — the segmented append-only op log:
  crash-recovery with torn-tail truncation, checkpoint-keyed
  truncation, tailing for live streams;
* :mod:`tpubloom_torch.repl.primary` — the ``ReplStream`` RPC: full resync
  (filter snapshots + tail) or partial resync (cursor still in the
  log), heartbeats, connected-replica accounting;
* :mod:`tpubloom_torch.repl.replica` — the applier behind
  ``--replica-of host:port``: sync, seq-gated idempotent apply,
  reconnect with backoff, lag gauges;
* :mod:`tpubloom_torch.repl.monitor` — the ``Monitor`` RPC (MONITOR parity):
  live per-filter-filterable op stream off the same commit points.

Wiring lives in :mod:`tpubloom_torch.server.service` (log appends at commit
points, startup replay, read-only mode) and
:mod:`tpubloom_torch.server.client` (read-preference routing, READONLY-aware
fallback).
"""

from tpubloom_torch.repl.log import OpLog
from tpubloom_torch.repl.monitor import MonitorHub, monitor_stream
from tpubloom_torch.repl.primary import ReplicaSessions, repl_stream
from tpubloom_torch.repl.record import decode_record, encode_record, scan_buffer
from tpubloom_torch.repl.replica import (
    ReplicaApplier,
    ReplicaStateStore,
    bootstrap_from_local,
)

__all__ = [
    "OpLog",
    "MonitorHub",
    "monitor_stream",
    "ReplicaSessions",
    "repl_stream",
    "ReplicaApplier",
    "ReplicaStateStore",
    "bootstrap_from_local",
    "decode_record",
    "encode_record",
    "scan_buffer",
]
