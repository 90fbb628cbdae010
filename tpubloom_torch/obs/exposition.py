"""Prometheus text-format (exposition format 0.0.4) rendering.

One render = one consistent scrape: counters and histogram buckets come
from a locked snapshot of the server's :class:`Metrics`, per-filter
gauges are read under each filter's op lock (so a gauge never reads a
donated mid-update device buffer), and the process-global counters are
merged in. No client library — the format is 30 lines of text, and the
environment must not grow dependencies.

Metric catalog (all prefixed ``tpubloom_``):

* ``keys_inserted_total`` / ``keys_queried_total`` / ... — every server
  counter, rendered as ``tpubloom_<name>_total``.
* ``rpc_duration_seconds`` — per-RPC latency histogram (log2 buckets,
  1us..~67s), labels ``{method}``.
* ``rpc_phase_seconds`` — the phase breakdown histogram, labels
  ``{method, phase}`` for decode/host_prep/h2d/kernel/d2h/encode.
* ``filter_fill_ratio`` / ``filter_bits_set`` / ``filter_estimated_fpr``
  / ``filter_predicted_fpr`` / ``filter_fpr_drift`` /
  ``filter_keys_inserted`` / ``filter_keys_queried`` /
  ``filter_layers`` — per-filter gauges, label ``{filter}``.
* ``shard_fill_ratio`` — per-shard fill, labels ``{filter, shard}``.
* ``checkpoint_lag_inserts`` / ``checkpoint_age_seconds`` /
  ``checkpoint_last_duration_seconds`` / ``checkpoint_seq`` /
  ``checkpoints_written_total`` — checkpoint gauges, label ``{filter}``.
* ``slowlog_entries`` / ``slowlog_recorded_total`` — slowlog state.
* ``uptime_seconds``, plus every process-global counter (e.g.
  ``geometry_probe_demotions_total``, ``faults_injected_total``,
  ``ckpt_corrupt_detected_total``) and every process-global gauge
  (e.g. ``client_breaker_state``: 0 closed / 1 half-open / 2 open).
* robustness counters: ``requests_shed_total``,
  ``delete_dedup_hits_total``, ``restores_with_corrupt_generations_total``.
* replication (process-global): gauges ``repl_log_seq`` /
  ``repl_log_bytes`` / ``repl_log_segments`` /
  ``repl_connected_replicas`` / ``repl_max_replica_lag_seq`` (primary),
  ``repl_lag_seq`` / ``repl_lag_seconds`` (replica),
  ``retry_after_ms_current`` / ``monitor_subscribers``; counters
  ``repl_full_resyncs_total`` / ``repl_partial_resyncs_total`` /
  ``repl_records_streamed_total`` / ``repl_records_applied_total`` /
  ``repl_records_skipped_total`` / ``repl_reconnects_total`` /
  ``repl_log_torn_tail_truncated_total`` / ``monitor_events_dropped_total``.
* synchronous replication: per-replica gauges
  ``repl_acked_seq{replica}`` / ``repl_replica_cursor{replica}`` (from
  the primary's connected sessions), the ``wait_blocked_current``
  process gauge (commit-barrier + Wait waiters currently blocked), the
  ``wait_barrier_seconds`` histogram (time spent blocked on replica
  acks), and counters ``repl_acks_received_total`` /
  ``repl_acks_sent_total`` / ``repl_acks_dropped_total`` /
  ``quorum_writes_acked_total`` / ``quorum_write_failures_total``.
"""

from __future__ import annotations

import math
from typing import Iterable

from tpubloom_torch.obs import counters as _global

PREFIX = "tpubloom"

#: filter ``stats()`` field -> (gauge suffix, help text). Fields a filter
#: variant doesn't report are simply skipped.
_FILTER_GAUGES = {
    "fill_ratio": ("filter_fill_ratio", "Fraction of bits set"),
    "bits_set": ("filter_bits_set", "Number of bits set"),
    "estimated_fpr": (
        "filter_estimated_fpr",
        "FPR estimated from the observed fill ratio (fill^k)",
    ),
    "predicted_fpr": (
        "filter_predicted_fpr",
        "Analytic FPR predicted from n_inserted ((1-e^{-kn/m})^k)",
    ),
    "fpr_drift": (
        "filter_fpr_drift",
        "estimated_fpr - predicted_fpr (observed-vs-model drift)",
    ),
    "n_inserted": ("filter_keys_inserted", "Keys inserted into the filter"),
    "n_queried": ("filter_keys_queried", "Keys queried against the filter"),
    "n_layers": ("filter_layers", "Layer count (scalable filters)"),
}

_CKPT_GAUGES = {
    "lag_inserts": (
        "checkpoint_lag_inserts",
        "Inserts since the last checkpoint trigger",
    ),
    "age_seconds": (
        "checkpoint_age_seconds",
        "Seconds since the last checkpoint landed in the sink",
    ),
    "last_duration_seconds": (
        "checkpoint_last_duration_seconds",
        "Wall time of the last checkpoint serialize+write",
    ),
    "seq": ("checkpoint_seq", "Sequence number of the newest checkpoint"),
    "checkpoints_written": (
        "checkpoints_written_total",
        "Checkpoints successfully written",
    ),
}


def _escape(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace('"', '\\"')
    )


def _fmt(value: float) -> str:
    if value != value:  # NaN
        return "NaN"
    if value == math.inf:
        return "+Inf"
    if value == -math.inf:
        return "-Inf"
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, int) or float(value).is_integer():
        return str(int(value))
    return repr(float(value))


def _line(name: str, value: float, labels: dict | None = None) -> str:
    if labels:
        body = ",".join(f'{k}="{_escape(v)}"' for k, v in labels.items())
        return f"{PREFIX}_{name}{{{body}}} {_fmt(value)}"
    return f"{PREFIX}_{name} {_fmt(value)}"


def _header(out: list, name: str, kind: str, help_text: str) -> None:
    out.append(f"# HELP {PREFIX}_{name} {help_text}")
    out.append(f"# TYPE {PREFIX}_{name} {kind}")


def _render_histogram(
    out: list,
    name: str,
    series: Iterable[tuple[dict, dict]],
    bucket_bounds_us: list,
    help_text: str,
    *,
    exemplars: bool = False,
) -> None:
    """``series`` = iterable of (labels, {counts, total_us, n,
    exemplars?}). With ``exemplars=True`` each bucket line carries its
    OpenMetrics exemplar (``# {rid="..."} value ts``) when one was
    recorded — the rid links the bucket to the matching slowlog entry /
    trace span (request the view with
    ``/metrics?exemplars=1``, stock 0.0.4 scrapes stay untouched)."""
    wrote_header = False
    for labels, hist in series:
        if not wrote_header:
            _header(out, name, "histogram", help_text)
            wrote_header = True
        bucket_exemplars = hist.get("exemplars") or {}
        cum = 0
        for i, count in enumerate(hist["counts"]):
            cum += count
            le = (
                _fmt(bucket_bounds_us[i] / 1e6)
                if i < len(bucket_bounds_us)
                else "+Inf"
            )
            line = _line(f"{name}_bucket", cum, {**labels, "le": le})
            ex = bucket_exemplars.get(i) if exemplars else None
            if ex is None and exemplars:
                ex = bucket_exemplars.get(str(i))  # msgpack/json round trips
            if ex is not None:
                line += (
                    f' # {{rid="{_escape(ex["rid"])}"}} '
                    f'{_fmt(ex["value_s"])} {_fmt(ex["ts"])}'
                )
            out.append(line)
        out.append(_line(f"{name}_sum", hist["total_us"] / 1e6, labels))
        out.append(_line(f"{name}_count", hist["n"], labels))


def render_service(service, *, exemplars: bool = False) -> str:
    """Render a full scrape for a live ``BloomService``.

    Duck-typed on: ``service.metrics.export()``, ``service.slowlog``, and
    ``service.gauge_snapshot()`` (see ``server/service.py``).
    ``exemplars=True`` annotates the RPC latency buckets with their
    newest request id (OpenMetrics exemplar syntax) — the same rid the
    slowlog keeps, so a latency spike walks straight to its request.
    """
    met = service.metrics.export()
    out: list[str] = []

    _header(out, "uptime_seconds", "gauge", "Server process uptime")
    out.append(_line("uptime_seconds", met["uptime_s"]))

    for name in sorted(met["counters"]):
        _header(out, f"{name}_total", "counter", f"Server counter {name}")
        out.append(_line(f"{name}_total", met["counters"][name]))

    process_counters = _global.global_counters()
    for name in sorted(process_counters):
        _header(out, f"{name}_total", "counter", f"Process counter {name}")
        out.append(_line(f"{name}_total", process_counters[name]))

    process_gauges = _global.global_gauges()
    for name in sorted(process_gauges):
        _header(out, name, "gauge", f"Process gauge {name}")
        out.append(_line(name, process_gauges[name]))

    bounds = met["bucket_bounds_us"]
    _render_histogram(
        out,
        "rpc_duration_seconds",
        (
            ({"method": m}, h)
            for m, h in sorted(met["latency"].items())
        ),
        bounds,
        "End-to-end RPC latency by method",
        exemplars=exemplars,
    )
    _render_histogram(
        out,
        "rpc_phase_seconds",
        (
            ({"method": key.split("/", 1)[0], "phase": key.split("/", 1)[1]}, h)
            for key, h in sorted(met["phases"].items())
        ),
        bounds,
        "Per-RPC phase breakdown (decode/host_prep/h2d/kernel/d2h/encode)",
        exemplars=exemplars,
    )
    waits = met.get("waits")
    if waits and waits.get("n"):
        _render_histogram(
            out,
            "wait_barrier_seconds",
            [({}, waits)],
            bounds,
            "Time spent blocked on replica acks (commit barrier + Wait)",
        )
    hydrations = met.get("hydrations")
    if hydrations and hydrations.get("n"):
        _render_histogram(
            out,
            "storage_hydration_seconds",
            [({}, hydrations)],
            bounds,
            "Tenant hydration latency (storage paging fault)",
        )

    gauge_headers_done: set[str] = set()

    def gauge(suffix: str, help_text: str, value, labels: dict) -> None:
        if value is None:
            return
        if suffix not in gauge_headers_done:
            kind = "counter" if suffix.endswith("_total") else "gauge"
            _header(out, suffix, kind, help_text)
            gauge_headers_done.add(suffix)
        out.append(_line(suffix, value, labels))

    for snap in service.gauge_snapshot():
        labels = {"filter": snap["filter"]}
        for field, (suffix, help_text) in _FILTER_GAUGES.items():
            value = snap["stats"].get(field)
            if isinstance(value, (int, float)):
                gauge(suffix, help_text, value, labels)
        for shard, fill in enumerate(snap.get("shard_fill") or []):
            gauge(
                "shard_fill_ratio",
                "Per-shard fraction of bits set",
                fill,
                {**labels, "shard": str(shard)},
            )
        for field, (suffix, help_text) in _CKPT_GAUGES.items():
            value = (snap.get("checkpoint") or {}).get(field)
            if isinstance(value, (int, float)):
                gauge(suffix, help_text, value, labels)

    # per-replica replication gauges: the primary's connected
    # sessions, labeled by the replica's announced address. Deduped by
    # label keeping the NEWEST session — a replica that reconnected
    # before its old stream was reaped would otherwise emit the same
    # series twice, and Prometheus rejects a scrape with duplicate
    # samples wholesale
    sessions = getattr(service, "repl_sessions", None)
    if sessions is not None:
        by_label: dict = {}
        for sess in sessions.describe():
            label = sess.get("listen") or sess.get("peer") or "?"
            prev = by_label.get(label)
            if prev is None or sess.get("connected_at", 0) >= prev.get(
                "connected_at", 0
            ):
                by_label[label] = sess
        for label, sess in sorted(by_label.items()):
            labels = {"replica": label}
            gauge(
                "repl_acked_seq",
                "Newest op seq this replica has acknowledged as applied",
                sess.get("acked"),
                labels,
            )
            gauge(
                "repl_replica_cursor",
                "Newest op seq streamed to this replica",
                sess.get("cursor"),
                labels,
            )

    _header(out, "slowlog_entries", "gauge", "Entries currently in the slowlog")
    out.append(_line("slowlog_entries", len(service.slowlog)))
    _header(
        out,
        "slowlog_recorded_total",
        "counter",
        "Requests ever considered by the slowlog",
    )
    out.append(_line("slowlog_recorded_total", service.slowlog.total_recorded))

    return "\n".join(out) + "\n"


def parse_families(text: str) -> dict[str, dict[tuple, float]]:
    """Tiny exposition-format parser for tests and the smoke benchmark:
    ``{metric_name: {(sorted label items): value}}``. Not a validating
    parser — just enough structure to assert on a scrape."""
    families: dict[str, dict[tuple, float]] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name_part, _, value_part = line.rpartition(" ")
        if "{" in name_part:
            name, _, label_body = name_part.partition("{")
            label_body = label_body.rstrip("}")
            labels = []
            for item in _split_labels(label_body):
                k, _, v = item.partition("=")
                labels.append((k, v.strip('"')))
            key = tuple(sorted(labels))
        else:
            name, key = name_part, ()
        value = float(value_part)
        families.setdefault(name, {})[key] = value
    return families


def _split_labels(body: str) -> list[str]:
    """Split ``a="x",b="y"`` on commas outside quotes."""
    items, depth_quote, start = [], False, 0
    for i, ch in enumerate(body):
        if ch == '"' and (i == 0 or body[i - 1] != "\\"):
            depth_quote = not depth_quote
        elif ch == "," and not depth_quote:
            items.append(body[start:i])
            start = i + 1
    if body[start:]:
        items.append(body[start:])
    return items
