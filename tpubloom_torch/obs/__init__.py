"""Cross-layer observability subsystem: the port's copy of
``tpubloom/obs``, the same names, series and wire shapes over its own
process-global state (a process may hold both packages' registries).

Parity: the reference gem ships no metrics of its own — operators lean on
Redis ``INFO`` / ``SLOWLOG`` / ``MONITOR`` (SURVEY.md §5). This package is
the replacement for that operator surface, pinned by BASELINE's
observability row: keys inserted/queried, batch sizes, kernel/request
latency, checkpoint lag, fill ratio & predicted FPR — all scrapeable,
without attaching a profiler or running bench archaeology.

Pieces (each importable on its own, stdlib-only except where noted):

* :mod:`tpubloom_torch.obs.context` — thread-local request context + named
  phase timers (decode / host_prep / h2d / kernel / d2h / encode). The
  filter layer records phases into whatever request is active; with no
  active request every span is a no-op, so library users pay ~nothing.
* :mod:`tpubloom_torch.obs.counters` — process-global counters for events that
  happen below the server layer (the sketch kinds' kicks and rejections,
  fault firings, checkpoint corruption), merged into ``/metrics``.
* :mod:`tpubloom_torch.obs.slowlog` — Redis-SLOWLOG-parity ring of the N
  slowest requests (method, args summary, batch, duration, request id,
  phase breakdown), served by the ``SlowlogGet``/``SlowlogReset`` RPCs.
* :mod:`tpubloom_torch.obs.exposition` — Prometheus text-format rendering of
  the server's counters, latency/phase histograms, per-filter and
  checkpoint gauges, and the global counters.
* :mod:`tpubloom_torch.obs.httpd` — the background HTTP thread serving
  ``GET /metrics`` (plus ``/healthz``, ``/trace?rid=`` and
  ``/flight``), enabled by the server's ``--metrics-port`` flag.
* :mod:`tpubloom_torch.obs.trace` — distributed request tracing:
  a Dapper-style span ring keyed on the client rid, behind the
  server's ``--trace-sample`` knob, served by the ``TraceGet`` RPC.
* :mod:`tpubloom_torch.obs.flight` — the flight recorder: a
  bounded lock-free ring of lifecycle events dumped to JSON on
  SIGTERM / fatal / Health-DEGRADED flips and on demand.

Request correlation: the gRPC client stamps every request with a ``rid``
(``BloomClient.last_rid``); the server threads it into
``tracing.annotate`` spans AND the slowlog entry, so a slow request found
in SLOWLOG can be looked up by id in a Perfetto trace of the same window.
"""

from tpubloom_torch.obs.context import (  # noqa: F401
    RequestContext,
    current,
    current_rid,
    new_rid,
    phase,
    request,
)
from tpubloom_torch.obs.counters import global_counters, incr  # noqa: F401
from tpubloom_torch.obs.slowlog import Slowlog, summarize_request  # noqa: F401
