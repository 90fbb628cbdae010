"""Background HTTP thread serving ``GET /metrics`` (Prometheus scrape).

A ``ThreadingHTTPServer`` on its own daemon thread — the gRPC data path
never blocks on a scrape; a scrape only contends for the per-filter op
locks while reading gauges (microseconds per filter). ``/healthz``
answers 200 for liveness probes without touching any filter.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

log = logging.getLogger("tpubloom.obs")

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsServer:
    """Own the listener + thread; ``port`` holds the bound port (pass
    port 0 for an ephemeral one — tests and the smoke benchmark do)."""

    def __init__(self, render_fn, port: int = 0, host: str = "0.0.0.0"):
        # probe ONCE whether render_fn takes the exemplars knob — a
        # try/except TypeError at request time would also swallow real
        # TypeErrors raised inside the render and silently serve the
        # un-annotated view
        import inspect

        try:
            has_exemplars_knob = "exemplars" in inspect.signature(
                render_fn
            ).parameters
        except (TypeError, ValueError):  # builtins/partials w/o signature
            has_exemplars_knob = False

        class Handler(BaseHTTPRequestHandler):
            def _send_body(self, body: bytes, content_type: str) -> None:
                self.send_response(200)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, obj) -> None:
                self._send_body(
                    json.dumps(obj, indent=1, default=str).encode(),
                    "application/json",
                )

            def do_GET(self):  # noqa: N802 — http.server API
                path, _, query = self.path.partition("?")
                if path == "/metrics":
                    # ?exemplars=1 opts into the OpenMetrics-style
                    # exemplar annotations; stock
                    # 0.0.4 scrapers keep the unannotated default
                    want_exemplars = (
                        has_exemplars_knob
                        and "exemplars=1" in query.split("&")
                    )
                    try:
                        if want_exemplars:
                            body = render_fn(exemplars=True).encode()
                        else:
                            body = render_fn().encode()
                    except Exception:  # a broken gauge must not 500 forever silently
                        log.exception("metrics render failed")
                        self.send_error(500, "metrics render failed")
                        return
                    self._send_body(body, CONTENT_TYPE)
                elif path == "/healthz":
                    self._send_json({"ok": True})
                elif path == "/trace":
                    # the per-node trace view — the spans this
                    # process recorded for one rid (plus flush spans
                    # that LINK it), same data as the TraceGet RPC
                    from urllib.parse import parse_qs

                    from tpubloom_torch.obs import trace as trace_mod

                    rid = (parse_qs(query).get("rid") or [""])[0]
                    if not rid:
                        self.send_error(400, "try /trace?rid=<request id>")
                        return
                    self._send_json(
                        {
                            "rid": rid,
                            "enabled": trace_mod.enabled(),
                            "spans": trace_mod.get_trace(rid),
                        }
                    )
                elif path == "/flight":
                    # the on-demand flight-recorder view —
                    # the same ring a SIGTERM/fatal/DEGRADED-flip dump
                    # writes to the state dir
                    from tpubloom_torch.obs import flight as flight_mod

                    self._send_json({"events": flight_mod.snapshot()})
                else:
                    self.send_error(
                        404, "try /metrics, /healthz, /trace or /flight"
                    )

            def log_message(self, fmt, *args):  # scrapes are chatty; route to logging
                log.debug("metrics http: " + fmt, *args)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="tpubloom-metrics", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10)


def start_metrics_server(service, port: int = 0, host: str = "0.0.0.0") -> MetricsServer:
    """Serve ``render_service(service)`` at ``http://host:port/metrics``
    (``?exemplars=1`` adds the rid exemplars on latency buckets)."""
    from tpubloom_torch.obs.exposition import render_service

    return MetricsServer(
        lambda exemplars=False: render_service(service, exemplars=exemplars),
        port=port,
        host=host,
    )
