"""Cross-node metrics aggregation.

``python -m tpubloom_torch.obs.aggregate --nodes host:port,host:port,...``
fetches ``/metrics`` from every listed node's exposition endpoint
(:mod:`tpubloom_torch.obs.httpd`) and merges them into ONE scrape target:

* every sample line gains a ``node="host:port"`` label (prepended, so
  existing labels are preserved verbatim — histogram ``le`` included);
* ``# HELP`` / ``# TYPE`` headers are kept once per metric family
  (first node wins; the fleet shares one vocabulary via
  :mod:`tpubloom_torch.obs.names`, so headers agree);
* a synthetic ``tpubloom_aggregate_node_up{node=...} 0|1`` gauge makes
  scrape failures visible instead of silently shrinking the fleet.

Modes: ``--port N`` serves the merged view at ``/metrics`` (one scrape
target for a whole cluster — each fan-out happens per scrape, so the
view is always live); ``--once`` prints a single merged scrape to
stdout and exits (debugging, cron snapshots).

Stdlib only (urllib + the ``MetricsServer`` of
:mod:`tpubloom_torch.obs.httpd`): it touches no tensor and needs no card.
"""

from __future__ import annotations

import argparse
import sys
import urllib.error
import urllib.request
from typing import Optional

DEFAULT_TIMEOUT_S = 5.0


def fetch_metrics(node: str, timeout: float = DEFAULT_TIMEOUT_S) -> str:
    """One node's raw exposition text (``node`` is host:port of its
    ``--metrics-port`` endpoint). Raises on any fetch problem."""
    with urllib.request.urlopen(
        f"http://{node}/metrics", timeout=timeout
    ) as resp:
        return resp.read().decode("utf-8", errors="replace")


def _label_escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def relabel(text: str, node: str) -> list:
    """Sample lines of one scrape with ``node=...`` prepended to each
    label set; comment/blank lines are returned unchanged (the caller
    dedups headers)."""
    out = []
    label = f'node="{_label_escape(node)}"'
    for line in text.splitlines():
        if not line or line.startswith("#"):
            out.append(line)
            continue
        name_part, sep, value_part = line.rpartition(" ")
        if not sep:
            out.append(line)
            continue
        if "{" in name_part:
            name, _, rest = name_part.partition("{")
            out.append(f"{name}{{{label},{rest} {value_part}")
        else:
            out.append(f"{name_part}{{{label}}} {value_part}")
    return out


def merge_scrapes(scrapes: dict) -> str:
    """``{node: exposition text | None}`` → one merged exposition body.
    ``None`` marks an unreachable node (up=0, no samples)."""
    out: list = []
    seen_headers: set = set()
    out.append(
        "# HELP tpubloom_aggregate_node_up 1 when the node's /metrics "
        "answered this scrape"
    )
    out.append("# TYPE tpubloom_aggregate_node_up gauge")
    for node in sorted(scrapes):
        up = scrapes[node] is not None
        out.append(
            f'tpubloom_aggregate_node_up{{node="{_label_escape(node)}"}} '
            f"{1 if up else 0}"
        )
    for node in sorted(scrapes):
        text = scrapes[node]
        if text is None:
            continue
        for line in relabel(text, node):
            if line.startswith("#"):
                # "# HELP <name> ..." / "# TYPE <name> ..." — keep the
                # first node's copy of each
                parts = line.split(None, 3)
                key = tuple(parts[:3])
                if key in seen_headers:
                    continue
                seen_headers.add(key)
            elif not line:
                continue
            out.append(line)
    return "\n".join(out) + "\n"


def aggregate(nodes: list, timeout: float = DEFAULT_TIMEOUT_S) -> str:
    scrapes: dict = {}
    for node in nodes:
        try:
            scrapes[node] = fetch_metrics(node, timeout=timeout)
        except (urllib.error.URLError, OSError, ValueError):
            scrapes[node] = None
    return merge_scrapes(scrapes)


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tpubloom_torch.obs.aggregate",
        description="merge /metrics from many tpubloom nodes into one "
        "scrape target with per-node labels",
    )
    parser.add_argument(
        "--nodes", required=True,
        type=lambda s: [a for a in s.split(",") if a],
        help="comma-separated host:port of each node's --metrics-port",
    )
    parser.add_argument(
        "--port", type=int, default=9464,
        help="serve the merged view at http://0.0.0.0:PORT/metrics "
        "(default 9464; 0 = ephemeral)",
    )
    parser.add_argument(
        "--timeout", type=float, default=DEFAULT_TIMEOUT_S,
        help="per-node fetch timeout in seconds (default 5)",
    )
    parser.add_argument(
        "--once", action="store_true",
        help="print one merged scrape to stdout and exit",
    )
    args = parser.parse_args(argv)
    if args.once:
        sys.stdout.write(aggregate(args.nodes, timeout=args.timeout))
        return 0
    from tpubloom_torch.obs.httpd import MetricsServer

    server = MetricsServer(
        lambda: aggregate(args.nodes, timeout=args.timeout), port=args.port
    )
    print(
        f"aggregating {len(args.nodes)} node(s) at "
        f"http://0.0.0.0:{server.port}/metrics",
        flush=True,
    )
    import threading

    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
