"""MONITOR-parity live op stream (the ROADMAP follow-up).

Redis ``MONITOR`` turns a connection into a firehose of every command
the server executes. Here the equivalent is the server-streaming
``Monitor`` RPC: the RPC wrapper publishes one event per finished
request into this hub, and each subscriber drains its own bounded queue
— a slow monitor client loses *its own* oldest events (counted in
``monitor_events_dropped``) instead of back-pressuring the data plane,
which is strictly better than Redis (a slow MONITOR client grows the
server's output buffer until the server kills it).

Subscriptions optionally filter by filter name (``{"name": "urls"}``),
which Redis MONITOR cannot do — the per-key-namespace view falls out of
having structured events instead of raw command text.

Event shape: ``{"kind": "op", "ts", "method", "name", "rid", "batch",
"duration_s", "ok"}``. The stream opens with ``{"kind": "hello"}`` (the
``+OK`` MONITOR ack — subscribers know they are live before the first
event) and idles with ``{"kind": "heartbeat"}`` ticks.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from typing import Optional

from tpubloom_torch.obs import counters as _counters
from tpubloom_torch.utils import locks

#: Per-subscriber buffered events before drop-oldest kicks in.
DEFAULT_QUEUE_DEPTH = 1024


class MonitorHub:
    """Fan-out of op events to bounded per-subscriber queues."""

    def __init__(self, queue_depth: int = DEFAULT_QUEUE_DEPTH):
        self.queue_depth = queue_depth
        self._lock = locks.named_lock("repl.monitor_hub")
        self._ids = itertools.count()
        #: sub id -> (queue, name filter or None)
        self._subs: dict[int, tuple["queue.Queue", Optional[str]]] = {}

    @property
    def active(self) -> bool:
        """Cheap pre-check so the RPC wrapper pays one attribute read per
        request while nobody is monitoring."""
        return bool(self._subs)

    def subscribe(self, name: Optional[str] = None) -> int:
        q: "queue.Queue" = queue.Queue(maxsize=self.queue_depth)
        with self._lock:
            sid = next(self._ids)
            self._subs[sid] = (q, name)
        _counters.set_gauge("monitor_subscribers", len(self._subs))
        return sid

    def unsubscribe(self, sid: int) -> None:
        with self._lock:
            self._subs.pop(sid, None)
        _counters.set_gauge("monitor_subscribers", len(self._subs))

    def get(self, sid: int, timeout: float) -> Optional[dict]:
        with self._lock:
            entry = self._subs.get(sid)
        if entry is None:
            return None
        try:
            return entry[0].get(timeout=timeout)
        except queue.Empty:
            return None

    def publish(self, event: dict) -> None:
        """Deliver to every matching subscriber; never blocks the caller
        (drop-oldest per subscriber on overflow)."""
        with self._lock:
            subs = list(self._subs.values())
        for q, name in subs:
            if name is not None and event.get("name") != name:
                continue
            while True:
                try:
                    q.put_nowait(event)
                    break
                except queue.Full:
                    try:
                        q.get_nowait()
                        _counters.incr("monitor_events_dropped")
                    except queue.Empty:
                        pass


def monitor_stream(service, req: dict, context, *, heartbeat_s: float = 1.0):
    """Generator behind the ``Monitor`` RPC: hello, then ops as they
    happen, heartbeats while idle; ends when the client cancels or the
    server drains."""
    hub: MonitorHub = service.monitor_hub
    sid = hub.subscribe(req.get("name") or None)
    try:
        yield {"kind": "hello", "ts": time.time(), "filter": req.get("name")}
        while context.is_active() and not service.draining:
            event = hub.get(sid, timeout=heartbeat_s)
            if event is not None:
                yield event
            else:
                yield {"kind": "heartbeat", "ts": time.time()}
    finally:
        hub.unsubscribe(sid)
