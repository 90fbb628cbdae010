"""Process-global event counters and gauges for layers below a server.

A stdlib-only copy of ``tpubloom/obs/counters.py`` (the port may not import
``tpubloom``). Library code has no handle on a server, so events that must
reach its metrics land here, under the same names as ``tpubloom``'s: the
sketch kinds' ``cuckoo_kicks_total``, ``cuckoo_full_rejections``,
``cms_keys_incremented`` and ``topk_heap_updates``, and the
``faults_injected`` / ``fault_<point>`` counts of
:mod:`tpubloom_torch.faults`.
"""

from __future__ import annotations

from collections import defaultdict

from tpubloom_torch.utils import locks

_lock = locks.named_lock("obs.counters")
_counters: dict[str, int] = defaultdict(int)
_gauges: dict[str, float] = {}


def incr(name: str, n: int = 1) -> None:
    with _lock:
        _counters[name] += n


def get(name: str) -> int:
    with _lock:
        return _counters.get(name, 0)


def global_counters() -> dict[str, int]:
    """Snapshot copy of all process-global counters."""
    with _lock:
        return dict(_counters)


def set_gauge(name: str, value: float) -> None:
    """Process-global gauge (last-write-wins): library-level state that is
    a level, not an event — e.g. the client circuit-breaker state."""
    with _lock:
        _gauges[name] = value


def get_gauge(name: str, default: float = 0.0) -> float:
    with _lock:
        return _gauges.get(name, default)


def global_gauges() -> dict[str, float]:
    """Snapshot copy of all process-global gauges."""
    with _lock:
        return dict(_gauges)


def reset_for_tests() -> None:
    """Zero everything — test isolation only."""
    with _lock:
        _counters.clear()
        _gauges.clear()
