"""Flight recorder — a bounded ring of structured lifecycle
events that survives to a JSON dump when the process is about to stop
being observable.

Post-mortem debugging of chaos failures used to depend on scraping a
LIVE ``/metrics`` endpoint: once the process died (SIGKILL mid-chaos, a
drain, an OOM) the sequence of sheds, breaker flips, role changes,
elections, migrations and evictions that led there was gone. This ring
keeps the last N lifecycle events (they are RARE — this is not a
request log) and dumps them:

* on **SIGTERM** (the server's drain handler),
* on a **fatal** write-path fail-stop (op-log append error),
* on a **Health DEGRADED flip** (SERVING -> DEGRADED),
* **on demand** — the metrics HTTP thread serves ``GET /flight`` and
  :func:`dump` is callable from anywhere.

Event kinds are DECLARED in :data:`tpubloom_torch.obs.names.EVENTS` — the
lint's ``trace-registry`` check closes both directions, so a typo'd
kind can't silently mint an unknown series and a declared kind nobody
emits rots loudly.

The ring itself is lock-free: events append to a ``collections.deque``
(maxlen-bounded; CPython appends are atomic), and snapshots via
``list(deque)`` are consistent enough for a post-mortem artifact. The
ONE lock :func:`note` touches is the ``obs.counters`` leaf (the
``flight_events_recorded`` counter) — so a call site holding some lock
``X`` needs the ``X -> obs.counters`` edge declared in the lock-order
manifest. Every current site either holds no lock or holds one whose
counters edge is already declared (filter.op, service.promote,
client.breaker, sentinel.state); a NEW note() under a lock that never
touched counters must declare its edge or move the note outside.

Dump directory resolution: :func:`configure` (the server points it at
its state dir), else the ``TPUBLOOM_FLIGHT_DIR`` environment variable —
which is how the CI chaos shards collect every subprocess server's
dumps as one artifact without touching each test harness.

The ring is also DURABLE: when
:func:`tpubloom_torch.obs.blackbox.configure` armed the crash-forensics black
box (servers do it for their state dir), every :func:`note` writes
through to an mmap'd, CRC-framed ring file that survives SIGKILL — the
deque stays as the live view (``GET /flight``, dumps), the mapped ring
is what a post-mortem reads out of a dead node. The write-through is
lock-free like the deque append, so the locking contract above is
unchanged.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import time
from collections import deque
from typing import Optional

from tpubloom_torch.obs import blackbox as obs_blackbox
from tpubloom_torch.obs import counters as obs_counters

log = logging.getLogger("tpubloom.obs")

#: env var naming the dump directory when no explicit configure() ran
#: (mirrors TPUBLOOM_LOCK_CHECK_DIR: CI pins it inside the workspace so
#: every subprocess server's dumps survive as artifacts)
DUMP_DIR_ENV = "TPUBLOOM_FLIGHT_DIR"

DEFAULT_CAPACITY = 512

_events: deque = deque(maxlen=DEFAULT_CAPACITY)
_dump_dir: Optional[str] = None
#: atomic dump sequence (itertools.count.__next__ is atomic in
#: CPython) — concurrent dumps (two threads hitting the fatal path at
#: once) must get distinct file AND tmp names, never interleave into
#: one
_dump_seq = itertools.count(1)


def configure(
    dump_dir: Optional[str] = None, capacity: Optional[int] = None
) -> None:
    global _events, _dump_dir
    if dump_dir is not None:
        _dump_dir = dump_dir
    if capacity is not None and capacity != _events.maxlen:
        _events = deque(_events, maxlen=int(capacity))


def note(kind: str, **attrs) -> None:
    """Record one lifecycle event. ``kind`` must be declared in
    :data:`tpubloom_torch.obs.names.EVENTS`; ``attrs`` are JSON-safe scalars
    (the caller casts). Cheap: a lock-free deque append plus one
    ``obs.counters`` incr — see the module docstring before calling
    this under a lock the manifest has no counters edge for."""
    ev: dict = {"ts": time.time(), "kind": kind}
    if attrs:
        ev["attrs"] = attrs
    _events.append(ev)
    # crash-forensics write-through: when the black box is
    # armed, the event also lands in the mmap'd ring — still lock-free
    # (atomic seq reservation + one slice assignment), so this path
    # stays safe under every lock the docstring above names. A SIGKILL
    # now loses at most the record being copied, not the whole ring.
    obs_blackbox.note_event(ev)
    obs_counters.incr("flight_events_recorded")


def snapshot() -> list:
    """Copy of the ring, oldest first."""
    return [dict(e) for e in list(_events)]


def dump(reason: str, extra: Optional[dict] = None) -> Optional[str]:
    """Write the ring to ``flight-<pid>-<reason>-<n>.json`` in the
    configured dump dir (or ``$TPUBLOOM_FLIGHT_DIR``); returns the path
    or None when no directory is known / the write failed. Best-effort
    by design — a dump must never turn a drain into a crash."""
    directory = _dump_dir or os.environ.get(DUMP_DIR_ENV)
    if not directory:
        return None
    n = next(_dump_seq)
    path = os.path.join(
        directory, f"flight-{os.getpid()}-{reason}-{n}.json"
    )
    payload = {
        "pid": os.getpid(),
        "ts": time.time(),
        "reason": reason,
        "events": snapshot(),
    }
    if extra:
        payload["extra"] = extra
    try:
        os.makedirs(directory, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}.{n}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=1, default=str)
        os.replace(tmp, path)
    except OSError:
        log.exception("flight-recorder dump to %s failed", path)
        return None
    obs_counters.incr("flight_dumps_written")
    return path


def reset_for_tests() -> None:
    global _dump_dir, _dump_seq
    _events.clear()
    _dump_dir = None
    _dump_seq = itertools.count(1)
