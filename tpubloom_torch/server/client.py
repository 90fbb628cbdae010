"""Python client for the tpubloom gRPC service.

Parity: the Python-native mirror of the Ruby ``:jax`` driver (SURVEY.md §1
layer-map row L1: "Python-native API mirrors it") — same batch surface as
the local :class:`tpubloom_torch.filter.BloomFilter`, but over the wire.

Failure handling (SURVEY.md §5 failure-detection row — "gRPC health check
+ reconnect/backoff"; the reference's redis-rb raises on connection loss
and leaves retry to the caller, the new framework does better):

* ``UNAVAILABLE`` (server down / restarting) is retried with exponential
  backoff + jitter. Safe because every retried op is idempotent — bloom
  insert/query/clear/checkpoint can be replayed freely. ``delete_batch``
  (a counting-filter counter decrement) is retryable too:
  retries reuse the logical call's rid and the server keeps a bounded
  rid→response dedup cache, so a replayed delete that already landed is
  answered from cache instead of double-decrementing.
* ``RESOURCE_EXHAUSTED`` / ``DRAINING`` (overload shed / graceful roll)
  are retried for EVERY method — a shed happens before the handler runs,
  so nothing was applied — pacing off the server's ``retry_after_ms``
  hint when it beats local backoff.
* ``NOT_FOUND`` after a server restart (the new process has not seen the
  filter yet) is healed transparently: the client replays the original
  ``create_filter`` request with ``exist_ok=True, restore=True`` — the
  server restores the newest checkpoint — then retries the op once.
* A **circuit breaker** guards the whole channel: after
  ``breaker_threshold`` consecutive *logical* transport failures (a call
  that exhausted its UNAVAILABLE retries), calls fail fast with
  ``CIRCUIT_OPEN`` for ``breaker_cooldown`` seconds instead of stacking
  more backoff on a dead server; one half-open probe then decides
  between closing and re-opening. Breaker state is exported as the
  process gauge ``client_breaker_state`` (0 closed / 1 half-open /
  2 open).

Replication-awareness:

* **read-preference routing** — construct with ``replicas=[addr, ...],
  read_preference="replica"`` and ``QueryBatch`` traffic round-robins
  over the read replicas (writes ALWAYS go to the primary). A replica
  that fails (down, lagging NOT_FOUND, READONLY confusion) falls back
  to the primary for that call — counted in
  ``client_replica_fallbacks`` — so replica loss degrades to primary
  reads, never to errors.
* **READONLY redirect** — a write answered with ``READONLY`` (the
  configured "primary" is actually a replica, e.g. mid-failover) is
  retried once against the primary address the replica's error details
  advertise (Redis MOVED-style), transparently re-pointing the client.
* **retryable non-idempotent inserts** — counting/scalable/presence
  inserts are now auto-retried on ``UNAVAILABLE`` like DeleteBatch:
  retries reuse the logical call's rid and the server answers a replay
  whose first attempt landed from its rid→response cache instead of
  double-applying. (Older servers do not cache inserts —
  pin ``max_retries=0`` per call-site if you must talk to one.)

Durability (Redis ``WAIT`` / ``min-replicas-to-write``
parity):

* every mutating response carries the op-log ``repl_seq`` of its record
  (tracked as ``self.last_write_seq``); :meth:`BloomClient.wait`
  blocks until N replicas acknowledged it and returns the achieved
  count (WAIT semantics — short counts report, they do not raise);
* ``insert_batch`` / ``delete_batch`` / ``clear`` accept a per-call
  ``min_replicas=`` (+ ``min_replicas_timeout_ms=``): the server blocks
  the RPC after its op-log append until that many replicas acked the
  record. A barrier that times out raises ``NOT_ENOUGH_REPLICAS`` —
  deliberately NOT auto-retried (the write applied and is logged; the
  caller decides whether to re-wait via :meth:`wait`, retry under the
  same rid, or surface the degraded durability).

Observability: every RPC is stamped with a generated request id
(``self.last_rid`` after the call) which the server folds into its
profiler spans and slowlog entries — ``slowlog_get()`` entries carry the
same ids, so a slow call seen client-side can be found server-side.
Retries of one logical call share the rid.
"""

from __future__ import annotations

import queue
import random
import threading
import time
from typing import Optional, Sequence

import grpc
import numpy as np

from tpubloom_torch.obs import counters as obs_counters
from tpubloom_torch.obs import flight as obs_flight
from tpubloom_torch.obs import trace as obs_trace
from tpubloom_torch.obs.context import new_rid
from tpubloom_torch.server import protocol
from tpubloom_torch.utils import locks

#: error codes meaning "the server refused BEFORE running the handler" —
#: replaying is safe for every method, idempotent or not
_SHED_CODES = frozenset({"RESOURCE_EXHAUSTED", "DRAINING"})

#: methods eligible for replica routing under read_preference="replica".
#: Deliberately narrow: Stats/Slowlog are per-host diagnostics (you want
#: the host you asked), Health is a liveness probe of its target.
_REPLICA_READS = frozenset({"QueryBatch"})

_CHANNEL_OPTIONS = list(protocol.CHANNEL_OPTIONS)

_BREAKER_GAUGE = {"closed": 0, "half-open": 1, "open": 2}


def fetch_topology(
    sentinels: Sequence[str], *, timeout: float = 2.0
) -> Optional[dict]:
    """Ask each sentinel for the current cluster view (``SENTINEL
    get-master-addr-by-name`` parity); first answer wins. Returns
    ``{"epoch", "primary", "replicas"}`` or None when no sentinel is
    reachable."""
    for addr in sentinels:
        channel = grpc.insecure_channel(addr)
        try:
            raw = channel.unary_unary(
                protocol.sentinel_method_path("Topology"),
                request_serializer=lambda b: b,
                response_deserializer=lambda b: b,
            )(protocol.encode({}), timeout=timeout)
            resp = protocol.decode(raw)
            if resp.get("ok") and resp.get("primary"):
                return resp
        except grpc.RpcError:
            continue
        finally:
            channel.close()
    return None


class CircuitOpenError(protocol.BloomServiceError):
    """Raised without touching the network while the breaker is open."""

    def __init__(self, address: str, cooldown_left: float):
        super().__init__(
            "CIRCUIT_OPEN",
            f"circuit to {address} is open for another "
            f"{cooldown_left:.2f}s after consecutive transport failures",
        )


class CircuitBreaker:
    """Per-channel fail-fast: K consecutive logical transport failures
    open the circuit for a cooldown; one half-open probe then decides.

    Counts *logical* calls (after each call's own UNAVAILABLE backoff is
    exhausted), not raw attempts — a single patient call riding out a
    restart must not trip the breaker. ``threshold=0`` disables."""

    def __init__(self, threshold: int = 5, cooldown: float = 5.0):
        self.threshold = threshold
        self.cooldown = cooldown
        self._consecutive = 0
        self._state = "closed"
        self._opened_at = 0.0
        self._half_open_at = 0.0
        self._lock = locks.named_lock("client.breaker")
        obs_counters.set_gauge("client_breaker_state", 0)

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _set_state(self, state: str) -> None:
        self._state = state
        obs_counters.set_gauge("client_breaker_state", _BREAKER_GAUGE[state])
        # flight recorder: breaker flips are exactly the
        # lifecycle breadcrumbs a post-mortem of a client-side outage
        # needs (note() under the breaker lock only touches
        # obs.counters — the declared client.breaker -> obs.counters
        # edge, same as the gauge above)
        obs_flight.note("breaker", state=state)

    def check(self, address: str) -> None:
        """Raise :class:`CircuitOpenError` while open; transition to
        half-open (admitting exactly this one probe) once the cooldown
        has elapsed."""
        if not self.threshold:
            return
        with self._lock:
            if self._state == "closed":
                return
            now = time.monotonic()
            if self._state == "open":
                elapsed = now - self._opened_at
                if elapsed >= self.cooldown:
                    self._set_state("half-open")
                    self._half_open_at = now
                    return  # this caller is the probe
                raise CircuitOpenError(address, self.cooldown - elapsed)
            # half-open: one probe at a time — but a probe that vanished
            # without reaching record_* (interrupt, encode error) must not
            # wedge the breaker forever, so a stale probe slot reopens
            # after another cooldown
            elapsed = now - self._half_open_at
            if elapsed >= self.cooldown:
                self._half_open_at = now
                return
            raise CircuitOpenError(address, self.cooldown - elapsed)

    def record_success(self) -> None:
        if not self.threshold:
            return
        with self._lock:
            self._consecutive = 0
            if self._state != "closed":
                self._set_state("closed")
                obs_counters.incr("breaker_closed")

    def record_failure(self) -> None:
        if not self.threshold:
            return
        with self._lock:
            self._consecutive += 1
            tripped = (
                self._state == "half-open"
                or (self._state == "closed"
                    and self._consecutive >= self.threshold)
            )
            if tripped:
                self._set_state("open")
                self._opened_at = time.monotonic()
                obs_counters.incr("breaker_opened")


class ServerStream:
    """Iterable over one server-streaming RPC, decoding each msgpack
    frame; ``cancel()`` tears the stream down (safe mid-iteration)."""

    def __init__(self, call):
        self._call = call

    def __iter__(self):
        for raw in self._call:
            yield protocol.decode(raw)

    def cancel(self) -> None:
        self._call.cancel()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.cancel()


class StreamSession:
    """One live bidi ingest stream: the client half of
    ``InsertStream``/``QueryStream``. Obtain via
    :meth:`BloomClient.insert_stream` / :meth:`BloomClient.query_stream`
    and use as a context manager; :meth:`send` ships one seq-stamped
    frame (blocking only when the server's credit window is exhausted —
    that IS the flow control), acks are consumed by a background reader
    and surfaced through :meth:`result` / :meth:`drain`.

    Exactly-once replay: every frame keeps its ORIGINAL rid for its
    whole lifetime. When the transport dies mid-stream (server SIGKILL,
    network cut), the next ``send``/``drain`` reconnects — refreshing
    the topology first when sentinels are configured — and re-sends
    only the still-unacked frames, in seq order, under those original
    rids; the server's rid→response dedup cache (rebuilt from the op
    log's merged-record ``parts`` across restarts) answers any frame
    whose first flight already applied, so nothing double-applies even
    on counting filters. Reconnects are budgeted like unary retries
    (``client.max_retries``, reset by any successful ack).

    Single-producer: one thread drives ``send``/``drain``/``result``;
    the internal reader is the only other toucher of session state.
    """

    def __init__(self, client: "BloomClient", method: str, name: str,
                 *, defaults: Optional[dict] = None):
        self._client = client
        self._method = method  # "InsertStream" | "QueryStream"
        self._name = name
        self._defaults = dict(defaults or {})
        self._cond = locks.named_condition("client.stream")
        self._seq = 0
        #: seq -> frame dict still awaiting its ack — THE replay source
        self._unacked: dict = {}
        self._results: dict = {}
        self._credit = 0  # 0 until the server's hello grants a window
        self._broken: Optional[BaseException] = None
        self._failed: Optional[BaseException] = None
        self._closed = False
        self._connects = 0
        self._sendq: "queue.Queue" = queue.Queue()
        self._call = None
        self._reader: Optional[threading.Thread] = None
        self._connect()

    # -- transport ------------------------------------------------------------

    def _connect(self) -> None:
        self._sendq = sendq = queue.Queue()

        def frames():
            while True:
                item = sendq.get()
                if item is None:
                    return
                yield item

        call = self._client._bidi_calls[self._method](frames(), timeout=None)
        with self._cond:
            self._call = call
            self._credit = 0
            self._broken = None
        # replay first, in seq order, original rids: these frames were
        # inside the PREVIOUS grant's window, so jumping the fresh
        # hello is at worst a brief over-send the server parks
        for seq in sorted(self._unacked):
            sendq.put(protocol.encode(self._unacked[seq]))
        self._reader = threading.Thread(
            target=self._read_loop, args=(call,),
            name="tpubloom-stream-reader", daemon=True,
        )
        self._reader.start()

    def _read_loop(self, call) -> None:
        client = self._client
        try:
            for raw in call:
                frame = protocol.decode(raw)
                kind = frame.get("kind")
                if kind == "hello":
                    with self._cond:
                        self._credit = max(1, int(frame.get("credit") or 1))
                        self._cond.notify_all()
                    continue
                if kind == "credit":
                    # server-initiated shrink on an idle stream:
                    # adopt the tighter window so the
                    # next burst can't overrun a coalescer other
                    # streams filled while this one sent nothing
                    with self._cond:
                        self._credit = max(1, int(frame.get("credit") or 1))
                        self._cond.notify_all()
                    continue
                if kind != "ack":
                    continue
                resp = frame.get("resp") or {}
                if resp.get("repl_seq") is not None:
                    client.last_write_seq = int(resp["repl_seq"])
                seq = frame.get("seq")
                with self._cond:
                    self._unacked.pop(seq, None)
                    if seq is not None:
                        self._results[seq] = resp
                    self._credit = max(1, int(frame.get("credit") or 1))
                    self._connects = 0  # progress resets the budget
                    self._cond.notify_all()
        except grpc.RpcError as e:
            with self._cond:
                if self._call is call and not self._closed:
                    self._broken = e
                self._cond.notify_all()
            return
        # clean end-of-stream with frames unanswered = the server died
        # after half-close but before draining — same replay path
        with self._cond:
            if self._call is call and self._unacked and not self._closed:
                self._broken = protocol.BloomServiceError(
                    "UNAVAILABLE",
                    f"{self._method} ended with "
                    f"{len(self._unacked)} unacked frame(s)",
                )
            self._cond.notify_all()

    def _reconnect(self) -> None:
        client = self._client
        with self._cond:
            err = self._broken
            if err is None:
                return
            self._connects += 1
            n = self._connects
            if n > client.max_retries:
                self._failed = err
                raise err
        old = self._call
        if old is not None:
            old.cancel()
        reader = self._reader
        if reader is not None:
            reader.join(timeout=5.0)
        time.sleep(
            min(client.backoff_max, client.backoff_base * (2 ** (n - 1)))
            * (0.5 + random.random())
        )
        moved = False
        if client.sentinels:
            # the primary may have MOVED across the kill — follow the
            # sentinels' view before replaying (the rebuilt _bidi_calls
            # point at the fresh channel)
            try:
                moved = client.refresh_topology()
            except Exception:  # noqa: BLE001 — reconnect is best-effort
                pass
        if not moved:
            # same address: swap the dead channel for a fresh one, or
            # gRPC's grown connect backoff makes every remaining retry
            # fail fast against the stale subchannel while the server
            # restart is already accepting connections
            client._rebuild_primary_channel()
        self._connect()

    # -- producer API ---------------------------------------------------------

    def send(self, keys, **overrides) -> int:
        """Ship one frame; returns its seq. Blocks while the credit
        window is full (or the hello has not landed yet) — the server's
        backpressure, not an error. ``overrides`` are per-frame wire
        fields (``return_presence``, ``min_replicas``, ...)."""
        locks.note_blocking("client.stream")
        client = self._client
        if self._failed is not None:
            raise self._failed
        self._seq += 1
        seq = self._seq
        frame = {"seq": seq, "rid": new_rid(), "name": self._name}
        frame.update(self._defaults)
        frame.update(overrides)
        client._encode_keys(frame, keys)
        if (
            self._method == "InsertStream"
            and client.epoch is not None
            and "epoch" not in frame
        ):
            frame["epoch"] = client.epoch
        if client.trace_sample > 0 and obs_trace.hit(
            frame["rid"], client.trace_sample
        ):
            frame["trace"] = {
                "forced": True, "span": obs_trace.new_span_id(),
            }
        while True:
            with self._cond:
                if self._failed is not None:
                    raise self._failed
                broken = self._broken
                if broken is None:
                    if len(self._unacked) < self._credit:
                        self._unacked[seq] = frame
                        sendq = self._sendq
                        break
                    self._cond.wait(timeout=0.05)
                    continue
            self._reconnect()
        sendq.put(protocol.encode(frame))
        return seq

    def drain(self, timeout: float = 60.0) -> list:
        """Block until every sent frame is acked (reconnecting/replaying
        as needed); returns the raw per-frame responses in seq order.
        Per-frame verdicts — including error maps — are the entries;
        use :meth:`result` for raise-on-error access to one frame."""
        deadline = time.monotonic() + timeout
        while True:
            with self._cond:
                if self._failed is not None:
                    raise self._failed
                broken = self._broken
                if broken is None:
                    if not self._unacked:
                        return [
                            self._results[s] for s in sorted(self._results)
                        ]
                    self._cond.wait(timeout=0.05)
            if broken is not None:
                self._reconnect()
            if time.monotonic() > deadline:
                raise protocol.BloomServiceError(
                    "DEADLINE_EXCEEDED",
                    f"stream drain: {len(self._unacked)} frame(s) still "
                    f"unacked after {timeout:.0f}s",
                )

    def result(self, seq: int, timeout: float = 60.0) -> dict:
        """This frame's verdict, exactly as the unary call would have
        answered (raises :class:`protocol.BloomServiceError` on an
        error verdict — ``protocol.check`` semantics)."""
        deadline = time.monotonic() + timeout
        while True:
            with self._cond:
                if seq in self._results:
                    return protocol.check(dict(self._results[seq]))
                if self._failed is not None:
                    raise self._failed
                broken = self._broken
                if broken is None:
                    self._cond.wait(timeout=0.05)
            if broken is not None:
                self._reconnect()
            if time.monotonic() > deadline:
                raise protocol.BloomServiceError(
                    "DEADLINE_EXCEEDED",
                    f"stream result: seq {seq} unacked after {timeout:.0f}s",
                )

    @property
    def unacked(self) -> int:
        with self._cond:
            return len(self._unacked)

    def close(self, timeout: float = 30.0) -> None:
        """Drain (best-effort), half-close the send side, wait for the
        server to finish the stream. Never raises — a session used via
        ``with`` must tear down even after a terminal failure."""
        with self._cond:
            if self._closed:
                return
        try:
            self.drain(timeout=timeout)
        except Exception:  # noqa: BLE001 — teardown path
            pass
        with self._cond:
            self._closed = True
        self._sendq.put(None)
        reader = self._reader
        if reader is not None:
            reader.join(timeout=timeout)
        call = self._call
        if call is not None:
            call.cancel()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BloomClient:
    """Blocking client; one instance per channel, filters addressed by name."""

    def __init__(
        self,
        address: Optional[str] = None,
        *,
        timeout: float = 60.0,
        max_retries: int = 5,
        backoff_base: float = 0.2,
        backoff_max: float = 5.0,
        breaker_threshold: int = 5,
        breaker_cooldown: float = 5.0,
        replicas: Optional[Sequence[str]] = None,
        read_preference: str = "primary",
        sentinels: Optional[Sequence[str]] = None,
        topology: Optional[dict] = None,
        encoding: str = "auto",
        trace_sample: float = 0.0,
    ):
        """``replicas`` + ``read_preference="replica"`` route QueryBatch
        traffic round-robin over read replicas (writes always hit
        ``address``); a failing replica falls back to the primary for
        that call.

        Topology-awareness: pass ``sentinels=[addr, ...]``
        (resolved + cached with its epoch; refreshed on ``READONLY`` /
        ``UNAVAILABLE`` / ``STALE_EPOCH``, so writes fail over to the
        new primary — rid-dedup server-side guarantees a re-driven
        acknowledged batch never double-applies) or a static
        ``topology={"epoch", "primary", "replicas"}``. Either may stand
        in for ``address``/``replicas``.

        ``encoding``: ``"auto"`` (default) ships
        fixed-width-encodable key batches — numpy u64 arrays, or lists
        of equal-length bytes — as the zero-copy ``fixed`` wire
        encoding once a ``Health`` probe confirmed this connection's
        server supports it (negotiated per-connection, re-probed after
        a failover re-point); ``"msgpack"`` pins the classic per-key
        list; ``"fixed"`` is ``auto`` that raises no error either — it
        simply falls back when the server or the key shape can't."""
        if read_preference not in ("primary", "replica"):
            raise ValueError(
                f"read_preference must be 'primary' or 'replica', "
                f"got {read_preference!r}"
            )
        if encoding not in ("auto", "fixed", "msgpack"):
            raise ValueError(
                f"encoding must be 'auto', 'fixed' or 'msgpack', "
                f"got {encoding!r}"
            )
        self.encoding = encoding
        #: distributed tracing: fraction of logical calls
        #: this client traces (deterministic per rid). A traced call
        #: records a local ``client.hop`` span and stamps ``trace =
        #: {"forced": true, "span": <hop id>}`` on the wire so every
        #: server hop captures its tree under the same rid regardless
        #: of server-side sampling. 0.0 (the default) adds NO wire
        #: fields and no per-call work.
        self.trace_sample = float(trace_sample)
        if self.trace_sample > 0:
            obs_trace.ensure_enabled()
        #: None = not yet probed for THIS connection; True/False once a
        #: Health answer settled whether the server speaks `fixed`
        self._fixed_negotiated: Optional[bool] = None
        self.sentinels = list(sentinels or ())
        #: cached topology epoch — stamped on mutating requests so a
        #: server under a newer topology answers STALE_EPOCH and we
        #: refresh instead of writing under a stale map
        self.epoch: Optional[int] = None
        if topology is None and self.sentinels:
            topology = fetch_topology(self.sentinels)
        if topology is not None:
            self.epoch = int(topology.get("epoch") or 0)
            address = topology.get("primary") or address
            if replicas is None:
                replicas = topology.get("replicas")
        if address is None:
            if self.sentinels:
                # the caller asked for sentinel-resolved routing: falling
                # back to a hardcoded default here would silently connect
                # to the wrong (or a stale) node
                raise protocol.BloomServiceError(
                    "NO_TOPOLOGY",
                    f"no sentinel of {self.sentinels} answered and no "
                    f"explicit address was given",
                )
            address = "127.0.0.1:50051"
        self.address = address
        self.timeout = timeout
        self.max_retries = max_retries
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.read_preference = read_preference
        self.breaker = CircuitBreaker(breaker_threshold, breaker_cooldown)
        self.last_rid: Optional[str] = None
        #: op-log seq of this client's newest acknowledged write — what
        #: :meth:`wait` asks the durability quorum about (WAIT parity)
        self.last_write_seq: Optional[int] = None
        self._creations: dict[str, dict] = {}
        self._channel = grpc.insecure_channel(address, options=_CHANNEL_OPTIONS)
        self._calls = self._make_calls(self._channel)
        self._stream_calls = self._make_stream_calls(self._channel)
        self._bidi_calls = self._make_bidi_calls(self._channel)
        #: (address, channel, calls) per read replica, round-robined
        self._replicas: list = []
        for addr in replicas or ():
            ch = grpc.insecure_channel(addr, options=_CHANNEL_OPTIONS)
            self._replicas.append((addr, ch, self._make_calls(ch)))
        self._rr = 0
        #: channels replaced by the topology-PUSH thread:
        #: retired instead of closed at swap time — an
        #: in-flight call on the old channel must fail over through the
        #: normal retry path, not die on an out-of-band close. Bounded:
        #: only the newest few stay open (older ones have had ample
        #: grace by the next topology change); the rest close in
        #: :meth:`_retire_channel`, the remainder at :meth:`close`.
        self._retired_channels: list = []
        #: serializes topology adoption between the push thread and
        #: user threads' refresh-on-error — an unlocked epoch compare
        #: could interleave so an OLDER view is applied last
        self._topo_lock = locks.named_lock("client.topology")
        self._push_stop: Optional[threading.Event] = None
        self._push_thread: Optional[threading.Thread] = None
        self._push_call = None
        #: set while a TopologyEvents stream is live: from its first
        #: ``topology`` frame (the sentinel's current view, sent at once)
        #: until the stream ends. A view announced while it is set reaches
        #: this client on that stream; one announced before arrives as a
        #: first frame, which a failed subscription puts off by the push
        #: loop's backoff (0.2 s doubling to 5 s).
        self.push_live = threading.Event()

    @staticmethod
    def _make_calls(channel) -> dict:
        return {
            m: channel.unary_unary(
                protocol.method_path(m),
                request_serializer=lambda b: b,
                response_deserializer=lambda b: b,
            )
            for m in protocol.METHODS
        }

    @staticmethod
    def _make_stream_calls(channel) -> dict:
        return {
            m: channel.unary_stream(
                protocol.method_path(m),
                request_serializer=lambda b: b,
                response_deserializer=lambda b: b,
            )
            for m in protocol.STREAM_METHODS
        }

    @staticmethod
    def _make_bidi_calls(channel) -> dict:
        return {
            m: channel.stream_stream(
                protocol.method_path(m),
                request_serializer=lambda b: b,
                response_deserializer=lambda b: b,
            )
            for m in protocol.BIDI_STREAM_METHODS
        }

    def _call_once(
        self, method: str, req: dict, calls=None, timeout: Optional[float] = None
    ) -> dict:
        calls = self._calls if calls is None else calls
        raw = calls[method](
            protocol.encode(req),
            timeout=self.timeout if timeout is None else timeout,
        )
        return protocol.check(protocol.decode(raw))

    def _call_timeout(self, method: str, req: dict) -> Optional[float]:
        """Per-call gRPC deadline: a server legitimately blocking on a
        replica quorum (commit barrier / Wait) for longer than
        ``self.timeout`` must not be killed by the client first — the
        deadline stretches to the requested wait plus margin. ``Wait``
        with ``timeout_ms<=0`` means "server cap" (60s), so allow that
        much."""
        wait_ms = req.get("min_replicas_timeout_ms")
        if method == "Wait":
            wait_ms = req.get("timeout_ms")
            if wait_ms is not None and int(wait_ms) <= 0:
                wait_ms = 60_000  # the server's WAIT_TIMEOUT_CAP_S
        if not wait_ms:
            return None
        return max(self.timeout, int(wait_ms) / 1000.0 + 5.0)

    def _try_replica(self, method: str, req: dict) -> Optional[dict]:
        """One replica attempt for a routed read; None = fall back to the
        primary path (replica down, still syncing, or otherwise unable)."""
        # snapshot the pool: the topology-push thread REPLACES
        # self._replicas wholesale, so indexing the attribute twice
        # could race an adoption into IndexError/ZeroDivisionError
        replicas = self._replicas
        if (
            not replicas
            or self.read_preference != "replica"
            or method not in _REPLICA_READS
        ):
            return None
        self._rr = rr = (self._rr + 1) % len(replicas)
        addr, _, calls = replicas[rr % len(replicas)]
        try:
            return self._call_once(method, req, calls)
        except (grpc.RpcError, protocol.BloomServiceError):
            # includes NOT_FOUND from a replica that has not yet synced
            # the filter — the primary answers authoritatively
            obs_counters.incr("client_replica_fallbacks")
            return None

    def _follow_primary(self, address: str, *, close_old: bool = True) -> None:
        """READONLY redirect: re-point the primary channel (the old
        channel is closed; replica channels are untouched).
        ``close_old=False`` retires the old channel instead of closing
        it — the topology-push thread swaps channels while calls may be
        in flight on the old one."""
        old = self._channel
        self.address = address
        self._channel = grpc.insecure_channel(address, options=_CHANNEL_OPTIONS)
        self._calls = self._make_calls(self._channel)
        self._stream_calls = self._make_stream_calls(self._channel)
        self._bidi_calls = self._make_bidi_calls(self._channel)
        # per-CONNECTION capability: the new primary re-negotiates
        self._fixed_negotiated = None
        if close_old:
            old.close()
        else:
            self._retire_channel(old)
        obs_counters.incr("client_primary_redirects")

    def _set_replicas(
        self, addrs: Sequence[str], *, close_old: bool = True
    ) -> None:
        """Replace the replica channel pool (topology refresh).
        ``close_old=False`` retires dropped channels instead of closing
        them — the PUSH thread swaps the pool while replica reads may
        be in flight, and an out-of-band close would kill them instead
        of letting the replica-fallback path absorb the loss."""
        keep = {a: (a, ch, calls) for a, ch, calls in self._replicas}
        fresh = []
        for addr in addrs:
            if addr in keep:
                fresh.append(keep.pop(addr))
            else:
                ch = grpc.insecure_channel(addr, options=_CHANNEL_OPTIONS)
                fresh.append((addr, ch, self._make_calls(ch)))
        for _, ch, _ in keep.values():
            if close_old:
                ch.close()
            else:
                self._retire_channel(ch)
        self._replicas = fresh
        self._rr = 0

    def _rebuild_primary_channel(self) -> None:
        """Re-dial the primary on a FRESH channel (same address). A
        killed server leaves the old channel in TRANSIENT_FAILURE with
        gRPC's internal connect backoff growing toward minutes, so
        calls created on it fail fast without ever re-dialing — a
        stream reconnect budget can exhaust while the server is already
        back up. Swapping the channel makes each budgeted retry perform
        an immediate dial instead. The old channel is retired, not
        closed — sibling threads may still have calls in flight on it."""
        with self._topo_lock:
            old = self._channel
            self._channel = grpc.insecure_channel(
                self.address, options=_CHANNEL_OPTIONS
            )
            self._calls = self._make_calls(self._channel)
            self._stream_calls = self._make_stream_calls(self._channel)
            self._bidi_calls = self._make_bidi_calls(self._channel)
            self._retire_channel(old)

    def _retire_channel(self, ch) -> None:
        self._retired_channels.append(ch)
        while len(self._retired_channels) > 8:
            # anything older than the last few swaps has had ample
            # grace for its in-flight calls — close it, or a long-lived
            # push-enabled client leaks a channel per failover
            self._retired_channels.pop(0).close()

    def _adopt_topology(self, topo: dict, *, close_old: bool = True) -> bool:
        """Adopt one sentinel view iff its epoch is not older than the
        cached one; True iff the PRIMARY changed. Serialized: the push
        thread and user-thread refreshes must not interleave their
        epoch compare-and-apply, or an older view can be applied last."""
        with self._topo_lock:
            epoch = int(topo.get("epoch") or 0)
            if self.epoch is not None and epoch < self.epoch:
                return False
            self.epoch = epoch
            changed = (
                bool(topo.get("primary")) and topo["primary"] != self.address
            )
            if changed:
                self._follow_primary(topo["primary"], close_old=close_old)
            self._set_replicas(topo.get("replicas") or (), close_old=close_old)
            return changed

    def refresh_topology(self) -> bool:
        """Re-resolve the cluster view from the sentinel list; adopt it
        iff its epoch is not older than the cached one. True iff the
        PRIMARY changed (the signal that a retried write should reset
        its backoff — it now targets a different process)."""
        if not self.sentinels:
            return False
        topo = fetch_topology(self.sentinels)
        if topo is None:
            return False
        obs_counters.incr("client_topology_refreshes")
        # retire (never close) the swapped channels: with the push
        # thread or any multi-threaded use, an out-of-band close would
        # kill a sibling thread's in-flight call instead of letting it
        # fail over through the retry path; the retire cap bounds them
        return self._adopt_topology(topo, close_old=False)

    # -- sentinel topology push --------------------------

    def enable_topology_push(self) -> bool:
        """Subscribe to the sentinels' ``TopologyEvents`` server-stream
        on a background thread: failovers re-point this client the
        moment the sentinel announces them, instead of waiting for the
        next error-triggered refresh (refresh-on-error stays as the
        fallback — a dead push stream degrades, it does not break).
        Returns False (no thread) when the client has no sentinels."""
        if not self.sentinels or self._push_thread is not None:
            return False
        self._push_stop = threading.Event()
        self._push_thread = threading.Thread(
            target=self._topology_push_loop,
            name="tpubloom-topology-push",
            daemon=True,
        )
        self._push_thread.start()
        return True

    def _topology_push_loop(self) -> None:
        stop = self._push_stop
        backoff = 0.2
        # randomized order: every client of the fleet gets the same
        # sentinel list, and each subscriber parks a worker on its
        # sentinel for the stream lifetime — spreading subscriptions
        # keeps any one sentinel's pool free for election RPCs (the
        # sentinel additionally caps subscribers and answers
        # SUBSCRIBERS_FULL, which lands here as an ended stream)
        order = list(self.sentinels)
        random.shuffle(order)
        while not stop.is_set():
            for addr in order:
                if stop.is_set():
                    return
                channel = grpc.insecure_channel(addr)
                try:
                    call = channel.unary_stream(
                        protocol.sentinel_method_path("TopologyEvents"),
                        request_serializer=lambda b: b,
                        response_deserializer=lambda b: b,
                    )(protocol.encode({}), timeout=None)
                    self._push_call = call
                    for raw in call:
                        if stop.is_set():
                            return
                        frame = protocol.decode(raw)
                        if frame.get("kind") != "topology":
                            continue  # heartbeat keeps the stream alive
                        backoff = 0.2  # a live stream resets the backoff
                        if self._adopt_topology(frame, close_old=False):
                            obs_counters.incr("client_topology_pushes")
                        self.push_live.set()
                except grpc.RpcError:
                    pass
                except Exception:  # noqa: BLE001 — the push is best-effort
                    pass
                finally:
                    self.push_live.clear()
                    self._push_call = None
                    channel.close()
            stop.wait(backoff * (0.5 + random.random()))
            backoff = min(5.0, backoff * 2)

    def _rpc(self, method: str, req: dict, *, rid: Optional[str] = None) -> dict:
        # request-correlation id: one per LOGICAL call (retries and the
        # NOT_FOUND heal's final retry share it); exposed as last_rid so
        # callers can find their request in the server slowlog/trace.
        # DeleteBatch and non-idempotent InsertBatch retries lean on this
        # id: the server's dedup cache answers a replayed rid from cache
        # instead of re-applying. Callers spanning MULTIPLE _rpc calls
        # per logical op (the cluster client's redirect healing) pass
        # ``rid=`` so every hop shares one id.
        locks.note_blocking("client.rpc")
        self.last_rid = rid = rid or new_rid()
        req = {**req, "rid": rid}
        if self.epoch is not None and method in protocol.MUTATING_METHODS:
            req["epoch"] = self.epoch
        # distributed tracing: a traced call records one
        # local client.hop span per _rpc (cluster redirect follow-ups
        # call _rpc again → sibling hops under the same rid) and forces
        # server-side capture via the wire trace field. Untraced calls
        # take the exact untraced path: no field, no timers.
        # TraceGet itself is exempt — assembling a trace must not
        # inject lookup spans into (or evict spans out of) the very
        # rings it is reading.
        if (
            method == "TraceGet"
            or self.trace_sample <= 0
            or not obs_trace.hit(rid, self.trace_sample)
        ):
            return self._rpc_attempts(method, req)
        hop = obs_trace.new_span_id()
        req["trace"] = {"forced": True, "span": hop}
        w0, t0 = time.time(), time.perf_counter()
        code = "OK"
        try:
            return self._rpc_attempts(method, req)
        except protocol.BloomServiceError as e:
            code = e.code
            raise
        except grpc.RpcError:
            code = "UNAVAILABLE"
            raise
        finally:
            obs_trace.record_span(
                "client.hop",
                rid=rid,
                span=hop,
                start=w0,
                duration_s=time.perf_counter() - t0,
                attrs={"method": method, "addr": self.address, "code": code},
            )

    def _rpc_attempts(self, method: str, req: dict) -> dict:
        """The retry/heal loop of one logical call (split from
        :meth:`_rpc` so the tracing wrapper brackets every hop)."""
        rid = req["rid"]
        routed = self._try_replica(method, req)
        if routed is not None:
            return routed
        # fail fast while the breaker is open — no network, no backoff
        self.breaker.check(self.address)
        recreated = False
        redirected = False
        failover_reset = False
        stale_refreshed = False
        attempt = 0
        shed_attempt = 0
        call_timeout = self._call_timeout(method, req)
        while True:
            try:
                resp = self._call_once(method, req, timeout=call_timeout)
                self.breaker.record_success()
                if resp.get("repl_seq") is not None:
                    self.last_write_seq = int(resp["repl_seq"])
                return resp
            except grpc.RpcError as e:
                if e.code() is grpc.StatusCode.UNAVAILABLE and self.sentinels:
                    # the primary may be mid-failover: re-resolve the
                    # topology. A changed primary resets the retry budget
                    # ONCE — the retry targets a different process, and
                    # the rid guarantees an already-applied batch answers
                    # from the dedup cache instead of double-applying.
                    if self.refresh_topology() and not failover_reset:
                        failover_reset = True
                        attempt = 0
                        if self.epoch is not None and "epoch" in req:
                            req["epoch"] = self.epoch
                        continue
                if (
                    e.code() is not grpc.StatusCode.UNAVAILABLE
                    or attempt >= self.max_retries
                ):
                    # one LOGICAL failure (own retries exhausted) = one
                    # breaker strike — patient riders don't trip it
                    self.breaker.record_failure()
                    raise
                delay = min(
                    self.backoff_max, self.backoff_base * (2 ** attempt)
                ) * (0.5 + random.random())
                time.sleep(delay)
                attempt += 1
            except protocol.BloomServiceError as e:
                # an application-level answer means the transport is fine
                self.breaker.record_success()
                if e.code == "STALE_EPOCH" and not stale_refreshed:
                    # our cached topology predates a failover: adopt the
                    # server's epoch, re-resolve, retry once under the
                    # fresh view
                    stale_refreshed = True
                    server_epoch = e.details.get("epoch")
                    if server_epoch is not None:
                        self.epoch = max(self.epoch or 0, int(server_epoch))
                    self.refresh_topology()
                    if self.epoch is not None and "epoch" in req:
                        req["epoch"] = self.epoch
                    continue
                if e.code in _SHED_CODES:
                    # shed BEFORE execution — safe to replay any method,
                    # even the non-idempotent ones; pace off the server's
                    # hint when it beats local backoff
                    if shed_attempt >= self.max_retries:
                        raise
                    delay = min(
                        self.backoff_max,
                        self.backoff_base * (2 ** shed_attempt),
                    )
                    hint_ms = e.details.get("retry_after_ms")
                    if hint_ms:
                        delay = max(delay, hint_ms / 1000.0)
                    time.sleep(delay * (0.75 + random.random() / 2))
                    shed_attempt += 1
                    continue
                if e.code == "READONLY" and not redirected:
                    # the "primary" we were pointed at is a replica
                    # (failover, stale config). Its error advertises the
                    # real primary — follow it once, Redis-MOVED-style;
                    # with sentinels, their view wins over the hint
                    # (mid-failover a replica may not know its new
                    # primary yet).
                    redirected = True
                    if self.sentinels and self.refresh_topology():
                        if self.epoch is not None and "epoch" in req:
                            req["epoch"] = self.epoch
                        continue
                    primary = e.details.get("primary")
                    if not primary or primary == self.address:
                        raise
                    self._follow_primary(primary)
                    continue
                # Heal a restarted server: replay the remembered creation
                # (restores the newest checkpoint), then retry the op once.
                creation = self._creations.get(req.get("name", ""))
                if (
                    e.code != "NOT_FOUND"
                    or method in ("CreateFilter", "DropFilter")
                    or recreated
                    or creation is None
                ):
                    raise
                # through _rpc, not _call_once: the heal itself must ride
                # out UNAVAILABLE if the server is still coming up
                self._rpc(
                    "CreateFilter",
                    {**creation, "exist_ok": True, "restore": True},
                )
                self.last_rid = rid  # the heal is internal; report ours
                recreated = True

    # -- service-level -------------------------------------------------------

    def health(self) -> dict:
        return self._rpc("Health", {})

    def wait_ready(
        self,
        timeout: float = 30.0,
        poll: float = 0.1,
        *,
        accept_degraded: bool = True,
    ) -> dict:
        """Block until the server is actually serving, not merely until the
        channel connects: the gRPC channel comes up before restore-on-create
        and warm-up finish, so callers racing the service would see
        NOT_FOUND churn. Polls the Health RPC until it reports ``SERVING``
        — or ``DEGRADED`` too by default, since a degraded server (e.g. it
        quarantined a corrupt checkpoint on restore) IS serving and may
        stay degraded until its next good checkpoint; pass
        ``accept_degraded=False`` to insist on fully healthy. Servers
        predating the status field count as SERVING. Returns the final
        health response; raises TimeoutError otherwise."""
        ready = {"SERVING", "DEGRADED"} if accept_degraded else {"SERVING"}
        deadline = time.monotonic() + timeout
        grpc.channel_ready_future(self._channel).result(timeout=timeout)
        last: object = None
        while True:
            try:
                h = self.health()
                if h.get("status", "SERVING") in ready:
                    return h
                last = h
            except (grpc.RpcError, protocol.BloomServiceError) as e:
                # includes CircuitOpenError: keep polling until the
                # breaker's cooldown lets the next probe through
                last = e
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"server at {self.address} not ready within "
                    f"{timeout}s (last: {last!r})"
                )
            time.sleep(poll)

    def create_filter(
        self,
        name: str,
        *,
        capacity: Optional[int] = None,
        error_rate: Optional[float] = None,
        config: Optional[dict] = None,
        exist_ok: bool = False,
        restore: bool = True,
        scalable: bool = False,
        growth: int = 2,
        tightening: float = 0.5,
        **options,
    ) -> dict:
        """``scalable=True`` creates a scalable (layered) filter: it grows
        past ``capacity`` by pushing larger, tighter layers while the
        compound FPR stays below ``error_rate / (1 - tightening)``.
        Scalable filters are sized by capacity/error_rate (not a raw
        ``config``); ``options`` become the base layer template
        (key_len, block_bits, seed, ...)."""
        req: dict = {"name": name, "exist_ok": exist_ok, "restore": restore}
        if scalable:
            if config is not None:
                raise ValueError(
                    "scalable filters are sized by capacity/error_rate, "
                    "not a raw config"
                )
            req["capacity"] = capacity
            req["error_rate"] = error_rate
            req["options"] = options
            req["scalable"] = {"growth": growth, "tightening": tightening}
        elif config is not None:
            req["config"] = config
        else:
            req["capacity"] = capacity
            req["error_rate"] = error_rate
            req["options"] = options
        resp = self._rpc("CreateFilter", req)
        # Bare attaches (no config, no capacity) adopt the server's config —
        # remember the adopted config so the NOT_FOUND heal can replay a
        # well-formed creation.
        if config is None and capacity is None:
            if "scalable" in resp:
                # replay a scalable creation: policy from the response,
                # base template = adopted config minus the placeholder m/k
                opts = {
                    k: v
                    for k, v in resp["config"].items()
                    if k not in ("m", "k", "key_name")
                }
                self._creations[name] = {
                    "name": name,
                    "capacity": resp["scalable"]["capacity"],
                    "error_rate": resp["scalable"]["error_rate"],
                    "options": opts,
                    "scalable": {
                        "growth": resp["scalable"]["growth"],
                        "tightening": resp["scalable"]["tightening"],
                    },
                }
            else:
                self._creations[name] = {"name": name, "config": resp["config"]}
        else:
            self._creations[name] = req
        return resp

    def drop_filter(self, name: str, *, final_checkpoint: bool = True) -> dict:
        resp = self._rpc(
            "DropFilter", {"name": name, "final_checkpoint": final_checkpoint}
        )
        self._creations.pop(name, None)  # only forget once the drop landed
        return resp

    def list_filters(self) -> list:
        return self._rpc("ListFilters", {})["filters"]

    # -- per-filter ops ------------------------------------------------------

    @staticmethod
    def _keys(keys) -> list:
        if isinstance(keys, np.ndarray):
            # integer keys through the msgpack path: each key ships as
            # its little-endian u64 bytes (the fixed encoding's twin)
            arr = np.ascontiguousarray(keys, dtype="<u8")
            return [arr[i].tobytes() for i in range(arr.size)]
        return [k.encode() if isinstance(k, str) else bytes(k) for k in keys]

    def _fixed_ok(self) -> bool:
        """Lazy per-connection negotiation: one Health probe decides
        whether this server speaks the ``fixed`` encoding. Probe
        failures degrade to msgpack for this connection — never an
        error."""
        if self.encoding == "msgpack":
            return False
        if self._fixed_negotiated is None:
            try:
                h = self._rpc("Health", {})
                self._fixed_negotiated = "fixed" in (h.get("encodings") or ())
            except (grpc.RpcError, protocol.BloomServiceError):
                self._fixed_negotiated = False
        return bool(self._fixed_negotiated)

    def _encode_keys(self, req: dict, keys) -> dict:
        """Fold the key batch into ``req`` under the best negotiated
        encoding: fixed-width-encodable batches (numpy
        integer arrays — canonically u64 — or equal-length bytes) ship
        as ONE raw buffer the server decodes zero-copy; everything else
        takes the msgpack list path."""
        # negotiation first — it is one cached-bool check after the
        # initial Health probe, while pack_fixed_keys copies the whole
        # batch (wasted per call against a msgpack-only server)
        if self.encoding != "msgpack" and self._fixed_ok():
            fx = protocol.pack_fixed_keys(keys)
            if fx is not None:
                req["keys_fixed"] = fx
                return req
        req["keys"] = self._keys(keys)
        return req

    @staticmethod
    def _durability(req: dict, min_replicas, timeout_ms) -> dict:
        """Fold the per-call durability override into a request: the
        server blocks the RPC until ``min_replicas`` replicas
        acked its record (NOT_ENOUGH_REPLICAS on timeout)."""
        if min_replicas is not None:
            req["min_replicas"] = int(min_replicas)
        if timeout_ms is not None:
            req["min_replicas_timeout_ms"] = int(timeout_ms)
        return req

    def insert_batch(
        self,
        name: str,
        keys,
        *,
        return_presence: bool = False,
        min_replicas: Optional[int] = None,
        min_replicas_timeout_ms: Optional[int] = None,
    ):
        """Insert a batch; with ``return_presence`` also get each key's
        membership BEFORE the batch (fused test-and-insert server-side —
        the dedup primitive). Returns the insert count, or the presence
        bool array when requested. ``min_replicas`` demands a per-call
        durability quorum stronger than the server default."""
        req = self._durability(
            self._encode_keys({"name": name}, keys),
            min_replicas, min_replicas_timeout_ms,
        )
        if not return_presence:
            return self._rpc("InsertBatch", req)["n"]
        req["return_presence"] = True
        # retryable since retries reuse the rid and the server
        # answers a replay whose first attempt landed from its dedup
        # cache (same machinery as DeleteBatch), presence bits included
        resp = self._rpc("InsertBatch", req)
        return self._unpack_bool(resp, "presence")

    @staticmethod
    def _unpack_bool(resp: dict, field: str) -> np.ndarray:
        if field not in resp:
            raise protocol.BloomServiceError(
                "UNSUPPORTED",
                f"server response has no '{field}' field — the server is "
                f"probably too old for this request (got {sorted(resp)})",
            )
        return np.unpackbits(
            np.frombuffer(resp[field], np.uint8), count=resp["n"]
        ).astype(bool)

    def include_batch(self, name: str, keys) -> np.ndarray:
        resp = self._rpc(
            "QueryBatch", self._encode_keys({"name": name}, keys)
        )
        return self._unpack_bool(resp, "hits")

    def delete_batch(
        self,
        name: str,
        keys: Sequence[bytes | str],
        *,
        min_replicas: Optional[int] = None,
        min_replicas_timeout_ms: Optional[int] = None,
    ) -> int:
        """Counting-filter delete. Auto-retried like any other op: retries
        reuse the call's rid and the server's dedup cache answers a replay
        whose first attempt already landed, so no double-decrement."""
        req = self._durability(
            {"name": name, "keys": self._keys(keys)},
            min_replicas, min_replicas_timeout_ms,
        )
        return self._rpc("DeleteBatch", req)["n"]

    def insert(self, name: str, key: bytes | str) -> None:
        self.insert_batch(name, [key])

    def include(self, name: str, key: bytes | str) -> bool:
        return bool(self.include_batch(name, [key])[0])

    def clear(
        self,
        name: str,
        *,
        min_replicas: Optional[int] = None,
        min_replicas_timeout_ms: Optional[int] = None,
    ) -> None:
        self._rpc(
            "Clear",
            self._durability(
                {"name": name}, min_replicas, min_replicas_timeout_ms
            ),
        )

    def wait(
        self,
        numreplicas: int,
        timeout_ms: int = 1000,
        *,
        seq: Optional[int] = None,
    ) -> int:
        """Redis ``WAIT`` parity: block until ``numreplicas`` replicas
        have acknowledged this client's last write (or ``seq``), up to
        ``timeout_ms``; returns how many actually acked — possibly
        fewer (WAIT reports, it does not raise). With no prior write
        the server gates on its current log head."""
        req: dict = {
            "numreplicas": int(numreplicas),
            "timeout_ms": int(timeout_ms),
        }
        target = self.last_write_seq if seq is None else seq
        if target is not None:
            req["seq"] = int(target)
        return self._rpc("Wait", req)["nreplicas"]

    def stats(self, name: Optional[str] = None) -> dict:
        resp = self._rpc("Stats", {"name": name} if name else {})
        return resp.get("stats", resp.get("server"))

    def checkpoint(self, name: str, *, wait: bool = True) -> dict:
        return self._rpc("Checkpoint", {"name": name, "wait": wait})

    # -- sketch plane: cuckoo / count-min / top-k -----------------

    def _remember_sketch_creation(self, name: str, resp: dict) -> None:
        """Sketch reserves heal like bloom creations: remember the
        server-adopted config so the NOT_FOUND heal can replay it."""
        if isinstance(resp.get("config"), dict):
            self._creations[name] = {"name": name, "config": resp["config"]}

    def cf_reserve(
        self, name: str, capacity: int, *, exist_ok: bool = False, **options
    ) -> dict:
        """Create a cuckoo filter sized for ``capacity`` keys
        (RedisBloom ``CF.RESERVE``)."""
        req: dict = {
            "name": name, "capacity": int(capacity), "exist_ok": exist_ok,
        }
        if options:
            req["options"] = options
        resp = self._rpc("CFReserve", req)
        self._remember_sketch_creation(name, resp)
        return resp

    def cf_add(
        self,
        name: str,
        keys,
        *,
        min_replicas: Optional[int] = None,
        min_replicas_timeout_ms: Optional[int] = None,
    ) -> np.ndarray:
        """Add keys to a cuckoo filter. Returns a bool array: True per
        key that landed, False per key the (honestly) FULL table
        rejected — unlike a bloom filter, a cuckoo filter refuses
        rather than silently degrade its FPR."""
        req = self._durability(
            self._encode_keys({"name": name}, keys),
            min_replicas, min_replicas_timeout_ms,
        )
        resp = self._rpc("CFAdd", req)
        if "full" in resp:
            return ~self._unpack_bool(resp, "full")
        return np.ones(int(resp["n"]), dtype=bool)

    def cf_del(
        self,
        name: str,
        keys,
        *,
        min_replicas: Optional[int] = None,
        min_replicas_timeout_ms: Optional[int] = None,
    ) -> np.ndarray:
        """Delete ONE stored copy per key from a cuckoo filter
        (``CF.DEL``). Returns per-key bools: True where a copy
        existed and was removed. Retries reuse the rid; the dedup
        cache absorbs replays, so no double-remove."""
        req = self._durability(
            {"name": name, "keys": self._keys(keys)},
            min_replicas, min_replicas_timeout_ms,
        )
        return self._unpack_bool(self._rpc("CFDel", req), "deleted")

    def cf_exists(self, name: str, keys) -> np.ndarray:
        """Cuckoo membership (``CF.EXISTS``, batched) — no false
        negatives; false-positive rate bounded by the fingerprint."""
        resp = self._rpc(
            "CFExists", self._encode_keys({"name": name}, keys)
        )
        return self._unpack_bool(resp, "hits")

    def cms_init_by_dim(
        self, name: str, width: int, depth: int, *,
        exist_ok: bool = False, **options,
    ) -> dict:
        """Create a count-min sketch (``CMS.INITBYDIM``); width rounds
        up to a multiple of 32 (error bound only tightens)."""
        req: dict = {
            "name": name, "width": int(width), "depth": int(depth),
            "exist_ok": exist_ok,
        }
        if options:
            req["options"] = options
        resp = self._rpc("CMSInitByDim", req)
        self._remember_sketch_creation(name, resp)
        return resp

    def cms_incrby(
        self,
        name: str,
        keys,
        increments: Optional[Sequence[int]] = None,
        *,
        min_replicas: Optional[int] = None,
        min_replicas_timeout_ms: Optional[int] = None,
    ) -> Optional[list]:
        """Increment key counts (``CMS.INCRBY``). Weighted increments
        return the post-update estimates; unit increments (or None)
        ride the coalesced insert path and return None — follow with
        :meth:`cms_query` when you need the counts."""
        req = self._durability(
            {"name": name, "keys": self._keys(keys)},
            min_replicas, min_replicas_timeout_ms,
        )
        if increments is not None:
            req["increments"] = [int(i) for i in increments]
        resp = self._rpc("CMSIncrBy", req)
        counts = resp.get("counts")
        return [int(c) for c in counts] if counts is not None else None

    def cms_query(self, name: str, keys) -> np.ndarray:
        """Point estimates (``CMS.QUERY``) — each only ever >= the
        true count."""
        resp = self._rpc(
            "CMSQuery", {"name": name, "keys": self._keys(keys)}
        )
        return np.asarray(resp["counts"], dtype=np.uint32)

    def topk_reserve(
        self, name: str, topk: int, *, width: int = 2048, depth: int = 5,
        exist_ok: bool = False, **options,
    ) -> dict:
        """Create a top-``topk`` heavy-hitter sketch (``TOPK.RESERVE``)."""
        req: dict = {
            "name": name, "topk": int(topk), "width": int(width),
            "depth": int(depth), "exist_ok": exist_ok,
        }
        if options:
            req["options"] = options
        resp = self._rpc("TopKReserve", req)
        self._remember_sketch_creation(name, resp)
        return resp

    def topk_add(
        self,
        name: str,
        keys,
        *,
        min_replicas: Optional[int] = None,
        min_replicas_timeout_ms: Optional[int] = None,
    ) -> int:
        """Count occurrences into a top-k sketch (``TOPK.ADD``)."""
        req = self._durability(
            self._encode_keys({"name": name}, keys),
            min_replicas, min_replicas_timeout_ms,
        )
        return int(self._rpc("TopKAdd", req)["n"])

    def topk_list(self, name: str) -> list:
        """Current heavy hitters as ``(key_bytes, estimate)`` pairs,
        estimate-descending (``TOPK.LIST WITHCOUNT``)."""
        resp = self._rpc("TopKList", {"name": name})
        return [(item["key"], int(item["count"])) for item in resp["items"]]

    # -- high availability -----------------------------------------

    def promote(
        self,
        *,
        epoch: Optional[int] = None,
        repl_log_dir: Optional[str] = None,
    ) -> dict:
        """Promote the server this client points at from replica to
        primary (``REPLICAOF NO ONE`` parity). ``repl_log_dir`` names
        the op-log dir the REMOTE process should adopt when it was
        started without one."""
        req: dict = {}
        if epoch is not None:
            req["epoch"] = epoch
        if repl_log_dir:
            req["repl_log_dir"] = repl_log_dir
        return self._rpc("Promote", req)

    def replica_of(
        self, primary: Optional[str], *, epoch: Optional[int] = None
    ) -> dict:
        """Redis ``REPLICAOF`` parity: re-point the server at a new
        primary (or pass None / ``"NO ONE"`` to promote it)."""
        req: dict = {"primary": primary}
        if epoch is not None:
            req["epoch"] = epoch
        return self._rpc("ReplicaOf", req)

    # -- cluster mode ----------------------------------------------

    def cluster_slots(self) -> dict:
        """This node's slot-map view (Redis ``CLUSTER SLOTS`` parity):
        ``{enabled, epoch, ranges, migrating, importing}``. Routed
        cluster traffic wants :class:`tpubloom_torch.cluster.ClusterClient`;
        this is the per-node admin/bootstrap probe."""
        return self._rpc("ClusterSlots", {})

    def cluster_set_slot(self, **req) -> dict:
        """Admin verb (``CLUSTER SETSLOT`` parity): ``slot=/state=/addr=``
        or the bulk ``assign=[[start, end, addr], ...], epoch=`` form."""
        return self._rpc("ClusterSetSlot", req)

    def migrate_slot(self, slot: int, target: str) -> dict:
        """Drive the live migration of ``slot`` from this node (its
        owner) to ``target``; blocks until the handoff finalizes."""
        return self._rpc("MigrateSlot", {"slot": int(slot), "target": target})

    def migrate_install_probe(self, name: str) -> dict:
        """Resume probe of the migration target's import gate for one
        filter (``{"have": <source seq>|None}``) — the node→node
        ``MigrateInstall`` hop's read-only form, exposed for tooling."""
        return self._rpc("MigrateInstall", {"name": name, "probe": True})

    # -- observability -------------------------------------------------------

    def slowlog_get(self, n: Optional[int] = None) -> list:
        """Slowest server requests (slowest first), Redis SLOWLOG GET
        parity. Entries carry the rid this client stamped on each call."""
        req = {"n": n} if n is not None else {}
        return self._rpc("SlowlogGet", req)["entries"]

    def trace_get(self, rid: Optional[str] = None) -> list:
        """Distributed-tracing lookup: the spans the
        CONNECTED node recorded for one rid (default: this client's
        last call), plus coalescer flush spans that link it. Assemble
        cross-node views with ``ClusterClient.trace``."""
        resp = self._rpc("TraceGet", {"trace_rid": rid or self.last_rid})
        return resp.get("spans") or []

    def trace_get_fan(self, rid: str) -> list:
        """Best-effort ``TraceGet`` against the primary AND every
        configured replica channel — a replica's ``repl.apply`` spans
        live in ITS ring, not the primary's. Unreachable nodes are
        skipped (a trace lookup must never fail a post-mortem)."""
        spans: list = []
        try:
            spans.extend(self.trace_get(rid))
        except (grpc.RpcError, protocol.BloomServiceError):
            pass
        for _addr, _ch, calls in list(self._replicas):
            try:
                resp = self._call_once(
                    "TraceGet", {"trace_rid": rid}, calls
                )
                spans.extend(resp.get("spans") or [])
            except (grpc.RpcError, protocol.BloomServiceError):
                continue
        return spans

    def slowlog_reset(self) -> int:
        """Clear the server slowlog; returns how many entries dropped."""
        return self._rpc("SlowlogReset", {})["cleared"]

    def monitor(self, name: Optional[str] = None) -> "ServerStream":
        """Redis ``MONITOR`` parity: a live stream of every request the
        server finishes, as dicts (``kind: hello/op/heartbeat``), with
        optional per-filter-name filtering (which MONITOR itself cannot
        do). Iterate the returned stream; ``.cancel()`` to stop."""
        req = {"name": name} if name else {}
        return ServerStream(
            self._stream_calls["Monitor"](protocol.encode(req), timeout=None)
        )

    def insert_stream(
        self,
        name: str,
        *,
        return_presence: bool = False,
        min_replicas: Optional[int] = None,
        min_replicas_timeout_ms: Optional[int] = None,
    ) -> "StreamSession":
        """Open a persistent ``InsertStream``: one bidi RPC
        carrying many seq-stamped insert frames with pipelined per-frame
        acks — InsertBatch semantics per frame (presence fusion,
        durability quorums, dedup replay safety) without per-call RPC
        setup. The keyword defaults stamp every frame; ``send`` can
        override per frame. Use as a context manager::

            with client.insert_stream("events") as s:
                for batch in batches:
                    s.send(batch)
                results = s.drain()
        """
        defaults: dict = {}
        if return_presence:
            defaults["return_presence"] = True
        if min_replicas is not None:
            defaults["min_replicas"] = int(min_replicas)
        if min_replicas_timeout_ms is not None:
            defaults["min_replicas_timeout_ms"] = int(min_replicas_timeout_ms)
        return StreamSession(self, "InsertStream", name, defaults=defaults)

    def query_stream(self, name: str) -> "StreamSession":
        """Open a persistent ``QueryStream``: QueryBatch semantics per
        frame, acks carry packed hit bitmaps (unpack with
        ``np.unpackbits(np.frombuffer(resp["hits"], np.uint8),
        count=resp["n"])``)."""
        return StreamSession(self, "QueryStream", name)

    def repl_stream(self, cursor: Optional[int] = None) -> "ServerStream":
        """Raw access to the replication changefeed (what a replica
        consumes): ``full_sync_begin/snapshot/full_sync_end/partial_sync/
        record/heartbeat`` frames. Mostly for tooling/tests — run a real
        replica with ``python -m tpubloom_torch.server --replica-of``."""
        req = {"cursor": cursor} if cursor is not None else {}
        return ServerStream(
            self._stream_calls["ReplStream"](protocol.encode(req), timeout=None)
        )

    def close(self) -> None:
        if self._push_stop is not None:
            self._push_stop.set()
            call = self._push_call
            if call is not None:
                call.cancel()
            self._push_thread.join(timeout=5.0)
            self._push_thread = None
            self._push_stop = None
        self._channel.close()
        for ch in self._retired_channels:
            ch.close()
        self._retired_channels = []
        for _, ch, _ in self._replicas:
            ch.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
