"""Sentinel-parity failover coordinator: the port of
``tpubloom/ha/sentinel.py``. It is host code and gRPC only and touches no
tensor; the nodes it watches are servers of either package.

``python -m tpubloom_torch.sentinel --watch host:port --peers ...`` runs one
watcher of a quorum of N. Each sentinel is a tiny gRPC service
(:data:`tpubloom_torch.server.protocol.SENTINEL_SERVICE`) plus a monitor
thread:

* **health polling** — the watched primary's ``Health`` RPC every
  ``poll_s``; misses accumulate into **SDOWN** (subjectively down) after
  ``down_after_s``, Redis Sentinel's terminology and shape;
* **SDOWN→ODOWN by vote** — a subjectively-down sentinel asks its peers
  for an epoch-stamped vote (``VoteDown``). A peer grants iff it also
  sees the primary down AND has not yet voted in that epoch — the Raft
  term rule (vote once per term) without the rest of Raft: no log
  replication, just a leader lease for one failover. Majority of the
  quorum = **ODOWN** + leadership for that epoch;
* **failover** — the leader reads each known replica's ``Health`` and
  picks the most caught-up one (highest replication cursor =
  lowest ``repl_lag_seq``), sends it ``Promote {epoch}``, re-points the
  survivors with ``ReplicaOf {primary, epoch}``, and announces the new
  topology to its peers (``AnnounceTopology``);
* **fencing** — any node later observed claiming ``role=primary`` under
  an epoch OLDER than the current topology's (the restarted pre-failover
  primary) is demoted on sight with ``ReplicaOf`` — split-brain ends the
  moment a sentinel can reach the stale node;
* **discovery** — replicas are discovered from the primary's
  ``Health.replication.replicas[].listen`` announcements (Redis
  ``INFO replication`` parity); clients ask any sentinel ``Topology``
  for the current epoch/primary/replicas (``SENTINEL
  get-master-addr-by-name`` parity);
* **state persistence** — with ``--state-dir`` the
  current topology (epoch/primary/replicas) and the newest epoch this
  sentinel has VOTED in persist to a CRC-checked
  ``sentinel_state.json`` (:mod:`tpubloom_torch.utils.crcjson`). A
  full-quorum sentinel restart therefore does not forget failover
  history: it resumes watching the post-failover primary at the
  current epoch and keeps the one-vote-per-epoch discipline across the
  restart (Redis Sentinel's config-epoch persistence). Corruption
  reads as absent — the sentinel falls back to ``--watch`` and
  re-learns epochs from the primaries' Health answers, never crashes.

Fault point ``ha.vote`` fires in both the vote-request and vote-grant
paths, so the chaos suite can kill a failover mid-election.
"""

from __future__ import annotations

import argparse
import logging
import threading
import time
from concurrent import futures
from typing import Optional

import grpc

from tpubloom_torch import faults
from tpubloom_torch.ha.topology import Topology
from tpubloom_torch.obs import blackbox as obs_blackbox
from tpubloom_torch.obs import counters as _counters
from tpubloom_torch.obs import flight as obs_flight
from tpubloom_torch.obs import trace as obs_trace
from tpubloom_torch.server import protocol
from tpubloom_torch.utils import crcjson
from tpubloom_torch.utils import locks

log = logging.getLogger("tpubloom_torch.sentinel")


class SentinelStateStore:
    """Persisted sentinel memory (Redis Sentinel config-epoch
    parity): the adopted topology and the newest epoch this
    sentinel has voted in, CRC-checked so a torn write reads as "no
    state" (→ re-learn from the primaries, the safe direction)."""

    STATE_FILE = "sentinel_state.json"
    _FIELDS = ("epoch", "last_vote_epoch", "primary", "replicas", "fenced")

    def __init__(self, directory: str):
        import os

        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, self.STATE_FILE)

    def load(self):
        data = crcjson.load(self.path, self._FIELDS)
        if data is None:
            return None
        try:
            return {
                "epoch": int(data["epoch"]),
                "last_vote_epoch": int(data["last_vote_epoch"]),
                "primary": data["primary"],
                "replicas": list(data["replicas"] or ()),
                "fenced": list(data["fenced"] or ()),
            }
        except (ValueError, TypeError):
            return None

    def store(
        self, epoch: int, last_vote_epoch: int, primary, replicas, fenced
    ) -> None:
        crcjson.store(
            self.path,
            {
                "epoch": int(epoch),
                "last_vote_epoch": int(last_vote_epoch),
                "primary": primary,
                "replicas": list(replicas or ()),
                # the demoted-primary watchlist is failover memory too:
                # forget it across a full-quorum restart and a stale
                # primary that comes back is never fenced
                "fenced": sorted(fenced or ()),
            },
        )

_CHANNEL_OPTIONS = [
    ("grpc.max_receive_message_length", 64 * 1024 * 1024),
]


class Sentinel:
    """One failover watcher; run N of these (N odd) for a quorum."""

    def __init__(
        self,
        watch: str,
        peers: Optional[list] = None,
        *,
        listen: str = "127.0.0.1:0",
        quorum: Optional[int] = None,
        poll_s: float = 0.25,
        down_after_s: float = 1.5,
        rpc_timeout_s: float = 1.0,
        promote_timeout_s: Optional[float] = None,
        failover_cooldown_s: float = 2.0,
        sentinel_id: Optional[str] = None,
        state_dir: Optional[str] = None,
    ):
        import secrets

        self.peers = list(peers or ())
        total = len(self.peers) + 1
        #: votes (incl. our own) needed for ODOWN + failover leadership;
        #: default = majority, so two concurrent elections cannot both win
        self.quorum = quorum if quorum is not None else total // 2 + 1
        self.poll_s = poll_s
        self.down_after_s = down_after_s
        self.rpc_timeout_s = rpc_timeout_s
        #: Promote/ReplicaOf are heavyweight (log adoption, epoch
        #: persist, applier teardown) and MUST NOT be declared failed on
        #: a health-poll-grade deadline — a spuriously "failed" promote
        #: that lands late is how dueling co-primaries happen
        self.promote_timeout_s = (
            promote_timeout_s
            if promote_timeout_s is not None
            else max(5.0, 5 * rpc_timeout_s)
        )
        self.failover_cooldown_s = failover_cooldown_s
        self.sentinel_id = sentinel_id or secrets.token_hex(8)
        self.topology = Topology(epoch=0, primary=watch, replicas=[])
        self._lock = locks.named_lock("sentinel.state")
        #: newest epoch this sentinel has VOTED in (self-votes included):
        #: one vote per epoch is the whole split-brain argument
        self._last_vote_epoch = 0
        #: demoted-primary watchlist: addresses to fence if they come
        #: back claiming a stale primaryship
        self._fence_watch: set = set()
        #: persisted failover memory: restart with
        #: the post-failover topology + vote discipline instead of the
        #: stale --watch view
        self._state_store = (
            SentinelStateStore(state_dir) if state_dir else None
        )
        if self._state_store is not None:
            saved = self._state_store.load()
            if saved is not None:
                self._last_vote_epoch = saved["last_vote_epoch"]
                self._fence_watch.update(saved["fenced"])
                if saved["epoch"] > 0 and saved["primary"]:
                    self.topology = Topology(
                        epoch=saved["epoch"],
                        primary=saved["primary"],
                        replicas=saved["replicas"],
                    )
                    log.info(
                        "sentinel state restored: epoch %d, primary %s "
                        "(voted through epoch %d)",
                        saved["epoch"], saved["primary"],
                        self._last_vote_epoch,
                    )
        self._sdown = False
        self._first_fail: Optional[float] = None
        self._last_failover_attempt = 0.0
        #: when we last GRANTED a peer's vote: someone else is leading a
        #: failover — hold our own candidacy back so the quorum does not
        #: burn epochs on dueling elections (Redis Sentinel's
        #: failover-timeout hold-off, randomly staggered like its
        #: election delays)
        self._granted_at = 0.0
        import random as _random

        self._rand = _random.Random()
        self._election_stagger = self._rand.uniform(0, failover_cooldown_s)
        self.failovers = 0
        #: trace id of the newest election this sentinel LED: every
        #: vote/promote/topology RPC of one failover
        #: records a span under this rid, so ``TraceGet``-style assembly
        #: and the black-box CLI can show the election hop by hop
        self.last_election_rid: Optional[str] = None
        self._stop = threading.Event()
        self._channels: dict = {}
        #: topology-push machinery: subscribers of
        #: the ``TopologyEvents`` stream wait on this version counter —
        #: every committed topology change bumps it (OUTSIDE the state
        #: lock, so the two locks never nest in both orders)
        self._topo_version = 0
        self._topo_cond = locks.named_condition("sentinel.topo_events")
        self._topo_subscribers = 0
        self._thread = threading.Thread(
            target=self._run, name="tpubloom-sentinel", daemon=True
        )
        self._server = grpc.server(
            futures.ThreadPoolExecutor(
                # subscribers park a worker each for their stream
                # lifetime — size past the unary handlers' needs
                max_workers=16, thread_name_prefix="sentinel-rpc"
            )
        )
        handlers = {
            m: grpc.unary_unary_rpc_method_handler(self._wrap(m))
            for m in protocol.SENTINEL_METHODS
        }
        handlers.update(
            {
                m: grpc.unary_stream_rpc_method_handler(self._wrap_stream(m))
                for m in protocol.SENTINEL_STREAM_METHODS
            }
        )
        self._server.add_generic_rpc_handlers(
            (
                grpc.method_handlers_generic_handler(
                    protocol.SENTINEL_SERVICE, handlers
                ),
            )
        )
        self.port = self._server.add_insecure_port(listen)
        host = listen.rsplit(":", 1)[0] or "127.0.0.1"
        self.address = f"{host}:{self.port}"

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "Sentinel":
        self._server.start()
        self._thread.start()
        log.info(
            "sentinel %s watching %s (quorum %d of %d, peers %s) on %s",
            self.sentinel_id, self.topology.primary, self.quorum,
            len(self.peers) + 1, self.peers, self.address,
        )
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._server.stop(grace=None)
        for ch in self._channels.values():
            ch.close()
        self._channels.clear()

    def _persist_state(self) -> None:
        """Write the failover memory through the state store (no-op
        without ``--state-dir``). Callers hold ``self._lock`` — the
        write must capture exactly the view they just committed."""
        if self._state_store is None:
            return
        try:
            self._state_store.store(
                self.topology.epoch,
                self._last_vote_epoch,
                self.topology.primary,
                self.topology.replicas,
                self._fence_watch,
            )
        except OSError:
            log.exception("sentinel state persist failed (non-fatal)")

    # -- RPC plumbing --------------------------------------------------------

    def _wrap(self, method: str):
        handler = getattr(self, "handle_" + method)

        def unary_unary(request: bytes, context) -> bytes:
            try:
                req = protocol.decode(request) if request else {}
                resp = handler(req)
            except Exception as e:  # noqa: BLE001 — surface, don't kill
                log.exception("sentinel RPC %s failed", method)
                resp = protocol.error_response(
                    "INTERNAL", f"{type(e).__name__}: {e}"
                )
            return protocol.encode(resp)

        return unary_unary

    def _wrap_stream(self, method: str):
        gen_fn = getattr(self, "stream_" + method)

        def unary_stream(request: bytes, context):
            try:
                req = protocol.decode(request) if request else {}
            except Exception:  # noqa: BLE001 — a bad frame is an empty req
                req = {}
            for msg in gen_fn(req, context):
                yield protocol.encode(msg)

        return unary_stream

    def _notify_topology(self) -> None:
        """Wake TopologyEvents subscribers. MUST be called with the
        state lock RELEASED: the stream generator takes the condition
        then the state lock, so taking them here in the opposite order
        would be a lock-order cycle (the runtime tracker enforces
        this)."""
        with self._topo_cond:
            self._topo_version += 1
            self._topo_cond.notify_all()
        _counters.incr("sentinel_topology_pushes")

    #: cap on concurrent TopologyEvents subscribers: each one parks a
    #: gRPC worker for its stream lifetime, and the pool is shared with
    #: VoteDown/Topology — unbounded subscribers would starve the very
    #: election RPCs the push exists to announce. Rejected subscribers
    #: get an error frame and fall back to refresh-on-error.
    MAX_TOPO_SUBSCRIBERS = 8

    def stream_TopologyEvents(
        self, req: dict, context, *, heartbeat_s: float = 1.0
    ):
        """Server-stream behind ``TopologyEvents``:
        the current view immediately, a fresh ``topology`` frame on
        every change, heartbeats while idle — subscribed clients
        re-point on failover without a refresh-on-error round trip."""
        with self._topo_cond:
            if self._topo_subscribers >= self.MAX_TOPO_SUBSCRIBERS:
                full = True
            else:
                full = False
                self._topo_subscribers += 1
        if full:
            yield {
                "kind": "error",
                "ok": False,
                "code": "SUBSCRIBERS_FULL",
                "message": "TopologyEvents subscriber cap reached on this "
                "sentinel; subscribe elsewhere or poll Topology",
            }
            return
        try:
            last = -1
            while context.is_active() and not self._stop.is_set():
                with self._topo_cond:
                    if self._topo_version == last:
                        self._topo_cond.wait(heartbeat_s)
                    version = self._topo_version
                if version != last:
                    last = version
                    with self._lock:
                        view = self.topology.to_dict()
                    yield {"kind": "topology", "ok": True, **view}
                else:
                    yield {"kind": "heartbeat", "epoch": self.topology.epoch}
        finally:
            with self._topo_cond:
                self._topo_subscribers -= 1

    def _channel(self, address: str):
        ch = self._channels.get(address)
        if ch is None:
            ch = grpc.insecure_channel(address, options=_CHANNEL_OPTIONS)
            self._channels[address] = ch
        return ch

    def _call(
        self,
        address: str,
        path: str,
        req: dict,
        timeout: Optional[float] = None,
    ) -> dict:
        locks.note_blocking("sentinel.rpc")
        raw = self._channel(address).unary_unary(
            path,
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b,
        )(protocol.encode(req), timeout=timeout or self.rpc_timeout_s)
        return protocol.decode(raw)

    def _node(
        self,
        address: str,
        method: str,
        req: dict,
        timeout: Optional[float] = None,
    ) -> dict:
        return self._call(
            address, protocol.method_path(method), req, timeout=timeout
        )

    def _peer(self, address: str, method: str, req: dict) -> dict:
        return self._call(address, protocol.sentinel_method_path(method), req)

    # -- sentinel RPC handlers ------------------------------------------------

    def handle_Ping(self, req: dict) -> dict:
        return {
            "ok": True,
            "sentinel_id": self.sentinel_id,
            "epoch": self.topology.epoch,
            "sdown": self._sdown,
        }

    def handle_Topology(self, req: dict) -> dict:
        """Client-facing discovery (SENTINEL get-master-addr parity)."""
        with self._lock:
            return {"ok": True, **self.topology.to_dict()}

    def handle_VoteDown(self, req: dict) -> dict:
        """Epoch-stamped leader vote: granted iff we ALSO see that
        primary down (our own SDOWN — the ODOWN agreement) and we have
        not voted in this epoch yet (the term discipline)."""
        faults.fire("ha.vote")
        epoch = int(req.get("epoch") or 0)
        primary = req.get("primary")
        with self._lock:
            granted = (
                primary == self.topology.primary
                and self._sdown
                and epoch > self.topology.epoch
                and epoch > self._last_vote_epoch
            )
            if granted:
                self._last_vote_epoch = epoch
                self._granted_at = time.monotonic()
                _counters.incr("sentinel_votes_granted")
                # the vote is a PROMISE (one per epoch) — it must
                # survive a restart or a rebooted sentinel could hand
                # the same epoch to a second candidate
                self._persist_state()
        return {
            "ok": True,
            "granted": granted,
            "epoch": self.topology.epoch,
            "sdown": self._sdown,
        }

    def handle_AnnounceTopology(self, req: dict) -> dict:
        """A failover leader announcing its result; adopt if newer."""
        incoming = Topology.from_dict(req)
        with self._lock:
            adopted = self.topology.adopt(incoming)
            if adopted:
                self._sdown = False
                self._first_fail = None
                old = req.get("fenced")
                if old:
                    self._fence_watch.add(old)
                self._persist_state()
                log.info(
                    "adopted topology epoch %d (primary %s) from peer",
                    incoming.epoch, incoming.primary,
                )
        if adopted:
            self._notify_topology()
        return {"ok": True, "adopted": adopted, "epoch": self.topology.epoch}

    # -- the monitor loop ----------------------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self._poll_primary()
                self._fence_stale_primaries()
                now = time.monotonic()
                if (
                    self._sdown
                    and now - self._last_failover_attempt
                    >= self.failover_cooldown_s + self._election_stagger
                    and not self._peer_leads(now)
                ):
                    self._last_failover_attempt = now
                    # re-roll the stagger per attempt so two sentinels
                    # whose retry slots collided once do not collide on
                    # every retry
                    self._election_stagger = self._rand.uniform(
                        0, self.failover_cooldown_s
                    )
                    self._attempt_failover()
            except Exception:  # noqa: BLE001 — the watcher must survive
                log.exception("sentinel monitor tick failed")

    def _peer_leads(self, now: float) -> bool:
        """Whether this sentinel granted a peer's vote recently enough that
        the peer may still be leading its failover: a failover may take up
        to promote_timeout, and our own candidacy holds back that long."""
        grant_holdoff = max(
            4 * self.failover_cooldown_s,
            self.failover_cooldown_s + self.promote_timeout_s,
        )
        return now - self._granted_at < grant_holdoff

    def _poll_primary(self) -> None:
        with self._lock:
            primary = self.topology.primary
        try:
            h = self._node(primary, "Health", {})
        except grpc.RpcError:
            now = time.monotonic()
            if self._first_fail is None:
                self._first_fail = now
            if not self._sdown and now - self._first_fail >= self.down_after_s:
                self._sdown = True
                # start the election clock HERE: every sentinel reaches
                # SDOWN within one poll period of the others, so an
                # immediately-eligible first attempt is a guaranteed
                # three-way self-vote tie. The staggered delay gives one
                # sentinel a clean head start instead (Redis Sentinel's
                # randomized failover start delay).
                self._last_failover_attempt = now
                _counters.incr("sentinel_sdown_entered")
                log.warning(
                    "sentinel %s: %s is subjectively DOWN",
                    self.sentinel_id, primary,
                )
            _counters.set_gauge("sentinel_sdown", 1.0 if self._sdown else 0.0)
            return
        self._first_fail = None
        if self._sdown:
            log.info("sentinel %s: %s is back", self.sentinel_id, primary)
        self._sdown = False
        _counters.set_gauge("sentinel_sdown", 0.0)
        changed = False
        with self._lock:
            node_epoch = int(h.get("epoch") or 0)
            if node_epoch > self.topology.epoch:
                self.topology.epoch = node_epoch
                self._persist_state()
                changed = True
            if h.get("role") == "replica":
                # the watched node was demoted behind our back (manual
                # REPLICAOF / a failover we missed): follow its view
                upstream = (h.get("replication") or {}).get("primary")
                if upstream and upstream != primary:
                    log.warning(
                        "watched node %s is now a replica of %s; following",
                        primary, upstream,
                    )
                    self._fence_watch.discard(upstream)
                    if primary not in self.topology.replicas:
                        self.topology.replicas.append(primary)
                    self.topology.primary = upstream
                    self._persist_state()
                    changed = True
            else:
                # discover announced replicas (INFO replication parity)
                sessions = (h.get("replication") or {}).get("replicas") or ()
                listens = [s.get("listen") for s in sessions if s.get("listen")]
                for addr in listens:
                    if addr not in self.topology.replicas:
                        self.topology.replicas.append(addr)
                        changed = True
                if changed:
                    self._persist_state()
                _counters.set_gauge(
                    "sentinel_known_replicas", len(self.topology.replicas)
                )
        if changed:
            self._notify_topology()

    def _fence_stale_primaries(self) -> None:
        """Demote any watched-for node that reappears claiming a stale
        primaryship — the restarted pre-failover primary."""
        with self._lock:
            watch = list(self._fence_watch)
            epoch, primary = self.topology.epoch, self.topology.primary
        for addr in watch:
            if addr == primary:
                with self._lock:
                    self._fence_watch.discard(addr)
                    self._persist_state()
                continue
            try:
                h = self._node(addr, "Health", {})
            except grpc.RpcError:
                continue
            if h.get("role") == "primary" and int(h.get("epoch") or 0) < epoch:
                log.warning(
                    "fencing stale primary %s (epoch %s < %d): demoting "
                    "to replica of %s",
                    addr, h.get("epoch"), epoch, primary,
                )
                try:
                    self._node(
                        addr,
                        "ReplicaOf",
                        {"primary": primary, "epoch": epoch},
                        timeout=self.promote_timeout_s,
                    )
                    _counters.incr("sentinel_fenced")
                except grpc.RpcError:
                    continue
            # demoted (by us or already a replica): back into the pool
            with self._lock:
                self._fence_watch.discard(addr)
                if (
                    addr != self.topology.primary
                    and addr not in self.topology.replicas
                ):
                    self.topology.replicas.append(addr)
                self._persist_state()
            self._notify_topology()

    # -- failover ------------------------------------------------------------

    def _adopt_completed_failover(self) -> bool:
        """Before spending an epoch on an election, look for a failover
        that ALREADY happened: a known replica claiming primaryship
        under a newer epoch means some leader finished while this
        sentinel was still counting misses (its AnnounceTopology may be
        in flight, or lost). Adopting it is cheaper than dueling — and
        dueling elections under load are exactly how a quorum burns
        epochs re-promoting the same node."""
        with self._lock:
            candidates = list(self.topology.replicas)
            epoch = self.topology.epoch
            old_primary = self.topology.primary
        for addr in candidates:
            try:
                h = self._node(addr, "Health", {})
            except grpc.RpcError:
                continue
            if h.get("role") == "primary" and int(h.get("epoch") or 0) > epoch:
                incoming = Topology(
                    epoch=int(h["epoch"]),
                    primary=addr,
                    replicas=[a for a in candidates if a != addr],
                )
                with self._lock:
                    if self.topology.adopt(incoming):
                        self._sdown = False
                        self._first_fail = None
                        self._fence_watch.add(old_primary)
                        self._persist_state()
                self._notify_topology()
                log.info(
                    "adopted completed failover: %s is primary at epoch %d",
                    addr, incoming.epoch,
                )
                _counters.incr("sentinel_failovers_adopted")
                return True
        return False

    def _attempt_failover(self) -> None:
        if self._adopt_completed_failover():
            return
        with self._lock:
            if self._peer_leads(time.monotonic()):
                # a peer's VoteDown took our vote while we probed the
                # replicas: that peer leads this failover, and an election
                # of our own at the next epoch could win too and promote a
                # second time. Checked under the lock the grant takes, so
                # a later VoteDown meets our self-vote and is refused.
                return
            new_epoch = max(self.topology.epoch, self._last_vote_epoch) + 1
            primary = self.topology.primary
            # vote for ourselves (term discipline: once per epoch) —
            # persisted like any granted vote
            self._last_vote_epoch = new_epoch
            self._persist_state()
        faults.fire("ha.vote")
        # election trace id: deterministic per
        # (epoch, sentinel), so two sentinels dueling the same epoch
        # still produce distinguishable traces. Every RPC span of this
        # election spills to the black box — elections are crash
        # forensics by definition.
        rid = f"election-{new_epoch}-{self.sentinel_id[:8]}"
        self.last_election_rid = rid
        tracing = obs_trace.enabled()
        votes = 1
        for peer in self.peers:
            w0 = time.time()
            t0 = time.perf_counter()
            granted = ok = False
            try:
                resp = self._peer(
                    peer,
                    "VoteDown",
                    {"epoch": new_epoch, "primary": primary,
                     "candidate": self.sentinel_id},
                )
                ok = True
                granted = bool(resp.get("granted"))
            except grpc.RpcError:
                pass
            finally:
                if tracing:
                    obs_trace.record_span(
                        "sentinel.vote_down",
                        rid=rid,
                        start=w0,
                        duration_s=time.perf_counter() - t0,
                        attrs={"peer": peer, "epoch": new_epoch,
                               "ok": ok, "granted": granted},
                        spill=True,
                    )
            if granted:
                votes += 1
        _counters.set_gauge("sentinel_last_election_votes", votes)
        if votes < self.quorum:
            log.info(
                "sentinel %s: election for epoch %d got %d/%d votes; "
                "will retry",
                self.sentinel_id, new_epoch, votes, self.quorum,
            )
            return
        _counters.incr("sentinel_odown_agreed")
        log.warning(
            "sentinel %s: %s is objectively DOWN (%d/%d votes) — leading "
            "failover epoch %d",
            self.sentinel_id, primary, votes, self.quorum, new_epoch,
        )
        self._do_failover(new_epoch, primary, rid=rid)

    def _verify_promoted(self, addr: str, epoch: int) -> bool:
        """Did a Promote that timed out client-side land anyway? Poll the
        candidate's Health briefly for ``role=primary`` at (or past) the
        election epoch."""
        deadline = time.monotonic() + self.promote_timeout_s
        while time.monotonic() < deadline:
            try:
                h = self._node(addr, "Health", {})
                if (
                    h.get("role") == "primary"
                    and int(h.get("epoch") or 0) >= epoch
                ):
                    return True
            except grpc.RpcError:
                pass
            time.sleep(min(0.2, self.poll_s))
        return False

    def _replica_cursor(self, addr: str) -> Optional[int]:
        """Catch-up metric for candidate ranking: the replica's applied
        cursor (higher = fresher; lowest repl_lag_seq by construction)."""
        try:
            h = self._node(addr, "Health", {})
        except grpc.RpcError:
            return None
        repl = h.get("replication") or {}
        cursor = repl.get("cursor")
        return int(cursor) if cursor is not None else 0

    def _do_failover(
        self, epoch: int, old_primary: str, rid: Optional[str] = None
    ) -> None:
        tracing = obs_trace.enabled() and rid is not None
        with self._lock:
            candidates = [
                a for a in self.topology.replicas if a != old_primary
            ]
        ranked = sorted(
            (
                (cursor, addr)
                for addr in candidates
                if (cursor := self._replica_cursor(addr)) is not None
            ),
            key=lambda t: (-t[0], t[1]),
        )
        if not ranked:
            log.error(
                "failover epoch %d: no reachable replica to promote", epoch
            )
            return
        for cursor, winner in ranked:
            w0 = time.time()
            t0 = time.perf_counter()
            try:
                resp = self._node(
                    winner,
                    "Promote",
                    {"epoch": epoch},
                    timeout=self.promote_timeout_s,
                )
            except grpc.RpcError as e:
                # a timed-out Promote may still have LANDED (it is not
                # idempotent to just try the next candidate — that is
                # how co-primaries duel). Verify before moving on.
                if self._verify_promoted(winner, epoch):
                    resp = {"ok": True}
                else:
                    if tracing:
                        obs_trace.record_span(
                            "sentinel.promote",
                            rid=rid,
                            start=w0,
                            duration_s=time.perf_counter() - t0,
                            attrs={"candidate": winner, "epoch": epoch,
                                   "ok": False},
                            spill=True,
                        )
                    log.warning(
                        "failover epoch %d: promoting %s failed (%s); "
                        "trying the next candidate",
                        epoch, winner, getattr(e, "code", lambda: e)(),
                    )
                    continue
            if tracing:
                obs_trace.record_span(
                    "sentinel.promote",
                    rid=rid,
                    start=w0,
                    duration_s=time.perf_counter() - t0,
                    attrs={"candidate": winner, "epoch": epoch,
                           "ok": bool(resp.get("ok"))},
                    spill=True,
                )
            if not resp.get("ok"):
                log.warning(
                    "failover epoch %d: %s refused promotion: %s",
                    epoch, winner, resp.get("error"),
                )
                continue
            survivors = [a for a in candidates if a != winner]
            with self._lock:
                self.topology = Topology(
                    epoch=epoch, primary=winner, replicas=list(survivors)
                )
                self._sdown = False
                self._first_fail = None
                self._fence_watch.add(old_primary)
                self._persist_state()
            self._notify_topology()
            self.failovers += 1
            _counters.incr("sentinel_failovers")
            # flight recorder: the completed election is the
            # anchor event every failover post-mortem is built around
            obs_flight.note(
                "election", epoch=int(epoch), winner=winner,
                old_primary=old_primary, survivors=len(survivors),
            )
            log.warning(
                "failover epoch %d: promoted %s (cursor %s); re-pointing "
                "%d survivor(s)",
                epoch, winner, cursor, len(survivors),
            )
            for addr in survivors:
                try:
                    self._node(
                        addr,
                        "ReplicaOf",
                        {"primary": winner, "epoch": epoch},
                        timeout=self.promote_timeout_s,
                    )
                except grpc.RpcError:
                    log.warning(
                        "failover epoch %d: could not re-point %s (it "
                        "will be fenced/re-pointed when reachable)",
                        epoch, addr,
                    )
                    with self._lock:
                        self._fence_watch.add(addr)
                        self._persist_state()
            announce = {
                **self.topology.to_dict(),
                "fenced": old_primary,
                "leader": self.sentinel_id,
            }
            for peer in self.peers:
                w0 = time.time()
                t0 = time.perf_counter()
                pushed = False
                try:
                    self._peer(peer, "AnnounceTopology", announce)
                    pushed = True
                except grpc.RpcError:
                    pass
                if tracing:
                    obs_trace.record_span(
                        "sentinel.topology",
                        rid=rid,
                        start=w0,
                        duration_s=time.perf_counter() - t0,
                        attrs={"peer": peer, "epoch": epoch,
                               "ok": pushed},
                        spill=True,
                    )
            return
        log.error("failover epoch %d: every candidate refused", epoch)


def main(argv: Optional[list] = None) -> None:
    """``python -m tpubloom_torch.sentinel --watch HOST:PORT [--peers A B ...]
    [--port N] [--quorum N] [--down-after S] [--poll S]``"""
    import sys as _sys

    parser = argparse.ArgumentParser(
        prog="tpubloom_torch.sentinel",
        description="tpubloom failover watcher (Redis Sentinel parity)",
    )
    parser.add_argument(
        "--watch", required=True, metavar="HOST:PORT",
        help="the primary to monitor",
    )
    parser.add_argument(
        "--peers", nargs="*", default=[], metavar="HOST:PORT",
        help="the other sentinels of the quorum",
    )
    parser.add_argument(
        "--port", type=int, default=26379,
        help="this sentinel's gRPC port (default 26379)",
    )
    parser.add_argument(
        "--quorum", type=int, default=None,
        help="votes needed for ODOWN+failover (default: majority)",
    )
    parser.add_argument(
        "--down-after", type=float, default=1.5,
        help="seconds of failed polls before SDOWN (default 1.5)",
    )
    parser.add_argument(
        "--poll", type=float, default=0.25,
        help="health poll interval in seconds (default 0.25)",
    )
    parser.add_argument(
        "--state-dir", default=None,
        help="persist failover memory (topology epoch + vote discipline) "
        "to a CRC-checked sentinel_state.json in this directory, so a "
        "restart resumes at the post-failover view (default: in-memory "
        "only)",
    )
    args = parser.parse_args(
        list(_sys.argv[1:]) if argv is None else list(argv)
    )
    logging.basicConfig(level=logging.INFO)
    faults.load_env()
    if args.state_dir:
        # crash-forensics black box: a sentinel with durable
        # state gets durable forensics too — its election spans spill
        # into <state-dir>/blackbox/ and the boot event anchors which
        # process wrote them. Tracing arms at sample 0.0: only the
        # explicit election spans record, nothing else pays.
        obs_blackbox.configure(
            args.state_dir, node={"addr": f"0.0.0.0:{args.port}"}
        )
        obs_trace.ensure_enabled()
        obs_flight.note(
            "boot", role="sentinel", epoch=0, addr=f"0.0.0.0:{args.port}"
        )
    sentinel = Sentinel(
        args.watch,
        args.peers,
        listen=f"0.0.0.0:{args.port}",
        quorum=args.quorum,
        poll_s=args.poll,
        down_after_s=args.down_after,
        state_dir=args.state_dir,
    ).start()
    log.info("sentinel serving on :%d", sentinel.port)
    stop = threading.Event()
    import signal

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda signum, frame: stop.set())
    stop.wait()
    sentinel.stop()
