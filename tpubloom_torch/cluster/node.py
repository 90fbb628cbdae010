"""Per-node cluster state: slot ownership checks, redirects, forwarding.

One :class:`ClusterState` hangs off a cluster-enabled
:class:`tpubloom_torch.server.service.BloomService` (``--cluster``). The RPC
wrapper consults it on every keyed data-plane request:

* slot owned here → serve;
* slot owned elsewhere → ``MOVED <slot> <addr>`` (Redis parity: the
  client updates its slot cache and re-routes);
* slot **migrating** away and the filter is already gone → ``ASK <slot>
  <target>`` (one-shot redirect, no cache update);
* slot **importing** here → served only when the request carries the
  ``asking`` flag (the client's ASK follow-up, or the source's
  dual-write forward).

Migration support (see :mod:`tpubloom_torch.cluster.migrate`):

* ``forwarding`` — filter name → target address: the dual-write window.
  After a mutating RPC commits (and clears its durability barrier), the
  wrapper forwards it to the target with the ORIGINAL rid and its
  source-log ``src_seq``; the entry stays after the handoff so
  straggling in-flight writes still forward (bounded: one entry per
  migrated filter).
* ``import gates`` — target-side exactly-once bookkeeping: a gate is
  seeded at snapshot install with the source seq the blob covers
  (``base``), and every applied forward records its ``src_seq``. A
  forward at or below the base, or already seen, short-circuits to an
  OK response without re-applying — counting filters never
  double-apply even when the tail replay and the live dual-write
  deliver the same record twice. (Concurrent duplicate deliveries share
  the original rid, so the rid-dedup cache covers the race the
  gate cannot.)

Node→node RPCs (installs, forwards, SETSLOT pushes) go through
:meth:`ClusterState.call` — a cached-channel msgpack/gRPC hop that
declares itself to the runtime lock tracker (``note_blocking``), so a
forward under a filter or registry lock is a lint/runtime finding.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import grpc

from tpubloom_torch.cluster import slots as slots_mod
from tpubloom_torch.obs import counters as _counters
from tpubloom_torch.server import protocol
from tpubloom_torch.utils import locks

log = logging.getLogger("tpubloom.cluster")

#: Keyed data-plane methods subject to the slot-ownership check (every
#: method whose request names one filter). Control-plane and
#: migration-internal verbs are exempt on purpose.
KEYED_METHODS = frozenset(
    {
        "CreateFilter",
        "DropFilter",
        "InsertBatch",
        "QueryBatch",
        "DeleteBatch",
        "Clear",
        "Stats",
        "Checkpoint",
        # sketch-plane verbs are keyed like their bloom
        # counterparts — same slot routing, same MOVED/ASK machinery
        "CFReserve",
        "CFAdd",
        "CFDel",
        "CFExists",
        "CMSInitByDim",
        "CMSIncrBy",
        "CMSQuery",
        "TopKReserve",
        "TopKAdd",
        "TopKList",
    }
)

#: Per-import-gate bound on remembered src seqs. src seqs are GLOBAL
#: source-log seqs (interleaved with other filters' records), so there
#: is no contiguity to compact on; instead, once the set doubles past
#: this bound the OLDEST half folds into the base watermark. Safe in
#: practice because forwards are synchronous-with-the-ack and re-driven
#: within bounded budgets: by the time 65536 NEWER claims exist, a
#: delivery of an older record has long since succeeded or been
#: re-driven — and the whole gate drops at handoff finalize anyway.
GATE_SEEN_MAX = 65536

#: How long a dual-write forward entry outlives its slot's handoff
#: (ROADMAP 1(d)). Entries must linger PAST the
#: finalize — straggling in-flight writes that raced the ownership flip
#: still forward through them — but before this, they lingered forever
#: and grew without bound on slot churn. After the TTL a forward for a
#: finalized slot answers MOVED at this node anyway (ownership already
#: flipped), so expiry loses nothing.
FORWARD_TTL_S = 60.0

_CHANNEL_OPTIONS = list(protocol.CHANNEL_OPTIONS)


class ClusterState:
    """Slot map + migration bookkeeping for one cluster node."""

    def __init__(
        self,
        self_addr: str,
        state_dir: Optional[str] = None,
        *,
        forward_ttl_s: float = FORWARD_TTL_S,
    ):
        self.self_addr = self_addr
        self._lock = locks.named_lock("cluster.state")
        self._store = slots_mod.SlotStore(state_dir) if state_dir else None
        self.slots = (self._store.load() if self._store else None) or slots_mod.SlotMap()
        #: filter name -> target addr: dual-write forwards (source side)
        self._forwarding: dict = {}
        #: filter name -> monotonic time its slot's handoff finalized;
        #: entries older than ``forward_ttl_s`` past that moment expire
        self._forward_retired: dict = {}
        self.forward_ttl_s = float(forward_ttl_s)
        #: filter name -> {"base": int, "seen": set} (target side)
        self._gates: dict = {}
        self._channels: dict = {}
        self._update_gauges_locked()

    # -- persistence / gauges -------------------------------------------------

    def _persist_locked(self) -> None:
        if self._store is None:
            return
        try:
            self._store.store(self.slots)
        except OSError:
            log.exception("cluster slot map persist failed (non-fatal)")

    def _update_gauges_locked(self) -> None:
        owned = sum(1 for a in self.slots.owners.values() if a == self.self_addr)
        _counters.set_gauge("cluster_slots_owned", owned)
        _counters.set_gauge("cluster_slots_migrating", len(self.slots.migrating))
        _counters.set_gauge("cluster_slots_importing", len(self.slots.importing))
        _counters.set_gauge("cluster_config_epoch", self.slots.epoch)

    # -- views ----------------------------------------------------------------

    def describe(self) -> dict:
        with self._lock:
            return {"self": self.self_addr, **self.slots.to_dict()}

    def owner(self, slot: int) -> Optional[str]:
        with self._lock:
            return self.slots.owner(slot)

    def epoch(self) -> int:
        with self._lock:
            return self.slots.epoch

    def is_importing(self, slot: int) -> bool:
        with self._lock:
            return slot in self.slots.importing

    def summary(self) -> dict:
        """Small Health-embeddable view (full map via ClusterSlots)."""
        with self._lock:
            return {
                "epoch": self.slots.epoch,
                "slots_owned": sum(
                    1 for a in self.slots.owners.values()
                    if a == self.self_addr
                ),
                "migrating": len(self.slots.migrating),
                "importing": len(self.slots.importing),
            }

    # -- the ownership check --------------------------------------------------

    def check(
        self,
        name: str,
        *,
        asking: bool = False,
        exists: bool = False,
        primary_address: Optional[str] = None,
    ) -> None:
        """Raise the redirect for one keyed request, or return None to
        serve it. ``exists`` = the filter is present in the local
        registry (the ASK decision on a migrating slot).
        ``primary_address`` lets a shard REPLICA serve slots its primary
        owns (reads route to replicas through the topology client;
        the slot map names the shard by its primary)."""
        slot = slots_mod.key_slot(name)
        with self._lock:
            owner = self.slots.owner(slot)
            migrating_to = self.slots.migrating.get(slot)
            importing = slot in self.slots.importing
        if owner is None:
            raise protocol.BloomServiceError(
                "CLUSTERDOWN",
                f"slot {slot} is unassigned — the cluster map is "
                f"incomplete on this node",
                details={"slot": slot},
            )
        if owner == self.self_addr or (
            primary_address is not None and owner == primary_address
        ):
            if migrating_to is not None and not exists:
                # mid-migration, a filter no longer (or never) here
                # belongs to the target — one-shot redirect, Redis ASK
                _counters.incr("cluster_ask_redirects")
                raise protocol.BloomServiceError(
                    "ASK",
                    f"ASK {slot} {migrating_to}",
                    details={"slot": slot, "addr": migrating_to},
                )
            return
        if importing and asking:
            return  # the client's ASK follow-up / a migration forward
        _counters.incr("cluster_moved_redirects")
        raise protocol.BloomServiceError(
            "MOVED",
            f"MOVED {slot} {owner}",
            details={"slot": slot, "addr": owner, "epoch": self.slots.epoch},
        )

    # -- admin verbs (ClusterSetSlot) ----------------------------------------

    def set_slot(self, req: dict) -> dict:
        """``ClusterSetSlot`` handler logic (Redis ``CLUSTER SETSLOT``
        parity, plus a bulk ``assign`` form the rebalancer uses to push
        whole maps):

        * ``{"assign": [[start, end, addr], ...], "epoch": E}`` — adopt
          a full assignment at config epoch E (rejected when older than
          the current map);
        * ``{"slot": S, "state": "migrating", "addr": target}`` — mark S
          as handing off (source side);
        * ``{"slot": S, "state": "importing", "addr": source}`` — mark S
          as arriving (target side);
        * ``{"slot": S, "state": "node", "addr": owner, "epoch": E}`` —
          finalize: S now belongs to ``owner`` at epoch E; clears the
          migration marks (import GATES deliberately survive — see the
          inline note: straggler forwards still need them);
        * ``{"slot": S, "state": "stable"}`` — clear migration marks
          without changing ownership (abort).
        """
        with self._lock:
            if "assign" in req:
                epoch = int(req.get("epoch") or 0)
                if not self.slots.adopt_assignments(req["assign"], epoch):
                    raise protocol.BloomServiceError(
                        "STALE_EPOCH",
                        f"assignment epoch {epoch} predates the current "
                        f"map epoch {self.slots.epoch}",
                        details={"epoch": self.slots.epoch},
                    )
                self._persist_locked()
                self._update_gauges_locked()
                return {"ok": True, "epoch": self.slots.epoch}
            slot = int(req["slot"])
            state = req.get("state")
            addr = req.get("addr")
            if state in ("migrating", "importing"):
                # a mark issued under an OLDER view than this node's is
                # a stale source trying to re-open a finished handoff —
                # honoring it would let its stale blob overwrite state
                # the rightful owner has since absorbed writes into
                req_epoch = req.get("epoch")
                if req_epoch is not None and int(req_epoch) < self.slots.epoch:
                    raise protocol.BloomServiceError(
                        "STALE_EPOCH",
                        f"{state} mark for slot {slot} was issued under "
                        f"epoch {req_epoch}, but this node's map is at "
                        f"{self.slots.epoch}",
                        details={"epoch": self.slots.epoch},
                    )
                if state == "migrating":
                    self.slots.migrating[slot] = addr
                else:
                    self.slots.importing[slot] = addr
            elif state == "stable":
                self.slots.migrating.pop(slot, None)
                self.slots.importing.pop(slot, None)
            elif state == "node":
                epoch = int(req.get("epoch") or (self.slots.epoch + 1))
                if epoch < self.slots.epoch:
                    raise protocol.BloomServiceError(
                        "STALE_EPOCH",
                        f"slot epoch {epoch} predates the current map "
                        f"epoch {self.slots.epoch}",
                        details={"epoch": self.slots.epoch},
                    )
                self.slots.owners[slot] = addr
                self.slots.epoch = epoch
                self.slots.migrating.pop(slot, None)
                self.slots.importing.pop(slot, None)
                # import gates deliberately SURVIVE the finalize:
                # straggler forwards and same-rid re-drives that raced
                # the handoff still need the "is this record already
                # contained?" answer (a record the snapshot covered
                # must dup out, not re-apply). A later re-import of the
                # slot reseeds per filter; the src tag keeps a stale
                # gate from judging a DIFFERENT source's seq space.
                if addr == self.self_addr:
                    # the slot came (back) to us: stale dual-write
                    # forwards for its filters would bounce off our own
                    # ownership — drop them
                    for n in [
                        name for name in self._forwarding
                        if slots_mod.key_slot(name) == slot
                    ]:
                        del self._forwarding[n]
                        self._forward_retired.pop(n, None)
                else:
                    # handoff finalized AWAY: start the forward entries'
                    # retirement clock (ROADMAP 1(d) — they used to be
                    # kept forever and grew on churn). Stragglers keep
                    # forwarding until the TTL; the sweep reaps after.
                    now = time.monotonic()
                    for n in self._forwarding:
                        if slots_mod.key_slot(n) == slot:
                            self._forward_retired.setdefault(n, now)
                self._sweep_forwards_locked()
            else:
                raise protocol.BloomServiceError(
                    "INVALID_ARGUMENT",
                    f"unknown ClusterSetSlot state {state!r} (want "
                    f"assign | migrating | importing | node | stable)",
                )
            self._persist_locked()
            self._update_gauges_locked()
            return {"ok": True, "epoch": self.slots.epoch, "slot": slot}

    # -- migration bookkeeping ------------------------------------------------

    def begin_forwarding(self, name: str, target: str) -> None:
        with self._lock:
            self._forwarding[name] = target
            # a re-armed migration resets any earlier retirement clock
            self._forward_retired.pop(name, None)

    def _sweep_forwards_locked(self) -> None:
        """Reap forward entries whose handoff finalized more than
        ``forward_ttl_s`` ago: straggler in-flight
        writes have long since landed or been re-driven, and on slot
        churn the entries otherwise accumulate forever."""
        if not self._forward_retired:
            return
        cutoff = time.monotonic() - self.forward_ttl_s
        expired = [
            n for n, at in self._forward_retired.items() if at <= cutoff
        ]
        for n in expired:
            self._forward_retired.pop(n, None)
            self._forwarding.pop(n, None)
        if expired:
            _counters.incr("cluster_forward_entries_expired", len(expired))

    def forward_target(self, name: str) -> Optional[str]:
        """Where a committed write on ``name`` must dual-write to, or
        None. Falls back to the PERSISTED ``migrating`` mark when the
        in-memory entry is gone (a restarted source must not ack writes
        it no longer forwards — the marks survive the crash, the dict
        does not; such forwards fail ``IMPORT_NOT_READY`` on the target
        until the re-driven migration reseeds the gate, which turns a
        silent stranded-write into a client-visible retry). Entries of a
        FINALIZED handoff age out after ``forward_ttl_s``."""
        with self._lock:
            self._sweep_forwards_locked()
            target = self._forwarding.get(name)
            if target is None:
                target = self.slots.migrating.get(slots_mod.key_slot(name))
            return target

    def seed_gate(self, name: str, base: int) -> None:
        """Target side: start (or reset) the exactly-once gate for one
        migrating filter — ``base`` is the source seq the just-installed
        snapshot covers. The gate remembers WHICH source it judges
        (src seqs are per-source-log): a later re-import of the slot
        from a different node must not be judged against it."""
        with self._lock:
            self._gates[name] = {
                "base": int(base),
                "seen": set(),
                "src": self.slots.importing.get(slots_mod.key_slot(name)),
            }

    def gate_base(self, name: str) -> Optional[int]:
        """The gate's snapshot-coverage seq — None when there is no
        gate, or when the slot is importing from a DIFFERENT source
        than the gate was seeded by (stale gate: the resume probe then
        answers "nothing here" and the source re-ships the blob)."""
        with self._lock:
            gate = self._gates.get(name)
            if gate is None:
                return None
            src = self.slots.importing.get(slots_mod.key_slot(name))
            if src is not None and gate.get("src") != src:
                return None
            return gate["base"]

    def gate_claim(self, name: str, src_seq: int) -> bool:
        """Atomically CLAIM one forwarded record for apply; False when
        the record is already contained here (snapshot coverage, an
        earlier delivery, or a concurrent claim) — the caller answers a
        dup ack without re-applying. Check-and-record must be one step:
        a migration's op-log-tail replay and the live dual-write can
        deliver the SAME record concurrently, and two non-atomic checks
        would both pass and double-apply a counting filter."""
        with self._lock:
            gate = self._gates.get(name)
            if gate is None:
                return True  # no gate: not an importing filter
            if src_seq <= gate["base"] or src_seq in gate["seen"]:
                return False
            gate["seen"].add(int(src_seq))
            if len(gate["seen"]) > 2 * GATE_SEEN_MAX:
                # fold the OLDEST half into the base watermark (see the
                # GATE_SEEN_MAX note for why this is safe) — the seqs
                # are global log seqs, so contiguity-based compaction
                # would never remove anything
                ordered = sorted(gate["seen"])
                cut = ordered[len(ordered) // 2 - 1]
                gate["seen"] = {s for s in gate["seen"] if s > cut}
                gate["base"] = max(gate["base"], cut)
            return True

    def gate_unclaim(self, name: str, src_seq: int) -> None:
        """Roll a claim back after the APPLY itself failed (the record
        is not contained after all, so a re-delivery must pass)."""
        with self._lock:
            gate = self._gates.get(name)
            if gate is not None:
                gate["seen"].discard(int(src_seq))

    # -- node→node RPC --------------------------------------------------------

    def call(
        self, addr: str, method: str, req: dict, timeout: float = 30.0
    ) -> dict:
        """One msgpack/gRPC unary call to a peer node; raises
        :class:`protocol.BloomServiceError` on an error answer."""
        locks.note_blocking("cluster.link")
        with self._lock:
            ch = self._channels.get(addr)
            if ch is None:
                ch = grpc.insecure_channel(addr, options=_CHANNEL_OPTIONS)  # lint: allow(blocking-under-lock): channel construction is lazy + non-connecting; the actual RPC below runs outside the lock
                self._channels[addr] = ch
        raw = ch.unary_unary(
            protocol.method_path(method),
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b,
        )(protocol.encode(req), timeout=timeout)
        return protocol.check(protocol.decode(raw))

    def close(self) -> None:
        with self._lock:
            channels = list(self._channels.values())
            self._channels.clear()
        for ch in channels:
            ch.close()
