"""Cluster-aware Python client.

Routes every keyed call by ``key_slot(filter_name)`` through a cached
slot→shard map (fetched via ``ClusterSlots``; Redis cluster-client
parity) and heals the two redirect kinds the servers emit:

* ``MOVED <slot> <addr>`` — ownership changed (a finalized migration or
  a stale map): the cache entry is updated, the full map re-fetched
  best-effort, and the call retried at the new owner;
* ``ASK <slot> <addr>`` — slot mid-migration and the filter already
  lives at the target: ONE follow-up call flagged ``asking`` goes to
  the target, with no cache update (the source still owns the slot).

Each shard is a full :class:`~tpubloom_torch.server.client.BloomClient`
— pass ``shards=[{"sentinels": [...]}, ...]`` and every shard keeps its
own sentinel-managed primary/replica set: failovers inside a shard are
healed by that shard's client (sentinel refresh, rid-safe write
re-drive), while slot moves between shards are healed here. With
``topology_push=True`` each sentinel-backed shard also subscribes to
the sentinels' ``TopologyEvents`` stream so a
failover re-points the shard client without waiting for an error.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import grpc

from tpubloom_torch.cluster import slots as slots_mod
from tpubloom_torch.obs import counters as obs_counters
from tpubloom_torch.obs import trace as trace_mod
from tpubloom_torch.server import protocol
from tpubloom_torch.server.client import BloomClient
from tpubloom_torch.utils import locks

#: keyed-call retry budget across MOVED/CLUSTERDOWN re-routes.
MAX_REDIRECTS = 8


class ClusterClient:
    """Blocking cluster client; one per cluster, filters addressed by name."""

    def __init__(
        self,
        startup_nodes: Optional[Sequence[str]] = None,
        *,
        shards: Optional[Sequence[dict]] = None,
        topology_push: bool = False,
        **client_kwargs,
    ):
        """``startup_nodes`` — any cluster node addresses to bootstrap
        the slot map from. ``shards`` — richer per-shard config:
        ``{"primary": addr}`` and/or ``{"sentinels": [addr, ...]}``
        entries; sentinel-backed shards survive their own failovers via
        the topology machinery. ``client_kwargs`` pass through to
        every underlying :class:`BloomClient` (timeouts, retries,
        breaker...)."""
        self._kwargs = dict(client_kwargs)
        self._kwargs.setdefault("breaker_threshold", 0)
        self._lock = locks.named_lock("cluster.client")
        #: rid of the newest logical keyed call (shared by its hops)
        self.last_rid: Optional[str] = None
        #: slot -> shard address (the server-side map's owner strings)
        self._slot_owner: dict = {}
        self.epoch = 0
        self._shard_clients: list = []
        self._direct: dict = {}
        self._startup = list(startup_nodes or ())
        for shard in shards or ():
            sentinels = list(shard.get("sentinels") or ())
            if sentinels:
                c = BloomClient(
                    shard.get("primary"), sentinels=sentinels, **self._kwargs
                )
                if topology_push:
                    c.enable_topology_push()
            else:
                c = BloomClient(shard["primary"], **self._kwargs)
            self._shard_clients.append(c)
        self.refresh_slots()

    # -- slot map / routing ---------------------------------------------------

    def _candidates(self) -> list:
        with self._lock:
            direct = list(self._direct.values())
        return self._shard_clients + direct

    def refresh_slots(self) -> bool:
        """Re-fetch the slot map from the first answering node; adopt it
        iff its config epoch is not older than the cached one."""
        probes = list(self._candidates())
        with self._lock:
            known = set(self._slot_owner.values())
        for addr in list(self._startup) + sorted(known):
            if all(c.address != addr for c in probes):
                probes.append(self._client_for(addr))
        for client in probes:
            try:
                resp = client._rpc("ClusterSlots", {})
            except (grpc.RpcError, protocol.BloomServiceError):
                continue
            if not resp.get("enabled") or not resp.get("ranges"):
                continue
            epoch = int(resp.get("epoch") or 0)
            with self._lock:
                if epoch < self.epoch:
                    continue
                self.epoch = epoch
                self._slot_owner = slots_mod.expand_ranges(resp["ranges"])
            obs_counters.incr("client_slot_refreshes")
            return True
        return False

    def _client_for(self, addr: str) -> BloomClient:
        """The shard client currently serving ``addr`` (shard clients
        re-point themselves across failovers), else a cached direct
        client."""
        for c in self._shard_clients:
            if c.address == addr:
                return c
        with self._lock:
            c = self._direct.get(addr)
        if c is not None:
            return c
        # maybe a shard failed over and addr is its NEW primary — let
        # sentinel-backed shards refresh before dialing directly
        for c in self._shard_clients:
            if c.sentinels:
                c.refresh_topology()
                if c.address == addr:
                    return c
        c = BloomClient(addr, **self._kwargs)
        with self._lock:
            self._direct[addr] = c
        return c

    def slot_of(self, name: str) -> int:
        return slots_mod.key_slot(name)

    def _owner_addr(self, slot: int) -> str:
        with self._lock:
            addr = self._slot_owner.get(slot)
        if addr is None:
            self.refresh_slots()
            with self._lock:
                addr = self._slot_owner.get(slot)
        if addr is None:
            raise protocol.BloomServiceError(
                "CLUSTERDOWN",
                f"slot {slot} has no known owner (no node answered "
                f"ClusterSlots with an assignment)",
                details={"slot": slot},
            )
        return addr

    @staticmethod
    def _hop_req(client: BloomClient, req: dict, keys, extra=None) -> dict:
        """One hop's request under the TARGET connection's negotiated
        encoding: key
        batches ride the per-shard ``BloomClient``'s zero-copy
        ``keys_fixed`` path when that shard's Health advertised it,
        falling back to the msgpack list per connection. Encoding per
        HOP matters: redirect targets negotiate independently."""
        r = dict(req)
        if keys is not None:
            r = client._encode_keys(r, keys)
        if extra:
            r.update(extra)
        return r

    def _keyed(
        self,
        method: str,
        req: dict,
        *,
        rid: Optional[str] = None,
        keys=None,
    ) -> dict:
        """Route one keyed request by its filter name, healing
        MOVED/ASK/CLUSTERDOWN along the way. One logical call = one rid
        across every redirect hop and re-drive (so a hop that applied
        before failing answers its replay from the dedup cache).
        ``keys`` (raw, unencoded) are folded into each hop's request
        under that hop's negotiated wire encoding."""
        from tpubloom_torch.obs.context import new_rid

        rid = rid or new_rid()
        self.last_rid = rid
        slot = slots_mod.key_slot(req["name"])
        last: Optional[protocol.BloomServiceError] = None
        for attempt in range(MAX_REDIRECTS):
            try:
                # inside the try: a client-side CLUSTERDOWN (map gap
                # mid-rebalance) must burn a retry + backoff like the
                # server-sent one, not abort the whole budget
                addr = self._owner_addr(slot)
                client = self._client_for(addr)
                return client._rpc(
                    method, self._hop_req(client, req, keys), rid=rid
                )
            except protocol.BloomServiceError as e:
                last = e
                if e.code == "MOVED":
                    obs_counters.incr("client_moved_redirects")
                    new = e.details.get("addr")
                    with self._lock:
                        # the redirecting node's epoch is authoritative
                        # for this slot: adopting it keeps the refresh
                        # below from re-adopting an equal-epoch STALE
                        # map off a node the migration never touched
                        self.epoch = max(
                            self.epoch, int(e.details.get("epoch") or 0)
                        )
                        if new:
                            self._slot_owner[slot] = new
                    # the whole map probably changed (a finalized
                    # migration bumps the epoch) — refresh opportunistically,
                    # then RE-apply the hint: it is fresher than any map
                    # a lagging node could have answered with
                    self.refresh_slots()
                    if new:
                        with self._lock:
                            self._slot_owner[slot] = new
                    continue
                if e.code == "ASK":
                    obs_counters.incr("client_ask_redirects")
                    target = self._client_for(e.details["addr"])
                    return target._rpc(
                        method,
                        self._hop_req(target, req, keys, {"asking": True}),
                        rid=rid,
                    )
                if e.code == "CLUSTERDOWN":
                    self.refresh_slots()
                    time.sleep(0.05 * (attempt + 1))
                    continue
                if e.code == "MIGRATE_FORWARD_FAILED":
                    # the write APPLIED on the source but its dual-write
                    # forward didn't land (usually the snapshot-install
                    # window of a live migration): re-drive under the
                    # SAME rid — the source answers the replay from its
                    # dedup cache / idempotent apply and forwards again;
                    # the target's seq gate keeps it exactly-once
                    return self._redrive(
                        client, method, req, rid, e.details.get("src_seq"),
                        keys=keys,
                    )
                raise
        if last is None:  # pragma: no cover — every continue sets last
            last = protocol.BloomServiceError(
                "CLUSTERDOWN", f"no route to slot {slot} after "
                f"{MAX_REDIRECTS} attempts"
            )
        raise last

    def _redrive(
        self,
        client: BloomClient,
        method: str,
        req: dict,
        rid: str,
        src_seq=None,
        *,
        keys=None,
    ) -> dict:
        # the rid comes from the enclosing _keyed call, NOT from
        # client.last_rid — a concurrent call on the same shard client
        # would clobber that between the failure and the re-drive.
        # src_seq (the applied record's source-log seq, from the
        # failure's details) rides along so a post-finalize MOVED
        # follow-up is still judged by the new owner's import gate — a
        # record the migrated snapshot already contains must dup out,
        # not apply twice.
        last: Exception = protocol.BloomServiceError(
            "MIGRATE_FORWARD_FAILED", "re-drive never attempted"
        )
        w0, t0 = time.time(), time.perf_counter()
        # same deterministic decision the original hop made for this
        # rid; the re-drive bypasses _rpc (it must not re-mint a rid),
        # so it carries the forced trace field itself — a re-driven
        # write must stay capturable exactly in the migration windows
        # this path exists for — and records its own hop span, follow-
        # up hop included
        traced = client.trace_sample > 0 and trace_mod.hit(
            rid, client.trace_sample
        )
        hop = trace_mod.new_span_id() if traced else None
        extra: dict = {"rid": rid}
        if traced:
            extra["trace"] = {"forced": True, "span": hop}
        # ONE hop span covers the whole re-drive window, recorded in
        # the finally so a FAILED re-drive (the case a post-mortem
        # needs most) still shows up — _rpc's finally discipline
        hop_attrs = {"method": method, "addr": client.address,
                     "kind": "redrive", "code": "FAILED"}
        try:
            for i in range(30):
                time.sleep(min(1.0, 0.05 * (i + 1)))
                try:
                    resp = client._call_once(
                        method, self._hop_req(client, req, keys, extra)
                    )
                    hop_attrs["code"] = "OK"
                    return resp
                except protocol.BloomServiceError as e:
                    last = e
                    hop_attrs["code"] = e.code
                    if e.code == "MIGRATE_FORWARD_FAILED":
                        if e.details.get("src_seq") is not None:
                            src_seq = e.details["src_seq"]
                        continue  # install in flight — keep re-driving
                    if e.code in ("MOVED", "ASK"):
                        # the handoff finalized mid-re-drive: land the
                        # SAME rid + src_seq on the new owner (its
                        # gate/dedup absorbs a record that already made
                        # it across)
                        target = self._client_for(e.details["addr"])
                        follow = self._hop_req(
                            target, req, keys, {**extra, "asking": True}
                        )
                        if src_seq is not None:
                            follow["src_seq"] = int(src_seq)
                        resp = target._call_once(method, follow)
                        hop_attrs.update(
                            addr=target.address, kind="redrive-follow",
                            code="OK",
                        )
                        return resp
                    raise
                except grpc.RpcError as e:
                    last = e
                    hop_attrs["code"] = "UNAVAILABLE"
                    continue
            raise last
        finally:
            if traced:
                trace_mod.record_span(
                    "client.hop", rid=rid, span=hop, start=w0,
                    duration_s=time.perf_counter() - t0, attrs=hop_attrs,
                )

    # -- keyed operations (the BloomClient surface, routed) -------------------

    @staticmethod
    def _durability(req: dict, min_replicas, timeout_ms) -> dict:
        if min_replicas is not None:
            req["min_replicas"] = int(min_replicas)
        if timeout_ms is not None:
            req["min_replicas_timeout_ms"] = int(timeout_ms)
        return req

    def create_filter(
        self,
        name: str,
        *,
        capacity: Optional[int] = None,
        error_rate: Optional[float] = None,
        config: Optional[dict] = None,
        exist_ok: bool = False,
        restore: bool = True,
        **options,
    ) -> dict:
        req: dict = {"name": name, "exist_ok": exist_ok, "restore": restore}
        if config is not None:
            req["config"] = config
        else:
            req["capacity"] = capacity
            req["error_rate"] = error_rate
            req["options"] = options
        return self._keyed("CreateFilter", req)

    def drop_filter(self, name: str, *, final_checkpoint: bool = True) -> dict:
        return self._keyed(
            "DropFilter", {"name": name, "final_checkpoint": final_checkpoint}
        )

    def insert_batch(
        self,
        name: str,
        keys,
        *,
        return_presence: bool = False,
        min_replicas: Optional[int] = None,
        min_replicas_timeout_ms: Optional[int] = None,
    ):
        req = self._durability(
            {"name": name}, min_replicas, min_replicas_timeout_ms
        )
        if not return_presence:
            return self._keyed("InsertBatch", req, keys=keys)["n"]
        req["return_presence"] = True
        resp = self._keyed("InsertBatch", req, keys=keys)
        if resp.get("migrate_dup") and "presence" not in resp:
            # the write landed exactly once, but this hop was absorbed
            # by the new owner's import gate and the pre-batch presence
            # bits were computed on the migration source — surface the
            # distinction instead of a generic field-missing error
            raise protocol.BloomServiceError(
                "PRESENCE_UNAVAILABLE",
                f"insert on {name!r} applied exactly once across a slot "
                f"migration, but its pre-batch presence bits are not "
                f"reconstructable at the new owner — re-query if needed",
            )
        return BloomClient._unpack_bool(resp, "presence")

    def include_batch(self, name: str, keys):
        resp = self._keyed("QueryBatch", {"name": name}, keys=keys)
        return BloomClient._unpack_bool(resp, "hits")

    def delete_batch(
        self,
        name: str,
        keys,
        *,
        min_replicas: Optional[int] = None,
        min_replicas_timeout_ms: Optional[int] = None,
    ) -> int:
        req = self._durability(
            {"name": name}, min_replicas, min_replicas_timeout_ms
        )
        return self._keyed("DeleteBatch", req, keys=keys)["n"]

    def insert(self, name: str, key) -> None:
        self.insert_batch(name, [key])

    def include(self, name: str, key) -> bool:
        return bool(self.include_batch(name, [key])[0])

    def clear(self, name: str, **durability) -> None:
        self._keyed(
            "Clear",
            self._durability(
                {"name": name},
                durability.get("min_replicas"),
                durability.get("min_replicas_timeout_ms"),
            ),
        )

    def stats(self, name: str) -> dict:
        return self._keyed("Stats", {"name": name})["stats"]

    def checkpoint(self, name: str, *, wait: bool = True) -> dict:
        return self._keyed("Checkpoint", {"name": name, "wait": wait})

    # -- cluster-wide views ---------------------------------------------------

    def list_filters(self) -> list:
        """Union of every shard's filter list."""
        out: set = set()
        for client in self._unique_shard_clients():
            out.update(client.list_filters())
        return sorted(out)

    def health(self) -> dict:
        """Per-shard Health, keyed by shard address."""
        return {
            c.address: c.health() for c in self._unique_shard_clients()
        }

    def cluster_slots(self) -> dict:
        """The adopted map (epoch + slot ranges), client-side view."""
        with self._lock:
            return {
                "epoch": self.epoch,
                "ranges": slots_mod.ranges_of(self._slot_owner),
            }

    def trace(
        self,
        rid: Optional[str] = None,
        *,
        name: Optional[str] = None,
        slot: Optional[int] = None,
    ) -> dict:
        """Cross-shard trace assembly: merge this process's
        own client spans with ``TraceGet`` answers from every shard
        (primaries AND their configured replicas), then follow the
        trace ids the returned spans introduce — a coalescer flush span
        links the rid but its children (kernel phases, barrier) and the
        replica applies of the merged record live under the FLUSH trace
        id, one fan-out round away. Returns ``{rid, spans, roots,
        components}`` — ``components`` from :func:`tpubloom_torch.obs.trace.
        assemble`; ONE component is the healthy single-call shape.

        pass ``name`` (the filter the call keyed)
        or ``slot`` directly and the fan-out narrows to the slot's
        owning shard — one ``TraceGet`` round trip instead of the full
        fleet, which is what a post-mortem script chasing thousands of
        rids needs. The hint degrades safely: an unmapped slot
        (CLUSTERDOWN) falls back to the full fan-out. Assembly passes
        ``rid`` through so a multi-hop MOVED/ASK/re-drive chain comes
        back as ONE tree under a synthetic ``client.call`` root (the
        synthetic span joins the returned ``spans``)."""
        rid = rid or self.last_rid
        if not rid:
            return {"rid": None, "spans": [], "roots": [], "components": []}
        if slot is None and name is not None:
            slot = slots_mod.key_slot(name)
        hinted: Optional[list] = None
        if slot is not None:
            try:
                hinted = [self._client_for(self._owner_addr(int(slot)))]
            except protocol.BloomServiceError:
                hinted = None  # no adopted map — full fan-out is the hint
        merged: dict = {
            (s.get("rid"), s.get("span")): s
            for s in trace_mod.get_trace(rid)
        }
        pending, done = {rid}, set()
        # bounded discovery: rid -> linked flush traces -> (nothing new)
        for _round in range(3):
            fresh = pending - done
            if not fresh:
                break
            for tid in sorted(fresh):
                done.add(tid)
                targets = (
                    hinted
                    if hinted is not None
                    else self._unique_shard_clients()
                )
                for client in targets:
                    for s in client.trace_get_fan(tid):
                        merged[(s.get("rid"), s.get("span"))] = s
                        if s.get("rid"):
                            pending.add(s["rid"])
                        for link in s.get("links") or ():
                            if link.get("rid"):
                                pending.add(link["rid"])
        spans = sorted(
            merged.values(), key=lambda s: (s.get("start") or 0.0)
        )
        tree = trace_mod.assemble(spans, rid=rid)
        if tree.get("synthetic"):
            spans = spans + [tree["synthetic"]]
        return {
            "rid": rid,
            "spans": spans,
            "roots": tree["roots"],
            "components": tree["components"],
        }

    def _unique_shard_clients(self) -> list:
        """One client per distinct owner address in the adopted map
        (falling back to the configured shard clients when no map)."""
        with self._lock:
            addrs = sorted(set(self._slot_owner.values()))
        if not addrs:
            return list(self._shard_clients)
        return [self._client_for(a) for a in addrs]

    def close(self) -> None:
        for c in self._shard_clients:
            c.close()
        with self._lock:
            direct = list(self._direct.values())
            self._direct.clear()
        for c in direct:
            c.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
