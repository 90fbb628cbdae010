"""Wire protocol for the tpubloom gRPC service.

Parity: this is the L4 transport of the layer map — the reference's
redis-rb/RESP hop becomes a gRPC channel from the (Ruby or Python) client
to the colocated JAX process (SURVEY.md §1; BASELINE: "#insert_batch /
#include_batch? ... ship key batches over a thin gRPC shim").

Implementation note: the environment has the ``grpc`` runtime but not
``grpc_tools`` (no protoc codegen for Python), so the service uses gRPC's
generic method handlers with **msgpack-encoded request/response maps**
instead of compiled protobufs. msgpack handles raw-byte keys natively, has
first-class Ruby support (the reference's ecosystem), and keeps the wire
format hand-decodable. Every message is a msgpack map; bulk key payloads
are msgpack ``bin`` arrays.

Request correlation: any request map MAY carry a ``rid`` field (string
request id). The server folds it into profiler spans and slowlog entries;
the stock Python client stamps one on every call. Servers generate one
when absent, so old clients stay compatible.

Fixed-width key encoding: per-key msgpack ``bin`` framing is
the host-side decode hot spot once the device stops being the bottleneck
(the phase histograms put decode+host_prep ahead of the kernel on
the server path). A request MAY therefore replace its ``keys`` list with
``keys_fixed = {"data": <raw bytes>, "width": W, "n": N}`` — N keys of
exactly W bytes each, concatenated. The canonical use is u64 keys
(W=8, little-endian), which the server decodes **zero-copy** via
``np.frombuffer(data).reshape(n, width)`` straight into the shape the
hash kernels consume — no per-key Python loop at all. Capability
discovery: ``Health`` answers ``encodings: ["msgpack", "fixed"]``;
clients negotiate per-connection and keep the msgpack list path for
servers (or key sets) that can't. The two encodings are semantically
identical: a u64 shipped fixed hits the same filter positions as its
8-byte little-endian ``bin`` twin.

Service: ``/tpubloom.BloomService/<Method>`` for Method in METHODS.
"""

from __future__ import annotations

import msgpack

SERVICE = "tpubloom.BloomService"

#: gRPC message-size caps shared by every hop that may carry a filter
#: snapshot blob (client channels, node→node migration links, the
#: server itself) — ONE definition, or a future bump would miss a copy
#: and surface as RESOURCE_EXHAUSTED only on the stale path.
CHANNEL_OPTIONS = (
    ("grpc.max_receive_message_length", 256 * 1024 * 1024),
    ("grpc.max_send_message_length", 256 * 1024 * 1024),
)

METHODS = (
    "Health",
    "CreateFilter",
    "DropFilter",
    "ListFilters",
    "InsertBatch",
    "QueryBatch",
    "DeleteBatch",
    "Clear",
    "Stats",
    "Checkpoint",
    "SlowlogGet",
    "SlowlogReset",
    "TraceGet",
    "Promote",
    "ReplicaOf",
    "Wait",
    "ClusterSlots",
    "ClusterSetSlot",
    "MigrateSlot",
    "MigrateInstall",
    # sketch plane (RedisBloom CF.*/CMS.*/TOPK.* parity).
    # Reserve verbs are CreateFilter with a kind-specific geometry;
    # Add/Del/Exists ride the bloom data-plane machinery (coalescer,
    # dedup, quorum barriers, MOVED/ASK) via delegation in the service.
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
)

#: Server-streaming RPCs: each response frame is one msgpack
#: map. ``ReplStream`` is the primary→replica changefeed (PSYNC parity:
#: request ``{cursor?}``, frames ``full_sync_begin/snapshot/
#: full_sync_end/partial_sync/record/heartbeat``); ``Monitor`` is the
#: Redis-MONITOR-parity live op stream (request ``{name?}`` to filter by
#: filter name, frames ``hello/op/heartbeat``).
STREAM_METHODS = (
    "ReplStream",
    "Monitor",
)

#: Client-streaming RPCs: each REQUEST frame is one msgpack
#: map; the server answers one map when the stream ends. ``ReplAck`` is
#: the replica→primary acknowledgement channel of the synchronous-
#: replication path: frames ``{"sid": <session id from the sync frame>,
#: "seq": <newest op seq fully applied>}``, coalesced latest-wins and
#: re-sent periodically so a lost frame heals. The primary folds them
#: into per-replica acked cursors that the ``Wait`` RPC and the
#: ``min-replicas-to-write`` commit barrier block on.
CLIENT_STREAM_METHODS = (
    "ReplAck",
)

#: Bidirectional-streaming RPCs (the streaming ingest
#: plane): one persistent stream amortizes transport the way the
#: coalescer amortizes device launches. Every frame in BOTH directions
#: is one msgpack map.
#:
#: Client→server DATA frames (both methods)::
#:
#:     {"seq": <client frame seq, 1-based, monotone per stream>,
#:      "rid": <frame request id — retained across reconnect replays>,
#:      "name": <filter>,
#:      "keys_fixed": {"data", "width", "n"}   # or "keys": [b, ...]
#:      # InsertStream only, all optional:
#:      "return_presence": bool, "min_replicas": int,
#:      "min_replicas_timeout_ms": int, "epoch": int}
#:
#: Server→client ACK frames: the FIRST frame on every stream is
#: ``{"kind": "hello", "credit": <initial window>}``; afterwards one
#: ``{"kind": "ack", "seq": <echoed frame seq>, "credit": <fresh
#: window>, "resp": <the full unary-shaped response map>}`` per data
#: frame — NOT necessarily in frame order (split insert flushes,
#: multi-filter groups, and direct-path interleave reorder
#: completions); each ack echoes its frame's ``seq``, so match on
#: that. ``resp`` is EXACTLY what the unary
#: ``InsertBatch``/``QueryBatch`` would have answered (``ok/n``,
#: presence/hits bitmaps, ``repl_seq``, quorum verdicts from the
#: one-barrier-per-flush path, or an ``error`` map) — acks are
#: pipelined, so many frames ride one coalesced flush.
#:
#: Flow control: ``credit`` is the number of UNACKED data frames the
#: client may have in flight, derived from the coalescer's parked-key
#: budget (``ingest_parked_current`` vs ``max_parked_keys``). Grants
#: only ride ack frames and never drop below 1 — an over-budget server
#: PARKS the stream (acks slow down, the window shrinks toward 1)
#: instead of shedding.
#:
#: Exactly-once replay: a client whose stream died mid-flight
#: reconnects and re-sends ONLY its unacked frames under their ORIGINAL
#: rids; the server's rid→response dedup cache (rebuilt from
#: the op log's per-frame ``parts`` on restart) answers any frame whose
#: first flight already applied from cache — zero double-applies, even
#: for counting-filter inserts.
BIDI_STREAM_METHODS = (
    "InsertStream",
    "QueryStream",
)

#: Mutating RPCs: replicated through the op log, rejected with
#: ``READONLY`` on replicas (Redis ``replica-read-only`` parity). A
#: mutating request MAY carry the caller's cached topology ``epoch``
#: — a server whose epoch is newer answers ``STALE_EPOCH`` so
#: topology-aware clients refresh instead of writing under a stale view.
MUTATING_METHODS = frozenset(
    {
        "CreateFilter",
        "DropFilter",
        "InsertBatch",
        "DeleteBatch",
        "Clear",
        # sketch-plane writes; the read verbs
        # (CFExists/CMSQuery/TopKList) stay replica-servable
        "CFReserve",
        "CFAdd",
        "CFDel",
        "CMSInitByDim",
        "CMSIncrBy",
        "TopKReserve",
        "TopKAdd",
    }
)

#: Durability-gate RPC (Redis ``WAIT`` parity): ``Wait``
#: ``{numreplicas, timeout_ms, seq?}`` blocks until at least
#: ``numreplicas`` replicas have acknowledged every record up to ``seq``
#: (default: the server's current log head; clients send their last
#: write's ``repl_seq``) and answers ``{nreplicas}`` — the count
#: actually acked, even when below the target (Redis WAIT returns the
#: count, it does not error). Mutating requests MAY carry
#: ``min_replicas`` (+ ``min_replicas_timeout_ms``) to demand a
#: per-request commit barrier stronger than the server's
#: ``--min-replicas-to-write`` default; a barrier that times out answers
#: ``NOT_ENOUGH_REPLICAS`` (Redis ``NOREPLICAS`` parity) with
#: ``details={acked, needed, seq, applied: true}`` — the write DID apply
#: and IS logged locally, only the quorum ack is missing, so a retry
#: under the same rid re-waits on the same record instead of
#: re-applying.

#: Distributed tracing: ``TraceGet`` ``{trace_rid}`` answers
#: ``{rid, enabled, spans: [...]}`` — every span THIS node recorded for
#: that trace id (the client rid), plus any coalescer flush span that
#: LINKS it and that flush trace's children. The lookup key travels as
#: ``trace_rid`` because the bare ``rid`` field is the per-call
#: transport correlation id clients stamp on every request (raw callers
#: that stamp none may use ``rid``). Unsheddable control plane:
#: the trace of a slow request is most needed exactly when the node is
#: drowning. A request MAY carry ``trace = {"forced": true, "span":
#: <parent span id>}`` to force capture regardless of the server's
#: ``--trace-sample`` rate and to parent the server's root span under
#: the client's hop span; with tracing off servers ignore the field and
#: clients stamp none (with tracing off the wire is as if it did not exist).

#: HA control-plane RPCs: ``Promote`` (replica→primary,
#: ``REPLICAOF NO ONE`` parity) and ``ReplicaOf`` (re-point/demote,
#: ``REPLICAOF host port`` parity). Epoch-stamped; stale epochs are
#: rejected with ``STALE_EPOCH``. Deliberately NOT in MUTATING_METHODS
#: (they must run on replicas) and never shed (a failover must land on
#: an overloaded cluster).
HA_METHODS = frozenset({"Promote", "ReplicaOf"})

#: Cluster-mode RPCs (Redis Cluster parity). ``ClusterSlots``
#: answers the node's slot map (``{enabled, epoch, self, ranges:
#: [[start, end, addr], ...], migrating, importing}`` — CLUSTER SLOTS
#: parity; clients build their slot→shard cache from it).
#: ``ClusterSetSlot`` is the admin verb (CLUSTER SETSLOT parity, plus a
#: bulk ``assign`` form the rebalancer pushes whole maps with).
#: ``MigrateSlot`` ``{slot, target}`` drives a live slot migration from
#: the owning node; ``MigrateInstall`` is its node→node snapshot hop
#: (``{name, blob, src_seq}``; ``{name, probe: true}`` probes the
#: target's resume point). A keyed request for a slot this node does
#: not own answers ``MOVED`` (details ``{slot, addr}``); a migrating
#: slot's missing filter answers ``ASK`` (one-shot redirect, the
#: follow-up carries ``asking: true`` — ASKING parity); an unassigned
#: slot answers ``CLUSTERDOWN``. Migration forwards additionally stamp
#: ``src_seq`` (the record's source-log seq) for the target's
#: exactly-once import gate.
CLUSTER_METHODS = frozenset(
    {"ClusterSlots", "ClusterSetSlot", "MigrateSlot", "MigrateInstall"}
)

#: The sentinel coordinator's own little gRPC service:
#: ``Topology`` (client-facing: the current epoch/primary/replicas —
#: SENTINEL get-master-addr parity), ``VoteDown`` (epoch-stamped
#: SDOWN→ODOWN leader vote), ``AnnounceTopology`` (post-failover view
#: propagation), ``Ping`` (liveness).
SENTINEL_SERVICE = "tpubloom.Sentinel"
SENTINEL_METHODS = ("Ping", "Topology", "VoteDown", "AnnounceTopology")

#: Sentinel server-streaming RPCs: ``TopologyEvents``
#: pushes the cluster view to subscribed clients — one ``{kind:
#: "topology", epoch, primary, replicas}`` frame on subscribe and on
#: every change, ``{kind: "heartbeat", epoch}`` while idle — so
#: topology-aware clients re-point on failover without waiting for a
#: refresh-on-error round trip.
SENTINEL_STREAM_METHODS = ("TopologyEvents",)


#: Wire encodings this server generation understands for bulk key
#: payloads (advertised by ``Health`` for per-connection negotiation).
#: ``msgpack`` = the original per-key ``bin`` list; ``fixed`` = the
#: ``keys_fixed`` raw-buffer form above.
ENCODINGS = ("msgpack", "fixed")

#: Sanity bound on ``keys_fixed.width`` — wider "keys" are almost
#: certainly a corrupt length field, and width*n must not be trusted to
#: allocate unbounded memory shapes.
FIXED_WIDTH_MAX = 4096


def fixed_keys(req: dict):
    """Validate and unpack a request's ``keys_fixed`` payload; returns
    ``(data, width, n)`` or None when the request uses the msgpack
    ``keys`` list. Raises :class:`BloomServiceError`
    ``INVALID_ARGUMENT`` on a malformed frame (mismatched byte count,
    non-positive width) — decode errors must be structured, not
    a reshape traceback."""
    fx = req.get("keys_fixed")
    if fx is None:
        return None
    try:
        data, width, n = fx["data"], int(fx["width"]), int(fx["n"])
    except (TypeError, KeyError, ValueError):
        raise BloomServiceError(
            "INVALID_ARGUMENT",
            "keys_fixed must be {data: bytes, width: int, n: int}",
        )
    if not isinstance(data, (bytes, bytearray, memoryview)):
        raise BloomServiceError(
            "INVALID_ARGUMENT", "keys_fixed.data must be raw bytes"
        )
    if width <= 0 or width > FIXED_WIDTH_MAX or n < 0:
        raise BloomServiceError(
            "INVALID_ARGUMENT",
            f"keys_fixed width {width} / n {n} out of range "
            f"(0 < width <= {FIXED_WIDTH_MAX}, n >= 0)",
        )
    if len(data) != width * n:
        raise BloomServiceError(
            "INVALID_ARGUMENT",
            f"keys_fixed carries {len(data)} bytes, expected "
            f"width*n = {width * n}",
        )
    return bytes(data), width, n


#: Minimum batch size before an equal-width bytes LIST auto-upgrades to
#: the fixed encoding: tiny batches gain nothing from it, and the
#: upgrade changes the op-log record shape record consumers see — keep
#: scalar/small calls byte-identical to the classic path. Numpy arrays
#: always ship fixed (passing one IS the opt-in).
FIXED_LIST_MIN = 8


def pack_fixed_keys(keys) -> dict | None:
    """Client-side: the ``keys_fixed`` payload for a batch, or None when
    the batch is not fixed-width encodable. Accepts a numpy integer
    array (canonically u64 — shipped as little-endian bytes) or a
    list/tuple of at least :data:`FIXED_LIST_MIN` equal-length
    ``bytes``."""
    import numpy as np

    if isinstance(keys, np.ndarray) and keys.ndim == 1 and keys.size:
        if keys.dtype.kind not in ("u", "i"):
            return None
        arr = np.ascontiguousarray(keys, dtype="<u8")
        return {"data": arr.tobytes(), "width": 8, "n": int(arr.size)}
    if isinstance(keys, (list, tuple)) and len(keys) >= FIXED_LIST_MIN:
        first = keys[0]
        if not isinstance(first, (bytes, bytearray)):
            return None
        width = len(first)
        if width == 0 or width > FIXED_WIDTH_MAX:
            return None
        if any(
            not isinstance(k, (bytes, bytearray)) or len(k) != width
            for k in keys
        ):
            return None
        return {"data": b"".join(bytes(k) for k in keys),
                "width": width, "n": len(keys)}
    return None


def batch_size(req: dict) -> int:
    """Key count of a request under either encoding (0 when keyless)."""
    keys = req.get("keys")
    if isinstance(keys, list):
        return len(keys)
    fx = req.get("keys_fixed")
    if isinstance(fx, dict):
        try:
            return int(fx["n"])
        except (KeyError, TypeError, ValueError):
            return 0
    return 0


def sentinel_method_path(method: str) -> str:
    return f"/{SENTINEL_SERVICE}/{method}"


def encode(msg: dict) -> bytes:
    return msgpack.packb(msg, use_bin_type=True)


def decode(data: bytes) -> dict:
    return msgpack.unpackb(data, raw=False)


def method_path(method: str) -> str:
    return f"/{SERVICE}/{method}"


def error_response(code: str, message: str, details: dict | None = None) -> dict:
    """``details`` carries structured, machine-readable error context —
    e.g. overload sheds (``RESOURCE_EXHAUSTED``/``DRAINING``) include
    ``retry_after_ms`` so clients pace their retries instead of
    hammering."""
    err: dict = {"code": code, "message": message}
    if details:
        err["details"] = details
    return {"ok": False, "error": err}


def check(resp: dict) -> dict:
    """Client-side: raise on an error response, else return it."""
    if not resp.get("ok", False):
        err = resp.get("error", {})
        raise BloomServiceError(
            err.get("code", "UNKNOWN"),
            err.get("message", ""),
            err.get("details") or {},
        )
    return resp


class BloomServiceError(RuntimeError):
    def __init__(self, code: str, message: str, details: dict | None = None):
        super().__init__(f"{code}: {message}")
        self.code = code
        self.message = message
        self.details = details or {}
