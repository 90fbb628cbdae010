"""Kernel wrappers for the blocked filter's hot path, and the host-side
double buffer.

Mapping from the TPU kernels of ``tpubloom/ops/sweep.py``:

* K3, ``_fat_kernel`` / ``fat_sweep_insert`` (driven by
  ``apply_fat_updates``) -> :func:`blocked_insert`; its presence variant
  (``PRES``, test-and-insert) -> :func:`blocked_query` then
  :func:`blocked_insert` on the same stream (:func:`blocked_test_insert`).
* K5, ``_fat_query_kernel`` / ``fat_sweep_query`` (driven by
  ``apply_fat_query``) -> :func:`blocked_query`.
* K4, ``_fat_count_kernel`` / ``fat_sweep_counter`` (driven by
  ``apply_fat_counter_updates``), and K2, ``_count_kernel`` /
  ``sweep_counter_update`` (driven by ``apply_counter_updates``) ->
  :func:`blocked_counting_update`: the two kernels differ only in the
  view of the counters (fat or logical), which on the card are the same
  bytes.
* The blocked counting query, an XLA gather in ``tpubloom``
  (``ops/counting.py``), -> :func:`blocked_counting_query`.
* K1, ``_kernel`` / ``sweep_insert`` (driven by ``apply_blocked_updates``),
  which the TPU runs in the sharded filter array's per-device loop
  (``tpubloom/parallel/sharded.py``, beside K3 there) -> the routed
  insert, :func:`blocked_insert` with a ``route`` (the
  ``sharded_blocked_insert`` kernel). The routed query and the routed
  counting update and query (``sharded_blocked_query``,
  ``sharded_blocked_counting_update``, ``sharded_blocked_counting_query``)
  cover K5, K2, K4 and the gathers inside ``shard_map``.

Why the sweep algorithm is not carried over: the TPU sorts each batch by
block, streams the whole filter through VMEM partition by partition and
places updates with one-hot matmuls, because TPU HBM cannot do random
read-modify-writes at speed (see the top of ``tpubloom/ops/sweep.py``).
Hopper can: a key's block is one 64-byte row, read with vector loads or
updated with ``atomicOr``. So the kernels here hash each key in place
and touch only its row — no sort, no partition windows, and no overflow
fallback, because nothing has a window to overflow. The results are the
same bits: the same state after an insert, the same verdicts.

Each wrapper takes ``(state, keys, lengths, config)``: ``state`` the
filter's ``uint32`` storage (any shape holding ``n_blocks *
words_per_block`` words; the fat and logical views are the same memory),
``keys`` ``uint8[B, L]``, ``lengths`` ``int32[B]`` (negative = padding).
With ``route=``:class:`~tpubloom_torch.ops.hashing.ShardRoute` it runs
the routed kernel on one slot of a sharded filter: ``state`` then holds
that slot's ``shards_per_dev * n_blocks_per_shard * words_per_block``
words, and keys the slot does not own set nothing and answer False.
A tensor on the CPU goes to the plain version in
:mod:`tpubloom_torch.ops.blocked` (bit filter) or
:mod:`tpubloom_torch.ops.counting` (counting filter); a CUDA tensor goes
to the kernel, or the wrapper raises. It never falls back from one to the
other.

Every wrapper counts its kernel launches in :data:`LAUNCHES`, the routed
launches under their own names, so a run can show that its main path
went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from tpubloom_torch.ops import _build, blocked, counting

#: Kernel launches per wrapper since the last :func:`reset_launch_counts`
#: (CUDA launches only; the plain versions are not counted).
LAUNCHES: dict[str, int] = {
    "blocked_query": 0, "blocked_insert": 0,
    "blocked_counting_update": 0, "blocked_counting_query": 0,
    "sharded_blocked_query": 0, "sharded_blocked_insert": 0,
    "sharded_blocked_counting_update": 0, "sharded_blocked_counting_query": 0,
}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_ROUTE = [_I64, _I64, _I64]  # n_shards, shard_lo, shards_per_dev
_SIGNATURES = {
    "tpb_blocked_query": (
        [_P, _P, _P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
         ctypes.c_int, ctypes.c_int, ctypes.c_uint32, ctypes.c_int, _P],
        ctypes.c_int,
    ),
    "tpb_blocked_insert": (
        [_P, _P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
         ctypes.c_int, ctypes.c_int, ctypes.c_uint32, ctypes.c_int, _P],
        ctypes.c_int,
    ),
    "tpb_sharded_blocked_query": (
        [_P, _P, _P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
         ctypes.c_int, ctypes.c_int, ctypes.c_uint32, ctypes.c_int, *_ROUTE, _P],
        ctypes.c_int,
    ),
    "tpb_sharded_blocked_insert": (
        [_P, _P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
         ctypes.c_int, ctypes.c_int, ctypes.c_uint32, ctypes.c_int, *_ROUTE, _P],
        ctypes.c_int,
    ),
}
_COUNTING_SIGNATURES = {
    "tpb_blocked_counting_update": (
        [_P, _P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
         ctypes.c_int, ctypes.c_int, ctypes.c_uint32, ctypes.c_int,
         ctypes.c_int, _P],
        ctypes.c_int,
    ),
    "tpb_blocked_counting_query": (
        [_P, _P, _P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
         ctypes.c_int, ctypes.c_int, ctypes.c_uint32, ctypes.c_int, _P],
        ctypes.c_int,
    ),
    "tpb_sharded_blocked_counting_update": (
        [_P, _P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
         ctypes.c_int, ctypes.c_int, ctypes.c_uint32, ctypes.c_int,
         ctypes.c_int, *_ROUTE, _P],
        ctypes.c_int,
    ),
    "tpb_sharded_blocked_counting_query": (
        [_P, _P, _P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
         ctypes.c_int, ctypes.c_int, ctypes.c_uint32, ctypes.c_int, *_ROUTE, _P],
        ctypes.c_int,
    ),
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def _library() -> ctypes.CDLL:
    return _build.load_library("blocked_bloom", _SIGNATURES)


def _counting_library() -> ctypes.CDLL:
    return _build.load_library("blocked_counting", _COUNTING_SIGNATURES)


def _check(state, keys, lengths, config, route=None, *, counters: bool = False) -> None:
    if bool(config.counting) != counters:
        raise ValueError(
            f"{'counting' if config.counting else 'bit'}-filter config given "
            f"to a {'counting' if counters else 'bit'}-filter kernel"
        )
    if keys.device != state.device or lengths.device != state.device:
        raise ValueError(
            f"state, keys and lengths must share a device "
            f"({state.device}, {keys.device}, {lengths.device})"
        )
    if state.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {state.device}")
    if state.dtype != torch.uint32:
        raise TypeError(f"state must be uint32, got {state.dtype}")
    if route is None:
        rows = config.n_blocks
    else:
        if route.n_shards != config.shards or not (
            0 <= route.shard_lo and route.shards_per_dev > 0
            and route.shard_lo + route.shards_per_dev <= config.shards
        ):
            raise ValueError(f"{route} does not fit a config of {config.shards} shards")
        rows = route.shards_per_dev * config.n_blocks_per_shard
    if state.numel() != rows * config.words_per_block:
        raise ValueError(
            f"state holds {state.numel()} words, the "
            f"{'config' if route is None else 'slot'} needs {rows * config.words_per_block}"
        )
    if keys.dtype != torch.uint8 or keys.dim() != 2 or keys.shape[1] % 4:
        raise ValueError(f"keys must be uint8[B, L], L % 4 == 0; got {keys.dtype}{tuple(keys.shape)}")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (keys.shape[0],):
        raise ValueError(f"lengths must be int32[{keys.shape[0]}], got {lengths.dtype}{tuple(lengths.shape)}")
    if state.device.type == "cuda":
        if not (state.is_contiguous() and keys.is_contiguous() and lengths.is_contiguous()):
            raise ValueError("the CUDA kernels take contiguous tensors")
        if state.data_ptr() % 16 or keys.data_ptr() % 4:
            raise ValueError("state must be 16-byte and keys 4-byte aligned")


def _spec_args(config, route=None):
    """(n_blocks, in-block position domain, k, seed, chunk): the domain is
    ``block_bits`` bits, or ``counters_per_block`` counters; a routed
    kernel hashes with one shard's block count."""
    domain = config.counters_per_block if config.counting else config.block_bits
    return (
        config.n_blocks if route is None else config.n_blocks_per_shard,
        domain, config.k, config.seed,
        1 if config.block_hash == "chunk" else 0,
    )


def _entry(lib: ctypes.CDLL, name: str, route):
    """``(C function, its routing arguments, launch counter)`` of kernel
    ``name``, or of its routed variant ``sharded_<name>`` with a route."""
    if route is None:
        return getattr(lib, f"tpb_{name}"), (), name
    return (getattr(lib, f"tpb_sharded_{name}"),
            (route.n_shards, route.shard_lo, route.shards_per_dev), f"sharded_{name}")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def blocked_query(state, keys, lengths, config, *, route=None) -> torch.Tensor:
    """Membership of each key: ``bool[B]``, False where ``lengths < 0``
    (and, with a ``route``, where the slot does not own the key).
    ``state`` is only read."""
    _check(state, keys, lengths, config, route)
    if state.device.type == "cpu":
        return blocked.blocked_query_plain(state, keys, lengths, config, route)
    B, L = keys.shape
    out = torch.empty((B,), dtype=torch.uint8, device=state.device)
    if B:
        fn, routing, name = _entry(_library(), "blocked_query", route)
        with torch.cuda.device(state.device):
            stream = torch.cuda.current_stream(state.device).cuda_stream
            err = fn(
                state.data_ptr(), keys.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), B, L, *_spec_args(config, route), *routing, stream,
            )
        _raise_on(err, name)
        LAUNCHES[name] += 1
    return out.view(torch.bool)


def blocked_insert(state, keys, lengths, config, *, route=None) -> None:
    """Set every valid key's k bits in ``state``, in place (with a
    ``route``, every key the slot owns)."""
    _check(state, keys, lengths, config, route)
    if state.device.type == "cpu":
        blocked.blocked_insert_plain(state, keys, lengths, config, route)
        return
    B, L = keys.shape
    if not B:
        return
    fn, routing, name = _entry(_library(), "blocked_insert", route)
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        err = fn(
            state.data_ptr(), keys.data_ptr(), lengths.data_ptr(),
            B, L, *_spec_args(config, route), *routing, stream,
        )
    _raise_on(err, name)
    LAUNCHES[name] += 1


def blocked_test_insert(state, keys, lengths, config) -> torch.Tensor:
    """Test-and-insert: each key's membership BEFORE the batch
    (within-batch duplicates all report the pre-batch state; padding
    reports False), then the insert. Two launches in stream order: the
    query finishes reading before the insert writes."""
    present = blocked_query(state, keys, lengths, config)
    blocked_insert(state, keys, lengths, config)
    return present


def blocked_counting_update(
    state, keys, lengths, config, *, increment: bool, route=None
) -> None:
    """Add (``increment``) or subtract each valid key's counter
    multiplicities at its k nibbles in ``state``, in place; nibbles
    saturate at 15 and floor at 0. ``state`` is the counting filter's
    storage, fat or logical ``[NB, W]`` view alike (with a ``route``, one
    slot's shards, and only the keys it owns count)."""
    _check(state, keys, lengths, config, route, counters=True)
    if state.device.type == "cpu":
        counting.blocked_counting_update_plain(
            state, keys, lengths, config, increment=increment, route=route
        )
        return
    B, L = keys.shape
    if not B:
        return
    fn, routing, name = _entry(_counting_library(), "blocked_counting_update", route)
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        err = fn(
            state.data_ptr(), keys.data_ptr(), lengths.data_ptr(),
            B, L, *_spec_args(config, route), 1 if increment else 0, *routing, stream,
        )
    _raise_on(err, name)
    LAUNCHES[name] += 1


def blocked_counting_query(state, keys, lengths, config, *, route=None) -> torch.Tensor:
    """Counting membership of each key: ``bool[B]``, True where all k of
    its counters are non-zero, False where ``lengths < 0`` (and, with a
    ``route``, where the slot does not own the key). ``state`` is only
    read."""
    _check(state, keys, lengths, config, route, counters=True)
    if state.device.type == "cpu":
        return counting.blocked_counting_query_plain(state, keys, lengths, config, route)
    B, L = keys.shape
    out = torch.empty((B,), dtype=torch.uint8, device=state.device)
    if B:
        fn, routing, name = _entry(_counting_library(), "blocked_counting_query", route)
        with torch.cuda.device(state.device):
            stream = torch.cuda.current_stream(state.device).cuda_stream
            err = fn(
                state.data_ptr(), keys.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), B, L, *_spec_args(config, route), *routing, stream,
            )
        _raise_on(err, name)
        LAUNCHES[name] += 1
    return out.view(torch.bool)


def record_fence(device: torch.device):
    """A completion handle for the work queued so far on ``device``'s
    current stream: a recorded CUDA event, or None on the CPU (whose
    work is done when the call returns)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


class InFlight:
    """Depth-1 host-side double buffer.

    A batching driver (a server's ingest coalescer, a bench loop) launches
    batch N without waiting, parks ``(handle, payload)`` here, stages
    batch N+1's host prep and H2D while N's kernel runs, and only then
    calls :meth:`take`, which waits for N and hands back its payload. The
    handle is a CUDA event from :func:`record_fence` (or None on the CPU);
    PyTorch's asynchronous launches do the overlap, this class keeps the
    bookkeeping and the fence in one place.
    """

    def __init__(self):
        self._handle = None
        self._payload = None

    @property
    def pending(self) -> bool:
        return self._payload is not None

    def put(self, handle, payload):
        """Park one launched batch; returns the PREVIOUS batch's
        ``(payload, fence_error)`` pair fenced (``(None, None)`` when
        nothing was in flight) — see :meth:`take`."""
        prev = self.take()
        self._handle, self._payload = handle, payload
        return prev

    def take(self):
        """Fence and return ``(payload, fence_error)`` — both None when
        idle. A fence error (a kernel fault surfacing at the
        synchronise) is RETURNED, not raised or swallowed: the caller must
        fail the batch's waiters rather than ack work that never
        happened."""
        if self._payload is None:
            return None, None
        handle, payload = self._handle, self._payload
        self._handle = self._payload = None
        err = None
        if handle is not None:
            try:
                handle.synchronize()
            except RuntimeError as e:  # CUDA faults surface as RuntimeError
                err = e
        return payload, err
