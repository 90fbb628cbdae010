"""Kernel wrappers for the filters' hot paths, and the host-side double
buffer.

Mapping from the TPU kernels of ``tpubloom/ops/sweep.py``:

* K3, ``_fat_kernel`` / ``fat_sweep_insert`` (driven by
  ``apply_fat_updates``) -> :func:`blocked_insert`.
* The presence variant (``PRES``, test-and-insert) of K1 and K3, reached
  through ``make_sweep_insert_fn(with_presence=True)`` from
  ``make_blocked_test_insert_fn`` -> :func:`blocked_test_insert`: the
  batch partitioned by row tile and each tile tested and updated on chip
  (``csrc/blocked_test_insert.cu``), or below
  :data:`BLOCKED_TEST_INSERT_CROSSOVER` :func:`blocked_query` then
  :func:`blocked_insert` on the same stream.
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

The flat layout has no Pallas kernel in ``tpubloom``: its device ops are
XLA (a sort, a segmented scan, a scatter). Each has a CUDA kernel here
(``tpubloom_torch/csrc/flat_bloom.cu``), with a routed twin for the flat
sharded layouts:

* ``make_insert_fn`` + ``bitops.scatter_or`` (``tpubloom/filter.py``;
  sharded ``make_sharded_insert_fn``) -> :func:`flat_insert`;
* ``make_query_fn`` + ``bitops.query_membership`` (sharded
  ``make_sharded_query_fn``) -> :func:`flat_query`;
* ``make_counter_fn`` + ``counting.counter_update`` (sharded
  ``make_sharded_counter_fn``) -> :func:`flat_counting_update`;
* ``make_counting_query_fn`` + ``counting.counting_membership`` (sharded
  ``make_sharded_counting_query_fn``) -> :func:`flat_counting_query`.

The flat kernels give a key a thread; the bit query stops each key at its
first zero bit. The insert and the counting pair also have partitioned
kernels (``tpubloom_torch/csrc/flat_bits.cu``, ``flat_counting.cu``, on
the shared partition of ``flat_partition.cuh``) for a batch whose
positions cover much of the state: the batch's positions are placed by
shared-memory tile and each tile is swept on chip, where ``tpubloom``
sorts them; :func:`flat_takes_tiles` picks one of the two kernels from the
launch's shape.

Why the sweep algorithm is not carried over: the TPU sorts each batch by
block, streams the whole filter through VMEM partition by partition and
places updates with one-hot matmuls, because TPU HBM cannot do random
read-modify-writes at speed (see the top of ``tpubloom/ops/sweep.py``).
Hopper can: a key's block is one 64-byte row, read with vector loads or
updated with ``atomicOr``. So the blocked kernels hash each key in place
and touch only its row — no sort, no partition windows, and no overflow
fallback, because nothing has a window to overflow. The results are the
same bits: the same state after an insert, the same verdicts.

Each wrapper takes ``(state, keys, lengths, config)``: ``state`` the
filter's ``uint32`` storage (any shape holding ``n_blocks *
words_per_block`` words for a blocked layout, the fat and logical views
being the same memory; ``n_words`` or ``n_counter_words`` for a flat one),
``keys`` ``uint8[B, L]``, ``lengths`` ``int32[B]`` (negative = padding).
With ``route=``:class:`~tpubloom_torch.ops.hashing.ShardRoute` it runs
the routed kernel on one slot of a sharded filter: ``state`` then holds
that slot's ``shards_per_dev`` shards (``n_blocks_per_shard *
words_per_block``, ``n_words_per_shard`` or ``m_per_shard / 8`` words
each), and keys the slot does not own set nothing and answer False.
A tensor on the CPU goes to the plain version in
:mod:`tpubloom_torch.ops.blocked` (blocked bit filter),
:mod:`tpubloom_torch.ops.bitops` (flat bit filter) or
:mod:`tpubloom_torch.ops.counting` (counting filters); a CUDA tensor goes
to the kernel, or the wrapper raises. It never falls back from one to the
other.

The sketch kinds have no Pallas kernel in ``tpubloom`` either: their
device ops are XLA. Each has a CUDA kernel here, with its plain version in
:mod:`tpubloom_torch.ops.cuckoo` or :mod:`tpubloom_torch.ops.cms`:

* the cuckoo insert's and delete's ``lax.scan`` over the batch
  (``tpubloom/ops/cuckoo.py`` ``cuckoo_insert``, ``cuckoo_delete``) ->
  :func:`cuckoo_insert`, :func:`cuckoo_delete` (``csrc/cuckoo.cu``: a hash
  launch, then one CTA that walks a window of keys at once against the
  table, checks the walks in batch order and commits the valid prefix,
  round after round; bit-identical to the walk in order);
* the cuckoo query (``cuckoo_query``) -> :func:`cuckoo_query`;
* the count-min scatter-add and gather with row minimum
  (``tpubloom/ops/cms.py`` ``cms_update``, ``cms_estimate``) ->
  :func:`cms_update`, :func:`cms_estimate` (``csrc/cms.cu``, a thread a
  key; the update of a batch whose counters cover much of the grid
  partitioned by 64 KiB tile on ``flat_partition.cuh`` and added in shared
  memory, chosen by :func:`cms_takes_tiles`; the estimate of a large batch
  gathered row by row, while the L2 holds that row, by one resident
  launch, chosen by :func:`cms_takes_rows`).

Every wrapper counts its kernel launches in :data:`LAUNCHES`, the routed
launches under their own names, so a run can show that its main path
went through the kernels.

While ``torch.profiler`` records, each public wrapper's call is the
range ``tpubloom_torch.sweep.<wrapper>`` (:mod:`tpubloom_torch.obs.context`),
whose own time is :func:`_check`; on the card its children are
``sweep.plan`` (the kernel's choice, the scratch plan, the library
lookup), ``sweep.alloc`` (``torch.empty`` of the verdicts and scratch)
and ``sweep.enqueue`` (the call into the C entry, inside which every
device operation of the call is launched). A wrapper tests
:func:`~tpubloom_torch.obs.context.recording` once a call; without the
profiler it takes the path without ranges (its ``_span`` is None, and
the helpers' ``span`` too).
"""

from __future__ import annotations

import ctypes

import torch

from tpubloom_torch.obs import context as obs
from tpubloom_torch.ops import _build, bitops, blocked, cms, counting, cuckoo

#: Kernel launches per wrapper since the last :func:`reset_launch_counts`
#: (CUDA launches only; the plain versions are not counted). A flat insert
#: or counting call, and a count-min update, counts once under its name
#: whichever kernel it takes, and once more under ``<name>_tiled`` when it
#: takes the partitioned one; a count-min estimate once more under
#: ``cms_estimate_rows`` when it takes the row-phased kernel. It counts
#: calls into the C entries, not device operations (a fused call that
#: launches six kernels counts once): a test seam, which the tests and
#: chip_smoke.py read to show that a path went through the kernels. No
#: benchmark metric reads it; ``sweep.launches_per_batch`` counts the
#: profiler trace's device operations.
LAUNCHES: dict[str, int] = {
    "blocked_query": 0, "blocked_insert": 0, "blocked_test_insert": 0,
    "blocked_counting_update": 0, "blocked_counting_query": 0,
    "sharded_blocked_query": 0, "sharded_blocked_insert": 0,
    "sharded_blocked_counting_update": 0, "sharded_blocked_counting_query": 0,
    "flat_insert": 0, "flat_query": 0,
    "flat_counting_update": 0, "flat_counting_query": 0,
    "sharded_flat_insert": 0, "sharded_flat_query": 0,
    "sharded_flat_counting_update": 0, "sharded_flat_counting_query": 0,
    "flat_counting_update_tiled": 0, "flat_counting_query_tiled": 0,
    "sharded_flat_counting_update_tiled": 0, "sharded_flat_counting_query_tiled": 0,
    "flat_insert_tiled": 0, "sharded_flat_insert_tiled": 0,
    "cuckoo_insert": 0, "cuckoo_delete": 0, "cuckoo_query": 0,
    "cms_update": 0, "cms_estimate": 0, "cms_update_tiled": 0, "cms_estimate_rows": 0,
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
_TEST_INSERT_SIGNATURES = {
    "tpb_blocked_test_insert": (
        [_P, _P, _P, _P, _I64, ctypes.c_int, _I64, ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
         ctypes.c_int, _P, _I64, _P],
        ctypes.c_int,
    ),
    "tpb_blocked_test_insert_scratch_bytes": ([_I64, _I64, ctypes.c_int, ctypes.c_int, ctypes.c_int], _I64),
    "tpb_blocked_test_insert_tile_starts_at": ([_I64, _I64, ctypes.c_int, ctypes.c_int, ctypes.c_int], _I64),
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

_FLAT = [ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_uint32]  # B, L, m, k, seed
_FLAT_SIGNATURES = {
    "tpb_flat_insert": ([_P, _P, _P, *_FLAT, _P], ctypes.c_int),
    "tpb_flat_query": ([_P, _P, _P, _P, *_FLAT, _P], ctypes.c_int),
    "tpb_flat_query_group": ([_P, _P, _P, _P, *_FLAT, ctypes.c_int, _P], ctypes.c_int),
    "tpb_flat_counting_update": ([_P, _P, _P, *_FLAT, ctypes.c_int, _P], ctypes.c_int),
    "tpb_flat_counting_query": ([_P, _P, _P, _P, *_FLAT, _P], ctypes.c_int),
    "tpb_sharded_flat_insert": ([_P, _P, _P, *_FLAT, *_ROUTE, _P], ctypes.c_int),
    "tpb_sharded_flat_query": ([_P, _P, _P, _P, *_FLAT, *_ROUTE, _P], ctypes.c_int),
    "tpb_sharded_flat_counting_update": (
        [_P, _P, _P, *_FLAT, ctypes.c_int, *_ROUTE, _P], ctypes.c_int,
    ),
    "tpb_sharded_flat_counting_query": ([_P, _P, _P, _P, *_FLAT, *_ROUTE, _P], ctypes.c_int),
}
_FLAT_TILED_SIGNATURES = {
    "tpb_flat_counting_update_tiled": ([_P, _P, _P, *_FLAT, ctypes.c_int, _P, _I64, _P], ctypes.c_int),
    "tpb_flat_counting_query_tiled": ([_P, _P, _P, _P, *_FLAT, _P, _I64, _P], ctypes.c_int),
    "tpb_sharded_flat_counting_update_tiled": (
        [_P, _P, _P, *_FLAT, ctypes.c_int, *_ROUTE, _P, _I64, _P], ctypes.c_int,
    ),
    "tpb_sharded_flat_counting_query_tiled": (
        [_P, _P, _P, _P, *_FLAT, *_ROUTE, _P, _I64, _P], ctypes.c_int,
    ),
    "tpb_flat_counting_tiled_scratch_bytes": ([_I64, ctypes.c_int, _I64, ctypes.c_int], _I64),
    "tpb_flat_counting_tile_log2": ([], ctypes.c_int),
    "tpb_flat_counting_tile_piece": ([], _I64),
}
_FLAT_BITS_SIGNATURES = {
    "tpb_flat_insert_tiled": ([_P, _P, _P, *_FLAT, _P, _I64, _P], ctypes.c_int),
    "tpb_sharded_flat_insert_tiled": ([_P, _P, _P, *_FLAT, *_ROUTE, _P, _I64, _P], ctypes.c_int),
    "tpb_flat_bits_tiled_scratch_bytes": ([_I64, ctypes.c_int, _I64], _I64),
}

# B, L, n_buckets, seed (cuckoo); B, L, width, depth, seed (count-min)
_CUCKOO = [ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_uint32]
_CUCKOO_SIGNATURES = {
    "tpb_cuckoo_insert": ([_P, _P, _P, _P, _P, _P, _P, _P, *_CUCKOO, _P], ctypes.c_int),
    "tpb_cuckoo_delete": ([_P, _P, _P, _P, _P, _P, _P, *_CUCKOO, _P], ctypes.c_int),
    "tpb_cuckoo_query": ([_P, _P, _P, _P, *_CUCKOO, _P], ctypes.c_int),
    "tpb_cuckoo_walk_variant": (
        [_P, _P, _P, _P, _P, _P, _P, _P, *_CUCKOO, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P],
        ctypes.c_int,
    ),
    "tpb_cuckoo_chase": ([_P, ctypes.c_uint32, ctypes.c_int64, _P, _P], ctypes.c_int),
    "tpb_cuckoo_window": ([], ctypes.c_int),
}
_CMS = [ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_uint32]
_CMS_SIGNATURES = {
    "tpb_cms_update": ([_P, _P, _P, _P, *_CMS, _P], ctypes.c_int),
    "tpb_cms_estimate": ([_P, _P, _P, _P, *_CMS, _P], ctypes.c_int),
    "tpb_cms_estimate_rows": ([_P, _P, _P, _P, *_CMS, _P], ctypes.c_int),
    "tpb_cms_update_tiled": ([_P, _P, _P, _P, *_CMS, _P, _I64, _P], ctypes.c_int),
    "tpb_cms_tiled_scratch_bytes": ([_I64, _I64, ctypes.c_int, ctypes.c_int], _I64),
    "tpb_cms_tile_starts_at": ([_I64, _I64, ctypes.c_int, ctypes.c_int], _I64),
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def _library() -> ctypes.CDLL:
    return _build.load_library("blocked_bloom", _SIGNATURES)


def _test_insert_library() -> ctypes.CDLL:
    return _build.load_library("blocked_test_insert", _TEST_INSERT_SIGNATURES)


def _counting_library() -> ctypes.CDLL:
    return _build.load_library("blocked_counting", _COUNTING_SIGNATURES)


def _flat_library() -> ctypes.CDLL:
    return _build.load_library("flat_bloom", _FLAT_SIGNATURES)


def _flat_tiled_library() -> ctypes.CDLL:
    return _build.load_library("flat_counting", _FLAT_TILED_SIGNATURES)


def _flat_bits_library() -> ctypes.CDLL:
    return _build.load_library("flat_bits", _FLAT_BITS_SIGNATURES)


def _cuckoo_library() -> ctypes.CDLL:
    return _build.load_library("cuckoo", _CUCKOO_SIGNATURES)


def _cms_library() -> ctypes.CDLL:
    return _build.load_library("cms", _CMS_SIGNATURES)


def _state_words(config, route=None) -> int:
    """Words of the state a kernel takes: the whole filter, or with a
    ``route`` one slot's ``shards_per_dev`` shards."""
    if config.block_bits:
        rows = config.n_blocks if route is None else route.shards_per_dev * config.n_blocks_per_shard
        return rows * config.words_per_block
    per_word = 8 if config.counting else 32  # counters or bits a word
    if route is None:
        return config.n_counter_words if config.counting else config.n_words
    return route.shards_per_dev * config.m_per_shard // per_word


def _check(state, keys, lengths, config, route=None, *, counters: bool = False,
           flat: bool = False) -> None:
    if bool(config.counting) != counters:
        raise ValueError(
            f"{'counting' if config.counting else 'bit'}-filter config given "
            f"to a {'counting' if counters else 'bit'}-filter kernel"
        )
    if (not config.block_bits) != flat:
        raise ValueError(
            f"{'flat' if not config.block_bits else 'blocked'} config given to a "
            f"{'flat' if flat else 'blocked'}-layout kernel"
        )
    if route is not None and (route.n_shards != config.shards or not (
        0 <= route.shard_lo and route.shards_per_dev > 0
        and route.shard_lo + route.shards_per_dev <= config.shards
    )):
        raise ValueError(f"{route} does not fit a config of {config.shards} shards")
    _check_tensors(state, keys, lengths, _state_words(config, route),
                   "config" if route is None else "slot")


def _check_tensors(state, keys, lengths, need: int, whose: str) -> None:
    """What every wrapper checks of its tensors: one device (the CPU or a
    card), a ``uint32`` state of ``need`` words, ``uint8[B, L]`` keys and
    ``int32[B]`` lengths, and on the card contiguous, aligned tensors."""
    if keys.device != state.device or lengths.device != state.device:
        raise ValueError(
            f"state, keys and lengths must share a device "
            f"({state.device}, {keys.device}, {lengths.device})"
        )
    if state.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {state.device}")
    if state.dtype != torch.uint32:
        raise TypeError(f"state must be uint32, got {state.dtype}")
    if state.numel() != need:
        raise ValueError(f"state holds {state.numel()} words, the {whose} needs {need}")
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


def _launch_update(lib, name, state, keys, lengths, spec, route, span=None) -> None:
    """One launch of the in-place kernel ``name`` (or its routed twin):
    ``fn(state, keys, lengths, B, L, *spec, *routing, stream)``. ``span``:
    the wrapper's range, whose ``sweep.enqueue`` child holds the launch."""
    B, L = keys.shape
    if not B:
        return
    fn, routing, counter = _entry(lib, name, route)
    if span is not None:
        span.child("tpubloom_torch.sweep.enqueue")
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        err = fn(state.data_ptr(), keys.data_ptr(), lengths.data_ptr(),
                 B, L, *spec, *routing, stream)
    if span is not None:
        span.child(None)
    _raise_on(err, counter)
    LAUNCHES[counter] += 1


def _launch_query(lib, name, state, keys, lengths, spec, route, span=None) -> torch.Tensor:
    """One launch of the query kernel ``name`` (or its routed twin) into a
    fresh verdict tensor: ``fn(state, keys, lengths, out, B, L, *spec,
    *routing, stream)``; ``span`` as for :func:`_launch_update`."""
    B, L = keys.shape
    fn, routing, counter = _entry(lib, name, route)
    if span is not None:
        span.child("tpubloom_torch.sweep.alloc")
    out = torch.empty((B,), dtype=torch.uint8, device=state.device)
    if B:
        if span is not None:
            span.child("tpubloom_torch.sweep.enqueue")
        with torch.cuda.device(state.device):
            stream = torch.cuda.current_stream(state.device).cuda_stream
            err = fn(state.data_ptr(), keys.data_ptr(), lengths.data_ptr(),
                     out.data_ptr(), B, L, *spec, *routing, stream)
        if span is not None:
            span.child(None)
        _raise_on(err, counter)
        LAUNCHES[counter] += 1
    return out.view(torch.bool)


def blocked_query(state, keys, lengths, config, *, route=None, _span=None) -> torch.Tensor:
    """Membership of each key: ``bool[B]``, False where ``lengths < 0``
    (and, with a ``route``, where the slot does not own the key).
    ``state`` is only read."""
    if _span is None and obs.recording():
        with obs.Range("tpubloom_torch.sweep.blocked_query") as span:
            return blocked_query(state, keys, lengths, config, route=route, _span=span)
    _check(state, keys, lengths, config, route)
    if state.device.type == "cpu":
        return blocked.blocked_query_plain(state, keys, lengths, config, route)
    if _span is not None:
        _span.child("tpubloom_torch.sweep.plan")
    return _launch_query(_library(), "blocked_query", state, keys, lengths,
                         _spec_args(config, route), route, _span)


def blocked_insert(state, keys, lengths, config, *, route=None, _span=None) -> None:
    """Set every valid key's k bits in ``state``, in place (with a
    ``route``, every key the slot owns)."""
    if _span is None and obs.recording():
        with obs.Range("tpubloom_torch.sweep.blocked_insert") as span:
            return blocked_insert(state, keys, lengths, config, route=route, _span=span)
    _check(state, keys, lengths, config, route)
    if state.device.type == "cpu":
        blocked.blocked_insert_plain(state, keys, lengths, config, route)
        return
    if _span is not None:
        _span.child("tpubloom_torch.sweep.plan")
    _launch_update(_library(), "blocked_insert", state, keys, lengths,
                   _spec_args(config, route), route, _span)


#: A test-and-insert on the card takes the fused kernel
#: (``csrc/blocked_test_insert.cu``: the batch partitioned by row tile, each
#: tile tested and updated on chip) from this many keys a row of the
#: filter, where its plan holds the shape, and blocked_query then
#: blocked_insert below it: the partition's six launches and a CTA a tile
#: cost ~0.12 ms at any batch. From chip_smoke.py's test_insert_crossover
#: phase (fresh launches on the main path's m=2^32 state, B = 2^14 .. 2^23,
#: in turns; NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6): the fused
#: kernel is the faster from 2^22 keys (0.5 a row: 0.477 against 0.544 ms;
#: 2^23: 0.821 against 1.084) and the slower at 2^21 (0.302 against 0.274)
#: and below, so the server's flushes of 2^16 - 2^19 keys keep the two.
BLOCKED_TEST_INSERT_CROSSOVER = 1 / 2


def blocked_test_insert_fused(config, batch: int) -> bool:
    """Whether a test-and-insert of ``batch`` keys on ``config``'s
    unrouted state reaches :data:`BLOCKED_TEST_INSERT_CROSSOVER` keys a
    row. Pure Python and cheap: small batches ask it on every call."""
    return batch > 0 and batch >= BLOCKED_TEST_INSERT_CROSSOVER * config.n_blocks


def _test_insert_shape(config) -> tuple:
    """(n_blocks, block_bits, k, chunk): what the fused kernel's plan reads."""
    return (config.n_blocks, config.block_bits, config.k, 1 if config.block_hash == "chunk" else 0)


def blocked_test_insert_scratch_bytes(config, batch: int) -> int:
    """The fused launch's scratch as ``csrc/blocked_test_insert.cu`` plans
    it, or -1 where its partition cannot hold the shape (2^32 rows or
    more, more than 2^14 tiles of 64 KiB, B >= 2^31, or a chunk hash
    whose k positions need more than 64 bits of its pool). Builds the
    kernel."""
    return _test_insert_library().tpb_blocked_test_insert_scratch_bytes(
        batch, *_test_insert_shape(config))


def blocked_test_insert_tile_counts(scratch: torch.Tensor, config, batch: int) -> torch.Tensor:
    """The keys each row tile took in the last fused launch of ``batch``
    keys that ran in ``scratch`` (int64 ``[n_tiles]``, from the plan's tile
    starts; on the card), to hold the kernel's partition against
    :func:`tpubloom_torch.ops.blocked.test_insert_tile_counts_plain`."""
    at = _test_insert_library().tpb_blocked_test_insert_tile_starts_at(
        batch, *_test_insert_shape(config))
    n_tiles = _ceil_div(config.n_blocks * config.words_per_block, 1 << flat_tile_geometry()[0])
    return scratch[at : at + 4 * (n_tiles + 1)].view(torch.int32).to(torch.int64).diff()


def _takes_fused(config, batch: int) -> bool:
    """The wrapper's choice on the card: the crossover, then whether the
    fused kernel's plan holds the shape."""
    return (blocked_test_insert_fused(config, batch)
            and blocked_test_insert_scratch_bytes(config, batch) >= 0)


def _blocked_test_insert_on(fused: bool, state, keys, lengths, config, *,
                            scratch: torch.Tensor | None = None, span=None) -> torch.Tensor:
    """The test-and-insert of a checked CUDA state on the kernels named:
    the fused one (``fused``, in ``scratch``, allocated when None; counted
    under ``blocked_test_insert``) or blocked_query then blocked_insert.
    :func:`blocked_test_insert` picks by shape; chip_smoke.py and the card
    tests hold each through here. ``span``: the wrapper's range."""
    if not fused:
        present = _launch_query(_library(), "blocked_query", state, keys, lengths,
                                _spec_args(config), None, span)
        _launch_update(_library(), "blocked_insert", state, keys, lengths, _spec_args(config), None,
                       span)
        return present
    B, L = keys.shape
    if B and scratch is None:
        nbytes = blocked_test_insert_scratch_bytes(config, B)
        if nbytes < 0:
            raise ValueError(f"blocked_test_insert: the partition cannot hold {B} keys "
                             f"on {config.n_blocks} rows")
    lib = _test_insert_library()
    if span is not None:
        span.child("tpubloom_torch.sweep.alloc")
    out = torch.empty((B,), dtype=torch.uint8, device=state.device)
    if B:
        if scratch is None:
            scratch = torch.empty(nbytes, dtype=torch.uint8, device=state.device)
        _launch(lib, "blocked_test_insert", state, state.data_ptr(),
                keys.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, L, *_spec_args(config),
                scratch.data_ptr(), scratch.numel(), span=span)
    return out.view(torch.bool)


def blocked_test_insert(state, keys, lengths, config, *, _span=None) -> torch.Tensor:
    """Test-and-insert: each key's membership BEFORE the batch
    (within-batch duplicates all report the pre-batch state; padding
    reports False), and the insert. On the card a batch of
    :data:`BLOCKED_TEST_INSERT_CROSSOVER` keys a row or more takes the
    fused kernel, a smaller one blocked_query then blocked_insert in
    stream order (the query finishes reading before the insert writes);
    both give the same state and verdicts."""
    if _span is None and obs.recording():
        with obs.Range("tpubloom_torch.sweep.blocked_test_insert") as span:
            return blocked_test_insert(state, keys, lengths, config, _span=span)
    _check(state, keys, lengths, config)
    if state.device.type == "cpu":
        return blocked.blocked_test_insert_plain(state, keys, lengths, config)
    if _span is not None:
        _span.child("tpubloom_torch.sweep.plan")
    return _blocked_test_insert_on(_takes_fused(config, keys.shape[0]), state, keys, lengths,
                                   config, span=_span)


def blocked_counting_update(
    state, keys, lengths, config, *, increment: bool, route=None, _span=None
) -> None:
    """Add (``increment``) or subtract each valid key's counter
    multiplicities at its k nibbles in ``state``, in place; nibbles
    saturate at 15 and floor at 0. ``state`` is the counting filter's
    storage, fat or logical ``[NB, W]`` view alike (with a ``route``, one
    slot's shards, and only the keys it owns count)."""
    if _span is None and obs.recording():
        with obs.Range("tpubloom_torch.sweep.blocked_counting_update") as span:
            return blocked_counting_update(state, keys, lengths, config, increment=increment,
                                           route=route, _span=span)
    _check(state, keys, lengths, config, route, counters=True)
    if state.device.type == "cpu":
        counting.blocked_counting_update_plain(
            state, keys, lengths, config, increment=increment, route=route
        )
        return
    if _span is not None:
        _span.child("tpubloom_torch.sweep.plan")
    _launch_update(_counting_library(), "blocked_counting_update", state, keys, lengths,
                   (*_spec_args(config, route), 1 if increment else 0), route, _span)


def blocked_counting_query(state, keys, lengths, config, *, route=None,
                           _span=None) -> torch.Tensor:
    """Counting membership of each key: ``bool[B]``, True where all k of
    its counters are non-zero, False where ``lengths < 0`` (and, with a
    ``route``, where the slot does not own the key). ``state`` is only
    read."""
    if _span is None and obs.recording():
        with obs.Range("tpubloom_torch.sweep.blocked_counting_query") as span:
            return blocked_counting_query(state, keys, lengths, config, route=route, _span=span)
    _check(state, keys, lengths, config, route, counters=True)
    if state.device.type == "cpu":
        return counting.blocked_counting_query_plain(state, keys, lengths, config, route)
    if _span is not None:
        _span.child("tpubloom_torch.sweep.plan")
    return _launch_query(_counting_library(), "blocked_counting_query", state, keys, lengths,
                         _spec_args(config, route), route, _span)


def _flat_args(config, route):
    """(m, k, seed): a routed kernel walks one shard's positions."""
    return (config.m if route is None else config.m_per_shard), config.k, config.seed


def flat_insert(state, keys, lengths, config, *, route=None, _span=None) -> None:
    """Set every valid key's k flat bits in ``state`` (``uint32[n_words]``),
    in place (with a ``route``, every key the slot owns). On the card a
    batch whose positions cover enough of the state
    (:func:`flat_takes_tiles`) takes the partitioned kernel, a smaller one
    the thread-a-key kernel; both give the same words."""
    if _span is None and obs.recording():
        with obs.Range("tpubloom_torch.sweep.flat_insert") as span:
            return flat_insert(state, keys, lengths, config, route=route, _span=span)
    _check(state, keys, lengths, config, route, flat=True)
    if state.device.type == "cpu":
        bitops.flat_insert_plain(state, keys, lengths, config, route)
        return
    if _span is not None:
        _span.child("tpubloom_torch.sweep.plan")
    _flat_insert_on(_takes_tiles(config, keys.shape[0], route, False), state, keys, lengths,
                    config, route=route, span=_span)


def flat_query(state, keys, lengths, config, *, route=None, _span=None) -> torch.Tensor:
    """Flat membership of each key: ``bool[B]``, False where ``lengths <
    0`` (and, with a ``route``, where the slot does not own the key).
    ``state`` is only read. One kernel whatever the batch: a thread a key,
    which stops at the key's first zero bit."""
    if _span is None and obs.recording():
        with obs.Range("tpubloom_torch.sweep.flat_query") as span:
            return flat_query(state, keys, lengths, config, route=route, _span=span)
    _check(state, keys, lengths, config, route, flat=True)
    if state.device.type == "cpu":
        return bitops.flat_query_plain(state, keys, lengths, config, route)
    if _span is not None:
        _span.child("tpubloom_torch.sweep.plan")
    return _launch_query(_flat_library(), "flat_query", state, keys, lengths,
                         _flat_args(config, route), route, _span)


# -- the partitioned flat kernels (csrc/flat_bits.cu, csrc/flat_counting.cu) -------

#: A flat insert or counting launch takes the partitioned kernel when its
#: expected positions (a routed slot: its owned share of B k) reach its
#: crossover, in positions per 32-byte sector of the state, and the
#: thread-a-key kernel of flat_bloom.cu below it; flat_partition.cuh sets
#: every size of the partition and refuses a shape it cannot hold, which then
#: keeps the thread-a-key kernel too.
#: The crossovers are chip_smoke.py's flat_crossover phase on an NVIDIA
#: H100 80GB HBM3 (700 W; PERF.md section 6). The update: the partitioned
#: kernel is the faster from B = 2^19 keys at config 4 flat (7 x 2^19
#: positions on 2^24 sectors, 0.219; 0.286 against 0.321 ms).
FLAT_TILE_CROSSOVER = 7 / 32
#: The query, timed on config 4's own traffic (benchmarks/run.py config4: a
#: query of every key after half of them were deleted, so half held, half
#: absent): the partitioned kernel is the faster from B = 2^22 keys at
#: config 4 flat (1.75 a sector; 0.699 against 0.920 ms), where it is also
#: the faster on absent keys (0.399 against 0.921), held keys (0.862
#: against 0.921) and a filter half full (0.715 against 0.919); at 2^21 it
#: is 3 % the slower on that traffic (0.476 against 0.463). At config 4's
#: own launch of 2^24 keys: 1.613 against 2.214 ms.
FLAT_TILE_QUERY_CROSSOVER = 7 / 4
#: The bit insert: the partitioned kernel is the faster from B = 2^18 keys
#: at config 2 (chip_smoke.py's flat_crossover phase, fresh inserts over B =
#: 2^13 .. 2^20; 10 x 2^18 positions on 2^22 sectors, 0.625; 0.142 against
#: 0.154 ms, and 0.112 against 0.077 at 2^17). The bit query has no
#: partitioned kernel.
FLAT_BIT_TILE_CROSSOVER = 5 / 8


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def flat_takes_tiles(config, batch: int, route=None, *, query: bool) -> bool:
    """Whether a flat insert or counting update (``query=False``), or a
    counting query, of ``batch`` keys on ``config``'s state (with a
    ``route``, one slot's) reaches its crossover
    (:data:`FLAT_BIT_TILE_CROSSOVER`, :data:`FLAT_TILE_CROSSOVER` or
    :data:`FLAT_TILE_QUERY_CROSSOVER`) in expected positions a sector;
    never for a bit query. Pure Python and cheap: small batches ask it on
    every call."""
    if batch <= 0 or (query and not config.counting):
        return False
    share = 1.0 if route is None else route.shards_per_dev / route.n_shards
    if not config.counting:
        crossover = FLAT_BIT_TILE_CROSSOVER
    else:
        crossover = FLAT_TILE_QUERY_CROSSOVER if query else FLAT_TILE_CROSSOVER
    return batch * config.k * share >= crossover * _ceil_div(_state_words(config, route), 8)


def flat_tiled_scratch_bytes(config, batch: int, route=None, *, query: bool) -> int:
    """The scratch of a partitioned launch as flat_partition.cuh plans it,
    or -1 where its partition cannot hold the shape (more tiles than its
    passes' histogram, 2^32 positions or more, or B k >= 2^31). Builds the
    kernels. A bit filter has only the partitioned insert."""
    words = _state_words(config, route)
    if config.counting:
        return _flat_tiled_library().tpb_flat_counting_tiled_scratch_bytes(
            batch, config.k, words, 1 if query else 0)
    if query:
        raise ValueError("the flat bit query has no partitioned kernel")
    return _flat_bits_library().tpb_flat_bits_tiled_scratch_bytes(batch, config.k, words)


def flat_tile_geometry() -> tuple[int, int]:
    """flat_partition.cuh's tile (log2 of its words) and piece (the most
    entries a sweep CTA takes), read back from the counting library, which
    builds on it as the bit insert does. Builds the kernels."""
    lib = _flat_tiled_library()
    return lib.tpb_flat_counting_tile_log2(), lib.tpb_flat_counting_tile_piece()


def _takes_tiles(config, batch: int, route, query: bool) -> bool:
    """The wrapper's choice: the crossover, then whether the plan holds."""
    return (flat_takes_tiles(config, batch, route, query=query)
            and flat_tiled_scratch_bytes(config, batch, route, query=query) >= 0)


def _launch_tiled(name, state, keys, lengths, spec, config, route, out=None, span=None) -> None:
    """One partitioned launch (``<name>_tiled``, routed with a route; of
    flat_counting.cu for a counting config, else flat_bits.cu) with the
    scratch its plan needs: ``fn(state, keys, lengths, [out,] B, L, *spec,
    *routing, scratch, scratch_bytes, stream)``, counted under ``name`` and
    ``name_tiled``; ``span`` as for :func:`_launch_update`."""
    B, L = keys.shape
    if not B:
        return
    if span is not None:
        span.child("tpubloom_torch.sweep.plan")
    lib = _flat_tiled_library() if config.counting else _flat_bits_library()
    nbytes = flat_tiled_scratch_bytes(config, B, route, query=out is not None)
    if nbytes < 0:
        raise ValueError(f"{name}: the partition cannot hold {B} keys on this state")
    fn, routing, counter = _entry(lib, f"{name}_tiled", route)
    if span is not None:
        span.child("tpubloom_torch.sweep.alloc")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=state.device)
    ptrs = (state.data_ptr(), keys.data_ptr(), lengths.data_ptr(),
            *(() if out is None else (out.data_ptr(),)))
    if span is not None:
        span.child("tpubloom_torch.sweep.enqueue")
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        err = fn(*ptrs, B, L, *spec, *routing, scratch.data_ptr(), nbytes, stream)
    if span is not None:
        span.child(None)
    _raise_on(err, counter)
    LAUNCHES[counter] += 1
    LAUNCHES[counter.removesuffix("_tiled")] += 1


def _flat_insert_on(tiled: bool, state, keys, lengths, config, *, route=None, span=None) -> None:
    """The flat insert of a checked CUDA state on the kernel named: the
    partitioned one (``tiled``) or the thread-a-key one. :func:`flat_insert`
    picks it by shape; chip_smoke.py and the card tests hold each kernel
    through here. ``span``: the wrapper's range."""
    spec = _flat_args(config, route)
    if tiled:
        _launch_tiled("flat_insert", state, keys, lengths, spec, config, route, span=span)
    else:
        _launch_update(_flat_library(), "flat_insert", state, keys, lengths, spec, route, span)


def _flat_counting_update_on(tiled: bool, state, keys, lengths, config, *, increment: bool,
                             route=None, span=None) -> None:
    """The flat counting update of a checked CUDA state on the kernel
    named: the partitioned one (``tiled``) or the thread-a-key one.
    :func:`flat_counting_update` picks it by shape; chip_smoke.py and the
    card tests hold each kernel through here. ``span``: the wrapper's
    range."""
    spec = (*_flat_args(config, route), 1 if increment else 0)
    if tiled:
        _launch_tiled("flat_counting_update", state, keys, lengths, spec, config, route, span=span)
    else:
        _launch_update(_flat_library(), "flat_counting_update", state, keys, lengths, spec, route,
                       span)


def _flat_counting_query_on(tiled: bool, state, keys, lengths, config, *, route=None,
                            span=None) -> torch.Tensor:
    """The flat counting query of a checked CUDA state on the kernel named,
    as :func:`_flat_counting_update_on`."""
    if not tiled:
        return _launch_query(_flat_library(), "flat_counting_query", state, keys, lengths,
                             _flat_args(config, route), route, span)
    if span is not None:
        span.child("tpubloom_torch.sweep.alloc")
    out = torch.empty((keys.shape[0],), dtype=torch.uint8, device=state.device)
    _launch_tiled("flat_counting_query", state, keys, lengths, _flat_args(config, route), config,
                  route, out, span)
    return out.view(torch.bool)


def flat_counting_update(state, keys, lengths, config, *, increment: bool, route=None,
                         _span=None) -> None:
    """Add (``increment``) or subtract each valid key's multiplicity at
    its k flat counters in ``state`` (``uint32[n_counter_words]``), in
    place; nibbles saturate at 15 and floor at 0. On the card a batch
    whose positions cover enough of the state (:func:`flat_takes_tiles`)
    takes the partitioned kernels, a smaller one the thread-a-key
    kernel; both give the same words."""
    if _span is None and obs.recording():
        with obs.Range("tpubloom_torch.sweep.flat_counting_update") as span:
            return flat_counting_update(state, keys, lengths, config, increment=increment,
                                        route=route, _span=span)
    _check(state, keys, lengths, config, route, counters=True, flat=True)
    if state.device.type == "cpu":
        counting.flat_counting_update_plain(
            state, keys, lengths, config, increment=increment, route=route
        )
        return
    if _span is not None:
        _span.child("tpubloom_torch.sweep.plan")
    _flat_counting_update_on(_takes_tiles(config, keys.shape[0], route, False), state, keys,
                             lengths, config, increment=increment, route=route, span=_span)


def flat_counting_query(state, keys, lengths, config, *, route=None, _span=None) -> torch.Tensor:
    """Flat counting membership: ``bool[B]``, True where all k counters
    are non-zero, False where ``lengths < 0`` (and, with a ``route``,
    where the slot does not own the key). ``state`` is only read. The
    kernel is chosen as for :func:`flat_counting_update`."""
    if _span is None and obs.recording():
        with obs.Range("tpubloom_torch.sweep.flat_counting_query") as span:
            return flat_counting_query(state, keys, lengths, config, route=route, _span=span)
    _check(state, keys, lengths, config, route, counters=True, flat=True)
    if state.device.type == "cpu":
        return counting.flat_counting_query_plain(state, keys, lengths, config, route)
    if _span is not None:
        _span.child("tpubloom_torch.sweep.plan")
    return _flat_counting_query_on(_takes_tiles(config, keys.shape[0], route, True), state, keys,
                                   lengths, config, route=route, span=_span)


# -- the sketch kinds (csrc/cuckoo.cu, csrc/cms.cu) ------------------------------


def _check_sketch(state, keys, lengths, config, kind: str) -> None:
    """The checks of :func:`_check` for a sketch kind's state: ``config.m``
    slots (cuckoo) or ``config.k * config.m`` counters (count-min, top-k)."""
    kinds = ("cuckoo",) if kind == "cuckoo" else ("cms", "topk")
    if config.kind not in kinds:
        raise ValueError(f"kind={config.kind!r} config given to a {kind} kernel")
    _check_tensors(state, keys, lengths, config.m if kind == "cuckoo" else config.m * config.k,
                   "config")


def _launch(lib, name: str, state, *args, counter: str | None = None, span=None) -> None:
    """One call of ``tpb_<name>(*args, stream)`` on ``state``'s device,
    counted under ``counter`` (``name`` when not given); ``span`` as for
    :func:`_launch_update`."""
    fn = getattr(lib, f"tpb_{name}")
    if span is not None:
        span.child("tpubloom_torch.sweep.enqueue")
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        err = fn(*args, stream)
    if span is not None:
        span.child(None)
    _raise_on(err, name)
    LAUNCHES[counter or name] += 1


#: The second launches of the cuckoo insert and delete (``csrc/cuckoo.cu``):
#: the round walk (the main path's), the ordered walk on one warp with its
#: prefetch lanes, and the ordered walk on one thread alone.
CUCKOO_WALKS = ("rounds", "warp", "thread")


def cuckoo_window() -> int:
    """The round walk's window on the main path (threads of its CTA)."""
    return _cuckoo_library().tpb_cuckoo_window()


def _cuckoo_scratch(state, B: int, config):
    """The walk's ``(fp, i1)`` scratch (``int32[2 B]``) and the round
    walk's bucket owners (``int32[n_buckets]``, set by the entry)."""
    return (torch.empty((2 * B,), dtype=torch.int32, device=state.device),
            torch.empty((config.m // cuckoo.BUCKET_SIZE,), dtype=torch.int32, device=state.device))


def _cuckoo_walk(name: str, state, keys, lengths, config, *outs, span=None) -> None:
    """The insert or delete (two launches: the hash, then the round walk)
    into ``outs``, with its scratch; no stats. ``span``: the wrapper's
    range, in its ``sweep.alloc`` child."""
    B, L = keys.shape
    if not B:
        return
    fi, owner = _cuckoo_scratch(state, B, config)
    _launch(_cuckoo_library(), name, state, state.data_ptr(), keys.data_ptr(), lengths.data_ptr(),
            fi.data_ptr(), owner.data_ptr(), *(o.data_ptr() for o in outs), None, B, L,
            config.m // cuckoo.BUCKET_SIZE, config.seed, span=span)


def _cuckoo_walk_on(variant: str, insert: bool, state, keys, lengths, config, window: int = 0):
    """The insert (``insert``) or delete of a checked CUDA state on the
    second launch named in :data:`CUCKOO_WALKS`; the round walk with
    ``window`` threads (0: the main path's). chip_smoke.py times the three
    against each other; counted under ``cuckoo_insert`` / ``cuckoo_delete``.
    Returns ``(flags bool[B], kicks int32[B] or None, stats)``: ``stats``
    is the round walk's ``int32[2]`` (rounds, keys walked and not
    committed) on the card, None for the other two."""
    B, L = keys.shape
    flag = torch.zeros((B,), dtype=torch.uint8, device=state.device)
    kicks = torch.zeros((B,), dtype=torch.int32, device=state.device) if insert else None
    stats = (torch.zeros((2,), dtype=torch.int32, device=state.device)
             if variant == "rounds" else None)
    if B:
        fi, owner = _cuckoo_scratch(state, B, config)
        _launch(_cuckoo_library(), "cuckoo_walk_variant", state, state.data_ptr(),
                keys.data_ptr(), lengths.data_ptr(), fi.data_ptr(), owner.data_ptr(),
                flag.data_ptr(), None if kicks is None else kicks.data_ptr(),
                None if stats is None else stats.data_ptr(), B, L,
                config.m // cuckoo.BUCKET_SIZE, config.seed, int(insert),
                CUCKOO_WALKS.index(variant), window,
                counter="cuckoo_insert" if insert else "cuckoo_delete")
    return flag.view(torch.bool), kicks, stats


def _cuckoo_chase(rows: torch.Tensor, start: int, steps: int) -> torch.Tensor:
    """``steps`` dependent 16-byte row reads on one thread over ``rows``
    (a CUDA ``uint32[n * 4]`` whose rows' first words link them), from row
    ``start``: chip_smoke.py's measure of the latency the walk meets.
    Returns the last row index (``int32[1]``); counted nowhere."""
    out = torch.zeros((1,), dtype=torch.int32, device=rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = _cuckoo_library().tpb_cuckoo_chase(rows.data_ptr(), start, steps, out.data_ptr(),
                                                 stream)
    _raise_on(err, "cuckoo_chase")
    return out


def cuckoo_insert(state, keys, lengths, config, *,
                  _span=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Insert each valid key's fingerprint into the cuckoo table ``state``
    (``uint32[config.m]``, 4 slots a bucket), in batch order, in place;
    ``(ok bool[B], kicks int32[B])``: False for a key rejected FULL (its
    kick chain unwound, the table as before it) and for padding, and the
    kick steps each key took."""
    if _span is None and obs.recording():
        with obs.Range("tpubloom_torch.sweep.cuckoo_insert") as span:
            return cuckoo_insert(state, keys, lengths, config, _span=span)
    _check_sketch(state, keys, lengths, config, "cuckoo")
    if state.device.type == "cpu":
        return cuckoo.cuckoo_insert_plain(state, keys, lengths, config)
    B = keys.shape[0]
    if _span is not None:
        _span.child("tpubloom_torch.sweep.alloc")
    ok = torch.empty((B,), dtype=torch.uint8, device=state.device)
    kicks = torch.empty((B,), dtype=torch.int32, device=state.device)
    _cuckoo_walk("cuckoo_insert", state, keys, lengths, config, ok, kicks, span=_span)
    return ok.view(torch.bool), kicks


def cuckoo_delete(state, keys, lengths, config, *, _span=None) -> torch.Tensor:
    """Remove one stored copy of each valid key's fingerprint, in batch
    order, in place; ``bool[B]``, whether a copy was there."""
    if _span is None and obs.recording():
        with obs.Range("tpubloom_torch.sweep.cuckoo_delete") as span:
            return cuckoo_delete(state, keys, lengths, config, _span=span)
    _check_sketch(state, keys, lengths, config, "cuckoo")
    if state.device.type == "cpu":
        return cuckoo.cuckoo_delete_plain(state, keys, lengths, config)
    if _span is not None:
        _span.child("tpubloom_torch.sweep.alloc")
    deleted = torch.empty((keys.shape[0],), dtype=torch.uint8, device=state.device)
    _cuckoo_walk("cuckoo_delete", state, keys, lengths, config, deleted, span=_span)
    return deleted.view(torch.bool)


def cuckoo_query(state, keys, lengths, config, *, _span=None) -> torch.Tensor:
    """Cuckoo membership: ``bool[B]``, True where the key's fingerprint is
    in either of its buckets, False for padding. ``state`` is only read."""
    if _span is None and obs.recording():
        with obs.Range("tpubloom_torch.sweep.cuckoo_query") as span:
            return cuckoo_query(state, keys, lengths, config, _span=span)
    _check_sketch(state, keys, lengths, config, "cuckoo")
    if state.device.type == "cpu":
        return cuckoo.cuckoo_query_plain(state, keys, lengths, config)
    B, L = keys.shape
    if _span is not None:
        _span.child("tpubloom_torch.sweep.alloc")
    out = torch.empty((B,), dtype=torch.uint8, device=state.device)
    if B:
        _launch(_cuckoo_library(), "cuckoo_query", state, state.data_ptr(), keys.data_ptr(),
                lengths.data_ptr(), out.data_ptr(), B, L, config.m // cuckoo.BUCKET_SIZE,
                config.seed, span=_span)
    return out.view(torch.bool)


#: A count-min update takes the partitioned kernel (``cms_update_tiled``)
#: when the batch's positions (B depth) reach this many, and the
#: thread-a-key kernel below it; a shape the partition's plan cannot hold
#: keeps the thread-a-key kernel too. From chip_smoke.py's cms_crossover
#: phase (unit updates of the Zipf stream, half an octave apart, on four
#: grids from 2,016 x 5 to 27,182,848 x 7; NVIDIA H100 80GB HBM3, 700 W;
#: PERF.md section 6): on the two grids larger than the L2 the partitioned
#: kernel is the faster from 1,835,008 positions (B = 2^18 at depth 7) and
#: a thread a key up to 1,297,548, whatever the width (0.771 and 0.077
#: positions a sector); the partitioned kernel's six launches cost
#: 0.05-0.1 ms at any batch. Grids the L2 holds cross later (2.6 M
#: positions at 2,016 x 5, 3.7-5.2 M at 271,840 x 7), where this pick is
#: up to 1.43x the faster kernel's time.
CMS_TILE_CROSSOVER = 3 << 19


def cms_takes_tiles(config, batch: int) -> bool:
    """Whether a count-min update of ``batch`` keys on ``config``'s grid
    reaches :data:`CMS_TILE_CROSSOVER` positions. Pure Python and cheap:
    small batches ask it on every call."""
    return batch > 0 and batch * config.k >= CMS_TILE_CROSSOVER


def cms_tiled_scratch(config, batch: int, device, *, weighted: bool) -> torch.Tensor | None:
    """The scratch of a partitioned count-min update (``uint8`` on
    ``device``) as ``csrc/cms.cu`` plans it, or None where its partition
    cannot hold the shape (more than 2^28 counters, or B depth >= 2^31).
    Builds the kernels."""
    nbytes = _cms_library().tpb_cms_tiled_scratch_bytes(batch, config.m, config.k, int(weighted))
    return None if nbytes < 0 else torch.empty(nbytes, dtype=torch.uint8, device=device)


def cms_tile_counts(scratch: torch.Tensor, config, batch: int, *, weighted: bool) -> torch.Tensor:
    """The entries each 64 KiB tile of the grid took in the last partitioned
    update of ``batch`` keys that ran in ``scratch`` (int64 ``[n_tiles]``,
    from the plan's tile starts; on the card), to hold the kernel's
    partition against :func:`tpubloom_torch.ops.cms.cms_tile_counts_plain`."""
    at = _cms_library().tpb_cms_tile_starts_at(batch, config.m, config.k, int(weighted))
    n_tiles = _ceil_div(config.m * config.k, 1 << flat_tile_geometry()[0])
    starts = scratch[at : at + 4 * (n_tiles + 1)].view(torch.int32).to(torch.int64)
    return starts.diff()


def _cms_update_on(tiled: bool, state, keys, lengths, config, increments=None, *,
                   scratch: torch.Tensor | None = None, span=None) -> None:
    """The count-min update of a checked CUDA state on the kernel named:
    the partitioned one (``tiled``, in ``scratch``, from
    :func:`cms_tiled_scratch` when None) or the thread-a-key one.
    :func:`cms_update` picks it by shape; chip_smoke.py and the card tests
    hold each kernel through here. A partitioned launch counts under
    ``cms_update`` and ``cms_update_tiled``. ``span``: the wrapper's
    range."""
    B, L = keys.shape
    if not B:
        return
    incs = None if increments is None else increments.contiguous()
    args = (state.data_ptr(), keys.data_ptr(), lengths.data_ptr(),
            None if incs is None else incs.data_ptr(), B, L, config.m, config.k, config.seed)
    if not tiled:
        _launch(_cms_library(), "cms_update", state, *args, span=span)
        return
    if scratch is None:
        scratch = cms_tiled_scratch(config, B, state.device, weighted=incs is not None)
        if scratch is None:
            raise ValueError(f"cms_update_tiled: the partition cannot hold {B} keys on this grid")
    _launch(_cms_library(), "cms_update_tiled", state, *args, scratch.data_ptr(), scratch.numel(),
            span=span)
    LAUNCHES["cms_update"] += 1


def cms_update(state, keys, lengths, config, increments=None, *, _span=None) -> None:
    """Add each valid key's increment (``increments``: ``uint32[B]`` on
    ``state``'s device; None for 1 a key) to its ``config.k`` counters of
    the count-min grid ``state`` (``uint32[k * m]``, row-major), mod 2^32,
    in place. On the card a batch whose positions cover enough of the grid
    (:func:`cms_takes_tiles`) takes the partitioned kernel, a smaller one
    the thread-a-key kernel; both give the same words."""
    if _span is None and obs.recording():
        with obs.Range("tpubloom_torch.sweep.cms_update") as span:
            return cms_update(state, keys, lengths, config, increments, _span=span)
    _check_sketch(state, keys, lengths, config, "cms")
    if increments is not None and (increments.dtype != torch.uint32
                                   or increments.device != state.device
                                   or tuple(increments.shape) != (keys.shape[0],)):
        raise ValueError(f"increments must be uint32[{keys.shape[0]}] on {state.device}")
    if state.device.type == "cpu":
        cms.cms_update_plain(state, keys, lengths, config, increments)
        return
    B = keys.shape[0]
    if _span is not None:
        _span.child("tpubloom_torch.sweep.plan")
    scratch = (cms_tiled_scratch(config, B, state.device, weighted=increments is not None)
               if cms_takes_tiles(config, B) else None)
    _cms_update_on(scratch is not None, state, keys, lengths, config, increments, scratch=scratch,
                   span=_span)


#: The count-min estimate's kernels (``csrc/cms.cu``), by their entries:
#: the row-phased gather and a thread a key.
CMS_ESTIMATES = {"rows": "cms_estimate_rows", "thread_a_key": "cms_estimate"}

#: A count-min estimate of this many keys or more takes the row-phased
#: kernel (``cms_estimate_rows``), a smaller one a thread a key. From
#: chip_smoke.py's estimate crossover (both kernels on the sketch path's
#: 2,718,304 x 7 grid, batches an octave apart from 2^12 to 2^20 of the
#: Zipf(1.1) stream and of distinct ids; NVIDIA H100 80GB HBM3, 700 W;
#: PERF.md section 6): on distinct ids the row-phased kernel is the faster
#: from 2^18 keys (1.05x) and 1.49x at 2^20; on the Zipf stream, whose hot
#: counters the thread-a-key kernel finds in the L1 at once, only at 2^20.
#: Below 2^16 the row-phased kernel's chain of row phases costs ~5 µs
#: against ~3. At 2^19 the pick is at worst 1.14x the faster kernel (the
#: Zipf stream); at 2^18 it would be 1.29x, at 2^20 1.27x.
CMS_ROWS_CROSSOVER = 1 << 19


def cms_takes_rows(batch: int) -> bool:
    """Whether a count-min estimate of ``batch`` keys takes the row-phased
    kernel (:data:`CMS_ROWS_CROSSOVER`)."""
    return batch >= CMS_ROWS_CROSSOVER


def _cms_estimate_on(kernel: str, state, keys, lengths, config, span=None) -> torch.Tensor:
    """The count-min estimate of a checked CUDA state on the kernel named in
    :data:`CMS_ESTIMATES`: :func:`cms_estimate` picks it by batch,
    chip_smoke.py times them against each other, the card tests hold each.
    Every launch counts under ``cms_estimate``, a row-phased one also under
    ``cms_estimate_rows``. ``span``: the wrapper's range."""
    B, L = keys.shape
    lib = _cms_library()
    if span is not None:
        span.child("tpubloom_torch.sweep.alloc")
    out = torch.empty((B,), dtype=torch.int32, device=state.device)
    if B:
        _launch(lib, CMS_ESTIMATES[kernel], state, state.data_ptr(), keys.data_ptr(),
                lengths.data_ptr(), out.data_ptr(), B, L, config.m, config.k, config.seed,
                counter="cms_estimate", span=span)
        if kernel != "thread_a_key":
            LAUNCHES["cms_estimate_rows"] += 1
    return out.view(torch.uint32)


def cms_estimate(state, keys, lengths, config, *, _span=None) -> torch.Tensor:
    """Each key's count-min estimate, the minimum of its ``config.k``
    counters: ``uint32[B]``, 0 for padding. ``state`` is only read. On the
    card a batch of :data:`CMS_ROWS_CROSSOVER` keys or more takes the
    row-phased kernel, a smaller one a thread a key; both give the same
    estimates."""
    if _span is None and obs.recording():
        with obs.Range("tpubloom_torch.sweep.cms_estimate") as span:
            return cms_estimate(state, keys, lengths, config, _span=span)
    _check_sketch(state, keys, lengths, config, "cms")
    if state.device.type == "cpu":
        return cms.cms_estimate_plain(state, keys, lengths, config)
    B = keys.shape[0]
    if _span is not None:
        _span.child("tpubloom_torch.sweep.plan")
    return _cms_estimate_on("rows" if cms_takes_rows(B) else "thread_a_key", state, keys, lengths,
                            config, _span)


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
