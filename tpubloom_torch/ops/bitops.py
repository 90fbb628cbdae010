"""Flat bloom filter in plain PyTorch: the plain versions of the flat bit
kernels (``tpubloom_torch/csrc/flat_bloom.cu``, and the partitioned
insert of ``flat_bits.cu``), and the partition of the partitioned flat
kernels (``flat_partition.cuh``).

The counterpart of ``tpubloom/ops/bitops.py``. The filter is a packed
``uint32[n_words]`` array, bit ``pos`` is ``words[pos >> 5] & (1 << (pos
& 31))``, and a key's k positions follow the flat spec of
:func:`tpubloom_torch.ops.hashing.positions`: these are the reference
gem's SETBIT/GETBIT positions, so the words convert to a Redis string
bitmap (``tpubloom_torch.utils.packing``). An insert ORs the k bits
(``scatter_or``), a query ANDs them (``query_membership``); the fill
ratio is ``_FilterBase.bits_set`` over the same words.

With a ``route`` (:class:`~tpubloom_torch.ops.hashing.ShardRoute`) the
state is one slot of a sharded filter: ``shards_per_dev`` shards of
``m_per_shard`` positions each, shard-major. A key hashes with ``m =
m_per_shard`` inside its shard, and only keys the slot owns count
(``tpubloom/parallel/sharded.py`` ``_routed_positions``).

Values are int64 tensors holding u32s, and the state is written through
its ``int32`` view (torch's ``uint32`` has no shifts, adds or indexed
writes on the CPU).
"""

from __future__ import annotations

import torch

from tpubloom_torch.ops import hashing
from tpubloom_torch.ops.blocked import _words, or_bits
from tpubloom_torch.ops.hashing import M32


def routed_positions(keys, lengths, config, route=None):
    """``(valid, pos)``: whether each key sets and answers, and its k
    positions (int64 ``[B, k]``, bits or counters) in the state.

    With ``route=None`` the state is the whole filter (``config.m``
    positions) and every non-padding key is valid. With a route the key
    hashes with ``m = m_per_shard``, only keys the slot owns are valid,
    and a position lands at ``local_row * m_per_shard + pos``."""
    m = config.m if route is None else config.m_per_shard
    hi, lo = hashing.positions(keys, lengths.clamp(min=0), m=m, k=config.k, seed=config.seed)
    pos = (hi << 32) | lo
    if route is None:
        return lengths >= 0, pos
    local, owned = hashing.route_local(keys, lengths, route, config.seed)
    return owned, pos + (torch.where(owned, local, 0) * m)[:, None]


def flat_insert_plain(state, keys, lengths, config, route=None) -> None:
    """Plain version of the ``flat_insert`` kernel: set every valid key's
    k bits in ``state`` (``uint32``, any shape), in place. With a
    ``route``, the plain version of ``sharded_flat_insert``: keys the slot
    does not own set nothing."""
    valid, pos = routed_positions(keys, lengths, config, route)
    or_bits(_words(state), pos[valid].reshape(-1))


def flat_query_plain(state, keys, lengths, config, route=None) -> torch.Tensor:
    """Plain version of the ``flat_query`` kernel: ``bool[B]``, True where
    all k bits of the key are set; padding (``lengths < 0``) and, with a
    ``route``, keys the slot does not own answer False. ``state`` is only
    read."""
    valid, pos = routed_positions(keys, lengths, config, route)
    w = _words(state)[pos >> 5].to(torch.int64) & M32
    return (((w >> (pos & 31)) & 1) == 1).all(dim=-1) & valid


def flat_tile_counts_plain(
    keys: torch.Tensor, lengths: torch.Tensor, config, tile_log2: int, route=None,
) -> torch.Tensor:
    """The partition of the partitioned flat kernels
    (``tpubloom_torch/csrc/flat_partition.cuh``): int64 ``[n_tiles]``, the
    entries each tile of ``2^tile_log2`` words of the state (with a
    ``route``, the slot's) gets, one a valid (owned) key's position. A word
    holds 8 counters of a counting config, or 32 bits."""
    valid, pos = routed_positions(keys, lengths, config, route)
    per_word_log2 = 3 if config.counting else 5
    positions = config.m if route is None else route.shards_per_dev * config.m_per_shard
    n_tiles = -(-(positions >> per_word_log2) >> tile_log2)
    return torch.bincount((pos[valid] >> (tile_log2 + per_word_log2)).reshape(-1),
                          minlength=n_tiles)
