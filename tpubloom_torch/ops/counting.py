"""Counting filters in plain PyTorch: the plain versions of the blocked
counting kernels (``tpubloom_torch/csrc/blocked_counting.cu``) and of the
flat counting kernels (``tpubloom_torch/csrc/flat_bloom.cu``).

Layout (the same as ``tpubloom/ops/counting.py``): counter ``pos`` lives
in word ``pos >> 3``, nibble ``pos & 7`` (bits ``4·(pos & 7)`` and up) of
a packed ``uint32[m / 8]`` array. In the blocked counting layout a block
of ``block_bits`` bits holds ``counters_per_block = block_bits / 4``
counters, and a key's k counters ``c_i`` all live in its block ``blk``:
the in-block positions follow the blocked spec of
:mod:`tpubloom_torch.ops.blocked` with ``block_bits = counters_per_block``,
and the global counter index is ``blk · counters_per_block + c_i``. In
the flat counting layout a key's k counters are the flat positions of
:func:`tpubloom_torch.ops.hashing.positions` over ``m`` counters
(``tpubloom/filter.py`` ``make_counter_fn``), anywhere in the array.

Semantics (``tpubloom.ops.counting.counter_update``): an insert adds each
distinct counter's multiplicity in the batch and saturates at 15; a
delete subtracts it and floors at 0; the clamp is taken once, against the
counter's value before the batch. Membership: all k counters non-zero.

Values are int64 tensors holding u32s, and the state is written through
its ``int32`` view (torch's ``uint32`` has no shifts, adds or indexed
writes on the CPU).
"""

from __future__ import annotations

import torch

from tpubloom_torch.ops.bitops import routed_positions
from tpubloom_torch.ops.blocked import _words, routed_blocks
from tpubloom_torch.ops.hashing import M32


def counter_update_plain(
    words: torch.Tensor, pos: torch.Tensor, valid: torch.Tensor, *, increment: bool
) -> None:
    """Apply a saturating +1 (``increment``) or flooring -1 per valid
    position to the packed counters, in place.

    ``words`` is the flat ``int32`` view of the counter words, ``pos``
    int64 counter positions, ``valid`` bool of the same shape. Each
    distinct position gets its multiplicity, clamped once against its
    pre-batch nibble (``min(cnt, 15 - v)`` / ``min(cnt, v)``); the clamped
    contributions sit in disjoint nibble lanes, so their per-word sum
    cannot carry, and each touched word is written once."""
    upos, cnt = torch.unique(pos[valid], return_counts=True)
    if not upos.numel():
        return
    widx = upos >> 3
    shift = 4 * (upos & 7)
    cur = words[widx].to(torch.int64) & M32
    v = (cur >> shift) & 15
    delta = torch.minimum(cnt, 15 - v) if increment else torch.minimum(cnt, v)
    uw, inv = torch.unique(widx, return_inverse=True)
    acc = torch.zeros(uw.shape, dtype=torch.int64, device=words.device)
    acc.index_add_(0, inv, delta << shift)
    old = words[uw].to(torch.int64) & M32
    new = old + acc if increment else old - acc
    words[uw] = (((new + (1 << 31)) & M32) - (1 << 31)).to(torch.int32)


def _counter_positions(keys, lengths, config, route=None):
    return routed_blocks(keys, lengths, config, route, block_bits=config.counters_per_block)


def blocked_counting_update_plain(
    state: torch.Tensor, keys: torch.Tensor, lengths: torch.Tensor, config, *,
    increment: bool, route=None,
) -> None:
    """Plain version of the ``blocked_counting_update`` kernel: each valid
    key adds (``increment``) or subtracts its counters' multiplicities at
    the k nibbles of its block, saturating at 15 / flooring at 0, in
    place. ``state`` is the ``uint32`` storage in any shape (the fat and
    logical views are the same words). With a ``route``
    (``blocked.routed_blocks``), the plain version of the
    ``sharded_blocked_counting_update`` kernel: keys the slot does not
    own change nothing."""
    valid, blk, cpos = _counter_positions(keys, lengths, config, route)
    gpos = blk[:, None] * config.counters_per_block + cpos
    counter_update_plain(
        _words(state), gpos.reshape(-1),
        valid[:, None].expand(gpos.shape).reshape(-1), increment=increment,
    )


def blocked_counting_query_plain(
    state: torch.Tensor, keys: torch.Tensor, lengths: torch.Tensor, config,
    route=None,
) -> torch.Tensor:
    """Plain version of the ``blocked_counting_query`` kernel: ``bool[B]``,
    True where all k counters of the key are non-zero; entries with
    ``lengths < 0`` answer False. ``state`` is never written. With a
    ``route``, the plain version of ``sharded_blocked_counting_query``:
    keys the slot does not own answer False."""
    valid, blk, cpos = _counter_positions(keys, lengths, config, route)
    w = config.words_per_block
    rows = _words(state).reshape(-1, w)[blk].to(torch.int64) & M32
    vals = torch.gather(rows, 1, cpos >> 3)
    cnt = (vals >> (4 * (cpos & 7))) & 15
    return (cnt > 0).all(dim=-1) & valid


def flat_counting_update_plain(
    state: torch.Tensor, keys: torch.Tensor, lengths: torch.Tensor, config, *,
    increment: bool, route=None,
) -> None:
    """Plain version of the ``flat_counting_update`` kernel
    (``tpubloom.ops.counting.counter_update`` over the keys' flat counter
    positions): each valid key adds (``increment``) or subtracts its
    counters' multiplicities, saturating at 15 / flooring at 0, in place.
    With a ``route``, the plain version of ``sharded_flat_counting_update``:
    keys the slot does not own change nothing."""
    valid, pos = routed_positions(keys, lengths, config, route)
    counter_update_plain(
        _words(state), pos.reshape(-1),
        valid[:, None].expand(pos.shape).reshape(-1), increment=increment,
    )


def flat_counting_query_plain(
    state: torch.Tensor, keys: torch.Tensor, lengths: torch.Tensor, config,
    route=None,
) -> torch.Tensor:
    """Plain version of the ``flat_counting_query`` kernel
    (``counting_membership``): ``bool[B]``, True where all k counters of
    the key are non-zero; padding and, with a ``route``, keys the slot does
    not own answer False. ``state`` is never written."""
    valid, pos = routed_positions(keys, lengths, config, route)
    vals = _words(state)[pos >> 3].to(torch.int64) & M32
    return (((vals >> (4 * (pos & 7))) & 15) > 0).all(dim=-1) & valid

