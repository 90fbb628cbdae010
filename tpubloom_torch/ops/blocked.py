"""Blocked (cache-line) bloom filter in plain PyTorch: the position spec and
the plain versions of the two kernels.

THE BLOCKED POSITION SPEC (the same as ``tpubloom/ops/blocked.py``)
------------------------------------------------------------------
Given the four base hashes (h_a, h_b, g_a, g_b — see
:mod:`tpubloom_torch.ops.hashing`) and ``n_blocks = m / block_bits``
(both powers of two)::

  blk = h_a mod n_blocks                          # owning block

and, with ``b`` the in-block position count (= block_bits here), two
in-block variants selected by ``config.block_hash``:

``"chunk"``: pool = h_b | g_a<<32 | g_b<<64 (96 bits);
``bit_i = (pool >> (i·log2(b))) mod b``. Requires k·log2(b) <= 96.

``"ap"``: ``bit_i = ((g_a + i·(g_b | 1)) mod 2^32) mod b``.

Bit ``bit_i`` of a block is bit ``bit_i mod 32`` (LSB-first) of word
``bit_i div 32`` in the block's ``uint32[block_bits/32]`` row.

The plain versions (:func:`blocked_query_plain`,
:func:`blocked_insert_plain`) take the same arguments as the CUDA kernels
in ``tpubloom_torch/csrc/blocked_bloom.cu`` — the filter state, the
packed keys and their lengths — and compute the same function. The CPU
tests run them against ``tpubloom``; on the card they serve only as the
comparison for the kernels. Values are int64 tensors holding u32s (see
the hashing module on why).
"""

from __future__ import annotations

import torch

from tpubloom_torch.ops import hashing
from tpubloom_torch.ops.hashing import M32


def block_positions(
    keys: torch.Tensor,
    lengths: torch.Tensor,
    *,
    n_blocks: int,
    block_bits: int,
    k: int,
    seed: int,
    block_hash: str = "ap",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Blocked-spec coordinates of each key (module docstring has the spec).

    Returns ``(blk, bit)``: ``blk`` int64[...], owning block per key;
    ``bit`` int64[..., k], in-block bit positions.
    """
    h_a = hashing.murmur3_32(keys, lengths, seed)
    g_a = hashing.fnv1a_32(keys, lengths)
    g_b = hashing.murmur3_32(keys, lengths, seed ^ hashing.SEED_XOR_GB)
    blk = h_a & (n_blocks - 1)
    mask = block_bits - 1
    bits = []
    if block_hash == "chunk":
        nb = (block_bits - 1).bit_length()
        if k * nb > 96:
            raise ValueError(
                f"chunk in-block hash needs k*log2(block_bits) <= 96 "
                f"(k={k}, {nb} bits/position)"
            )
        h_b = hashing.murmur3_32(keys, lengths, seed ^ hashing.SEED_XOR_HB)
        pool = (h_b, g_a, g_b)
        for i in range(k):
            sh = i * nb
            w, off = sh >> 5, sh & 31
            v = pool[w] >> off
            if off + nb > 32:
                v = v | ((pool[w + 1] << (32 - off)) & M32)
            bits.append(v & mask)
    elif block_hash == "ap":
        stride = g_b | 1
        p = g_a
        for i in range(k):
            if i > 0:
                p = (p + stride) & M32
            bits.append(p & mask)
    else:
        raise ValueError(f"block_hash must be 'chunk' or 'ap', got {block_hash!r}")
    return blk, torch.stack(bits, dim=-1)


def build_masks(bit: torch.Tensor, words_per_block: int) -> torch.Tensor:
    """OR the k in-block positions into per-key row masks:
    int64 ``[B, k]`` positions -> int64 ``[B, W]`` u32 masks."""
    word = bit >> 5
    one = 1 << (bit & 31)
    iota = torch.arange(words_per_block, device=bit.device)
    mask = torch.zeros(bit.shape[:-1] + (words_per_block,), dtype=torch.int64, device=bit.device)
    for i in range(bit.shape[-1]):
        mask = mask | torch.where(word[..., i, None] == iota, one[..., i, None], 0)
    return mask


def routed_blocks(keys, lengths, config, route, *, block_bits: int):
    """``(valid, blk, pos)``: whether each key sets and answers, its block
    row in the state, and its k in-block positions (over ``block_bits``
    positions).

    With ``route=None`` the state is the whole filter (``n_blocks``
    rows) and every non-padding key is valid. With a
    :class:`~tpubloom_torch.ops.hashing.ShardRoute` the state is one
    slot's shards (``shards_per_dev * n_blocks_per_shard`` rows): the key
    hashes with ``n_blocks = n_blocks_per_shard``, and only keys the slot
    owns are valid, at row ``local_row * n_blocks_per_shard + blk``
    (``tpubloom/parallel/sharded.py`` ``_routed_blocks``)."""
    nb = config.n_blocks if route is None else config.n_blocks_per_shard
    blk, pos = block_positions(
        keys, lengths.clamp(min=0),
        n_blocks=nb, block_bits=block_bits,
        k=config.k, seed=config.seed, block_hash=config.block_hash,
    )
    if route is None:
        return lengths >= 0, blk, pos
    local, owned = hashing.route_local(keys, lengths, route, config.seed)
    return owned, blk + torch.where(owned, local, 0) * nb, pos


def _positions(keys, lengths, config, route=None):
    return routed_blocks(keys, lengths, config, route, block_bits=config.block_bits)


def _words(state: torch.Tensor) -> torch.Tensor:
    """The state's flat int32 view (same memory; torch's uint32 lacks
    indexed writes)."""
    return state.view(torch.int32).reshape(-1)


def blocked_query_plain(
    state: torch.Tensor, keys: torch.Tensor, lengths: torch.Tensor, config,
    route=None,
) -> torch.Tensor:
    """Plain version of the ``blocked_query`` kernel: hash, build the
    masks, gather each key's row, AND-test. ``bool[B]``; entries with
    ``lengths < 0`` answer False. ``state`` is never written. With a
    ``route`` (:func:`routed_blocks`), the plain version of the
    ``sharded_blocked_query`` kernel: keys the slot does not own answer
    False."""
    w = config.words_per_block
    valid, blk, bit = _positions(keys, lengths, config, route)
    masks = build_masks(bit, w)
    rows = _words(state).reshape(-1, w)[blk].to(torch.int64) & M32
    return ((rows & masks) == masks).all(dim=-1) & valid


def blocked_insert_plain(
    state: torch.Tensor, keys: torch.Tensor, lengths: torch.Tensor, config,
    route=None,
) -> None:
    """Plain version of the ``blocked_insert`` kernel: set every valid
    key's k bits in ``state``, in place. With a ``route``
    (:func:`routed_blocks`), the plain version of the
    ``sharded_blocked_insert`` kernel: keys the slot does not own set
    nothing.

    torch has no scatter-OR, so: take the global bit indices
    ``blk·block_bits + bit``, ``unique`` them, keep those not yet set,
    and ``index_put_(accumulate=True)`` their ``1 << (bit & 31)`` values
    into their words in int64 — a sum of distinct unset powers of two is
    their OR."""
    valid, blk, bit = _positions(keys, lengths, config, route)
    gbit = (blk[:, None] * config.block_bits + bit)[valid].reshape(-1)
    gbit = torch.unique(gbit)
    words = _words(state)
    widx = gbit >> 5
    one = 1 << (gbit & 31)
    unset = ((words[widx].to(torch.int64) & M32) & one) == 0
    widx, one = widx[unset], one[unset]
    uw, inv = torch.unique(widx, return_inverse=True)
    acc = words[uw].to(torch.int64) & M32
    acc.index_put_((inv,), one, accumulate=True)
    words[uw] = (((acc + (1 << 31)) & M32) - (1 << 31)).to(torch.int32)


def blocked_test_insert_plain(
    state: torch.Tensor, keys: torch.Tensor, lengths: torch.Tensor, config
) -> torch.Tensor:
    """Test-and-insert: each key's membership BEFORE the batch, then the
    insert. Within-batch duplicates all report the pre-batch state;
    padded entries report False."""
    present = blocked_query_plain(state, keys, lengths, config)
    blocked_insert_plain(state, keys, lengths, config)
    return present
