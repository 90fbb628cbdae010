"""Count-min sketch in plain PyTorch: the plain versions of the count-min
kernels (``tpubloom_torch/csrc/cms.cu``), held bit for bit against
``tpubloom/ops/cms.py``, and the plain partition of its partitioned
update.

The sketch is a ``[depth, width]`` grid of ``uint32`` counters, stored
flat and row-major (``uint32[depth * width]``; ``width = config.m``,
``depth = config.k``). A key's counter in row ``r`` is position ``r`` of
its flat walk over ``m = width`` positions (:func:`tpubloom_torch.ops.
hashing.positions` with ``k = depth``; the mod walk when ``width`` is not
a power of two), at flat index ``r * width + pos``. An update adds each
valid key's increment to its ``depth`` counters, mod 2^32 (a counter
wraps, as ``tpubloom``'s ``.at[].add`` does; duplicate keys and row
collisions add up); an estimate is the minimum of the key's ``depth``
counters, 0 on padding (``lengths < 0``), which adds nothing.

Values are int64 tensors holding u32s; the state is read and written
through its ``int32`` view.
"""

from __future__ import annotations

import torch

from tpubloom_torch.ops import hashing
from tpubloom_torch.ops.hashing import M32


def cms_positions(keys: torch.Tensor, lengths: torch.Tensor, *, width: int, depth: int,
                  seed: int) -> torch.Tensor:
    """Each key's counter position in each row: int64 ``[B, depth]`` in
    ``[0, width)`` (``tpubloom.ops.cms.cms_positions``: the low word of the
    flat walk, which holds the whole position since width < 2^31)."""
    _, lo = hashing.positions(keys, lengths, m=width, k=depth, seed=seed)
    return lo


def flat_indices(pos: torch.Tensor, width: int) -> torch.Tensor:
    """``[B, depth]`` row-major indices ``r * width + pos`` into the flat grid."""
    depth = pos.shape[-1]
    return torch.arange(depth, dtype=torch.int64, device=pos.device)[None, :] * width + pos


def cms_tile_counts_plain(positions: torch.Tensor, width: int, tile_log2: int,
                          valid: torch.Tensor | None = None) -> torch.Tensor:
    """The partition of the partitioned count-min update (``csrc/cms.cu`` on
    ``csrc/flat_partition.cuh``, one u32 counter a word, row-major): int64
    ``[n_tiles]``, the entries each tile of ``2^tile_log2`` counters of the
    flat ``[depth * width]`` grid gets, one for each row of each valid key
    (``positions``: ``[B, depth]`` from :func:`cms_positions`; ``valid``
    bool[B], None for all). A tile may straddle two rows; the last may be
    ragged."""
    flat = flat_indices(positions.to(torch.int64), width)
    if valid is not None:
        flat = flat[valid]
    n_tiles = -(-(positions.shape[-1] * width) >> tile_log2)
    return torch.bincount((flat >> tile_log2).reshape(-1), minlength=n_tiles)


def _positions(keys, lengths, config) -> torch.Tensor:
    return flat_indices(
        cms_positions(keys, lengths, width=config.m, depth=config.k, seed=config.seed), config.m
    )


def cms_update_plain(state, keys, lengths, config, increments=None) -> None:
    """Plain version of the ``cms_update`` kernel: add each valid key's
    increment (``increments``: ``uint32[B]``; None for 1 a key) to its
    ``depth`` counters of ``state`` (``uint32[depth * width]``, any shape),
    mod 2^32, in place."""
    flat = _positions(keys, lengths, config)
    if increments is None:
        inc = torch.ones(lengths.shape, dtype=torch.int64)
    else:
        inc = increments.view(torch.int32).to(torch.int64) & M32
    inc = torch.where(lengths >= 0, inc, 0)
    idx = flat.reshape(-1)
    uidx, inv = torch.unique(idx, return_inverse=True)
    acc = torch.zeros(uidx.shape, dtype=torch.int64)
    acc.index_add_(0, inv, inc[:, None].expand(flat.shape).reshape(-1))
    words = state.view(torch.int32).reshape(-1)
    new = ((words[uidx].to(torch.int64) & M32) + acc) & M32
    words[uidx] = (((new + (1 << 31)) & M32) - (1 << 31)).to(torch.int32)


def cms_estimate_plain(state, keys, lengths, config) -> torch.Tensor:
    """Plain version of the ``cms_estimate`` kernel: each key's minimum
    counter, ``uint32[B]``, 0 on padding. ``state`` is only read."""
    flat = _positions(keys, lengths, config)
    vals = state.view(torch.int32).reshape(-1)[flat].to(torch.int64) & M32
    est = torch.where(lengths >= 0, vals.min(dim=-1).values, 0)
    return (((est + (1 << 31)) & M32) - (1 << 31)).to(torch.int32).view(torch.uint32)
