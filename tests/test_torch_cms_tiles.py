"""The partitioned count-min update (``tpubloom_torch/csrc/cms.cu``
``cms_update_tiled``, on ``csrc/flat_partition.cuh``) from the CPU: the
wrapper's choice of kernel (``sweep.cms_takes_tiles``, pure Python: the
batch's positions against ``CMS_TILE_CROSSOVER``), the plain
row-major partition (``ops.cms.cms_tile_counts_plain``) against positions
from ``tpubloom.ops.cms.cms_positions`` on the JAX CPU backend, with tiles
that straddle two rows and a ragged last tile, and the plain update against
``tpubloom.ops.cms.cms_update`` on a dense Zipf batch with a crowd of one
key, padding and weights that wrap (tolerance 0). The partition's scratch
and the kernels themselves are tested on the card
(``tests/test_torch_gpu_sketch.py``)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpubloom.ops import cms as jcms
from tpubloom_torch import FilterConfig
from tpubloom_torch.ops import cms as pcms
from tpubloom_torch.ops import sweep

L = 16
# the sketch path's grid: CMS.INITBYPROB key 0.000001 0.001
PATH = FilterConfig(m=2_718_304, k=7, kind="cms", key_len=L)


def _first_tiled(cfg) -> int:
    """The smallest batch that takes the partitioned kernel on ``cfg``'s
    grid."""
    return math.ceil(sweep.CMS_TILE_CROSSOVER / cfg.k)


def _batch(rng, n, *, crowd=0, pad=0, zipf=False):
    """``n`` keys of ``L`` bytes (a Zipf(1.1) stream over 4,096 ids with
    ``zipf``), the first ``crowd`` of them one key, then ``pad`` padding
    rows."""
    keys = rng.integers(0, 256, (n, L), dtype=np.uint8)
    if zipf:
        ids = np.minimum(rng.zipf(1.1, n), 4096)
        keys = rng.integers(0, 256, (4097, L), dtype=np.uint8)[ids]
    keys[:crowd] = keys[0]
    lengths = np.full(n + pad, L, dtype=np.int32)
    lengths[n:] = -1
    return np.concatenate([keys, np.zeros((pad, L), np.uint8)]), lengths


@pytest.mark.parametrize("batch,tiled", [(0, False), (1, False), (1 << 12, False),
                                         (1 << 16, False), (1 << 18, True), (1 << 20, True)])
def test_crossover_picks_the_kernel_by_shape(batch, tiled):
    """On the sketch path's grid the weighted increment_batch calls of 2^12
    keys and the top-k batches of 2^16 keep the thread-a-key kernel; from
    2^18 keys (1,835,008 positions, where the partitioned kernel was
    measured the faster) the stream's batches take the partitioned one."""
    assert sweep.cms_takes_tiles(PATH, batch) is tiled
    assert (batch * PATH.k >= sweep.CMS_TILE_CROSSOVER) is tiled


@pytest.mark.parametrize("width", [2_016, 1 << 12, 992 * 32, 271_840, 2_718_304, 1 << 24,
                                   27_182_848])
@pytest.mark.parametrize("depth", [4, 5, 7])
def test_crossover_is_the_same_at_every_width(width, depth):
    """The smallest batch that takes the partitioned kernel is the
    crossover's positions over depth, whatever the width: it was measured
    at one batch on the two grids larger than the L2, 0.77 and 0.077
    positions a sector."""
    cfg = FilterConfig(m=width, k=depth, kind="cms")
    first = _first_tiled(cfg)
    assert sweep.cms_takes_tiles(cfg, first)
    assert not sweep.cms_takes_tiles(cfg, first - 1)
    assert first == _first_tiled(FilterConfig(m=2_016, k=depth, kind="cms"))


@pytest.mark.parametrize("tile_log2", [4, 6, 8])
@pytest.mark.parametrize("width", [992, 4096, 10_016])
def test_tile_counts_match_jax_positions(width, tile_log2):
    """Entries a tile of the row-major grid: each valid key's counter in
    each row at r * width + pos, padding left out. Widths that are not a
    multiple of the tile put tiles across two rows and leave the last tile
    ragged; the counts still sum to the valid keys times depth."""
    depth, seed = 7, width & 0xFFFF
    rng = np.random.default_rng(width + tile_log2)
    keys, lengths = _batch(rng, 3000, crowd=300, pad=50, zipf=True)
    pos = jcms.cms_positions(jnp.asarray(keys), jnp.asarray(lengths), width=width, depth=depth,
                             seed=seed)
    port = pcms.cms_positions(torch.from_numpy(keys), torch.from_numpy(lengths), width=width,
                              depth=depth, seed=seed)
    np.testing.assert_array_equal(port.numpy(), np.asarray(pos))
    valid = lengths >= 0
    got = pcms.cms_tile_counts_plain(port, width, tile_log2, torch.from_numpy(valid)).numpy()
    flat = np.arange(depth, dtype=np.int64)[None, :] * width + np.asarray(pos).astype(np.int64)
    n_tiles = -(-depth * width // (1 << tile_log2))
    want = np.bincount((flat[valid] >> tile_log2).ravel(), minlength=n_tiles)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (n_tiles,) and int(got.sum()) == 3000 * depth
    tile = 1 << tile_log2
    # a tile straddles two rows where a row does not end on a tile's edge
    rows_of = [{int(r) for r in np.nonzero((flat[valid] >> tile_log2) == t)[1]}
               for t in range(n_tiles)]
    assert any(len(r) > 1 for r in rows_of) == (width % tile != 0)
    assert (depth * width % tile != 0) == (depth * width < n_tiles * tile)


@pytest.mark.parametrize("width,depth", [(992, 7), (4096, 4), (10_016, 7)])
def test_plain_update_matches_jax_on_a_dense_zipf_batch(width, depth):
    """A Zipf batch dense enough to take the partitioned kernel on the card,
    with a crowd of one key over a quarter of it, padding, and weights near
    2^32 that wrap the crowd's counters: unit and weighted updates through
    sweep.cms_update on the CPU (cms_update_plain) equal tpubloom's
    scatter-add, word for word."""
    cfg = FilterConfig(m=width, k=depth, kind="cms", key_len=L, seed=7)
    rng = np.random.default_rng(width * depth)
    n = _first_tiled(cfg)
    assert sweep.cms_takes_tiles(cfg, n)
    state = torch.zeros((depth * width,), dtype=torch.int32).view(torch.uint32)
    jwords = jnp.zeros((depth * width,), jnp.uint32)
    for b in range(3):
        keys, lengths = _batch(rng, n, crowd=n // 4, pad=40, zipf=True)
        pos = jcms.cms_positions(jnp.asarray(keys), jnp.asarray(lengths), width=width,
                                 depth=depth, seed=cfg.seed)
        valid = jnp.asarray(lengths >= 0)
        w = rng.integers(0, 1 << 32, keys.shape[0], dtype=np.uint64).astype(np.uint32)
        w[: n // 4] = 0xFFFFFFFF - rng.integers(0, 3, n // 4).astype(np.uint32)
        assert int(w[: n // 4].astype(np.uint64).sum()) >= 1 << 32  # the crowd's counters wrap
        sweep.cms_update(state, torch.from_numpy(keys), torch.from_numpy(lengths), cfg,
                         torch.from_numpy(w.view(np.int32)).view(torch.uint32))
        jwords = jcms.cms_update(jwords, pos, valid, jnp.asarray(w))
        np.testing.assert_array_equal(state.view(torch.int32).numpy().view(np.uint32),
                                      np.asarray(jwords))
        sweep.cms_update(state, torch.from_numpy(keys), torch.from_numpy(lengths), cfg)
        jwords = jcms.cms_update(jwords, pos, valid, jnp.ones(lengths.shape, jnp.uint32))
        np.testing.assert_array_equal(state.view(torch.int32).numpy().view(np.uint32),
                                      np.asarray(jwords))
