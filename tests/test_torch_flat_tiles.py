"""The partitioned flat counting kernels (``tpubloom_torch/csrc/flat_counting.cu``)
from the CPU: the wrapper's choice of kernel (``sweep.flat_takes_tiles``,
pure Python: positions a state sector against the crossovers, routed
slots by their owned share), the plain partition
(``bitops.flat_tile_counts_plain``) against positions from
``tpubloom``'s numpy oracle, and the plain flat counting update and query
against ``tpubloom``'s ``make_counter_fn`` / ``make_counting_query_fn`` on a
dense batch with a crowd (the shape that takes the partitioned kernels on
the card) and on config 4's own traffic (half the keys deleted, all
queried). The partition's geometry and scratch are set by the kernel
source and read back from it, so they, and the kernels themselves, are
tested on the card (``tests/test_torch_gpu_flat.py``)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpubloom
from tpubloom.cpu_ref import murmur3_32_np, positions_np
from tpubloom.filter import make_counter_fn, make_counting_query_fn
from tpubloom_torch import FilterConfig
from tpubloom_torch.ops import bitops, counting, sweep
from tpubloom_torch.ops.hashing import ShardRoute

L = 16
CONFIG4 = FilterConfig(m=1 << 30, k=7, key_len=L, counting=True)  # BASELINE config 4, flat


def _keys(rng, n, crowd=0):
    keys = rng.integers(0, 256, (n, L), dtype=np.uint8)
    lengths = np.full(n, L, dtype=np.int32)
    keys[:crowd] = keys[0]
    return keys, lengths


@pytest.mark.parametrize("batch,update,query", [
    (0, False, False), (1, False, False), (1 << 16, False, False), (1 << 18, False, False),
    (1 << 19, True, False), (1 << 21, True, False), (1 << 22, True, True),
])
def test_crossover_picks_the_kernel_by_shape(batch, update, query):
    """A delete_batch of 2^16 keys (0.46 M positions on 16.8 M sectors)
    keeps the thread-a-key kernels; the update takes the partitioned
    kernel from 2^19 keys (7 x 2^19 positions, 0.219 a sector), the query
    from 2^22 (1.75 a sector), where it is the faster on config 4's own
    traffic."""
    assert sweep.flat_takes_tiles(CONFIG4, batch, query=False) is update
    assert sweep.flat_takes_tiles(CONFIG4, batch, query=True) is query
    per_sector = batch * 7 / (CONFIG4.n_counter_words / 8)
    assert (batch > 0 and per_sector >= sweep.FLAT_TILE_CROSSOVER) is update
    assert (batch > 0 and per_sector >= sweep.FLAT_TILE_QUERY_CROSSOVER) is query


@pytest.mark.parametrize("log2m", [20, 24, 30])
def test_crossover_scales_with_the_state(log2m):
    """The smallest batch that takes each partitioned kernel is the
    crossover's positions a sector of the state over k: it grows with m."""
    cfg = FilterConfig(m=1 << log2m, k=7, key_len=L, counting=True)
    sectors = cfg.n_counter_words // 8
    for query, crossover in ((False, sweep.FLAT_TILE_CROSSOVER), (True, sweep.FLAT_TILE_QUERY_CROSSOVER)):
        first = math.ceil(crossover * sectors / 7)
        assert sweep.flat_takes_tiles(cfg, first, query=query)
        assert not sweep.flat_takes_tiles(cfg, first - 1, query=query)


@pytest.mark.parametrize("shard_lo,spd", [(0, 64), (48, 16), (16, 16)])
def test_routed_slot_geometry(shard_lo, spd):
    """Configs 4 x 5 flat (2^30 counters over 64 shards): a slot's state is
    its spd shards of 2^21 words each, and its expected positions are its
    owned share of B k, so a slot of a quarter of the shards takes the
    partitioned kernels at the same B as the whole state."""
    cfg = FilterConfig(m=1 << 30, k=7, key_len=L, shards=64, counting=True)
    route = ShardRoute(64, shard_lo, spd)
    assert sweep._state_words(cfg, route) == spd << 21
    for query in (False, True):
        assert sweep.flat_takes_tiles(cfg, 1 << 22, route, query=query)
        assert not sweep.flat_takes_tiles(cfg, 1 << 16, route, query=query)
        assert (sweep.flat_takes_tiles(cfg, 1 << 19, route, query=query)
                == sweep.flat_takes_tiles(CONFIG4, 1 << 19, query=query))


@pytest.mark.parametrize("tile_log2", [3, 6, 14])
def test_tile_counts_match_the_oracle(tile_log2):
    """Entries a tile: each valid key's k positions, padding left out."""
    cfg = FilterConfig(m=1 << 16, k=7, key_len=L, counting=True)
    rng = np.random.default_rng(tile_log2)
    keys, lengths = _keys(rng, 3000, crowd=200)
    lengths[-50:] = -1
    got = bitops.flat_tile_counts_plain(torch.from_numpy(keys), torch.from_numpy(lengths), cfg,
                                          tile_log2)
    pos = positions_np(keys[:-50], lengths[:-50], m=cfg.m, k=cfg.k, seed=cfg.seed)
    want = np.bincount((pos >> np.uint64(tile_log2 + 3)).astype(np.int64).ravel(),
                       minlength=-(-(cfg.m // 8) >> tile_log2))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == 2950 * 7


@pytest.mark.parametrize("shard_lo,spd", [(0, 16), (4, 4), (12, 4)])
def test_routed_tile_counts_land_in_the_keys_shards(shard_lo, spd):
    """A slot's entries: the owned keys' positions at local shard x
    m_per_shard + pos, so each shard's tiles hold exactly its keys'."""
    cfg = FilterConfig(m=1 << 20, k=7, key_len=L, shards=16, counting=True)
    route = ShardRoute(16, shard_lo, spd)
    rng = np.random.default_rng(shard_lo + spd)
    keys, lengths = _keys(rng, 4000)
    tile_log2 = 10  # 1,024 words a tile, 8 a shard of 2^16 counters
    got = bitops.flat_tile_counts_plain(torch.from_numpy(keys), torch.from_numpy(lengths), cfg,
                                          tile_log2, route).numpy()
    assert got.shape == (spd * 8,)
    shard = murmur3_32_np(keys, lengths, cfg.seed ^ 0x517CC1B7) % 16
    pos = positions_np(keys, lengths, m=cfg.m_per_shard, k=cfg.k, seed=cfg.seed)
    for s in range(spd):
        mine = pos[shard == shard_lo + s] >> np.uint64(tile_log2 + 3)
        want = np.bincount(mine.astype(np.int64).ravel(), minlength=8)
        np.testing.assert_array_equal(got[8 * s : 8 * (s + 1)], want)


@pytest.mark.parametrize("k", [1, 7, 16])
def test_plain_counting_matches_tpubloom_on_a_dense_batch(k):
    """m = 2^16 counters, 2^12 keys with a crowd of one key over an eighth
    of them (past saturation) and padding: a batch the card gives the
    partitioned kernels. Insert, delete of half and as many absent keys,
    then the query, against tpubloom's JAX functions."""
    cfg = FilterConfig(m=1 << 16, k=k, key_len=L, counting=True)
    assert sweep.flat_takes_tiles(cfg, 1 << 12, query=False)
    jcfg = tpubloom.FilterConfig(m=1 << 16, k=k, key_len=L, counting=True)
    rng = np.random.default_rng(k)
    keys, lengths = _keys(rng, 1 << 12, crowd=1 << 9)
    lengths[-40:] = -1
    absent, a_len = _keys(rng, 1 << 11)
    delete = (np.concatenate([keys[: 1 << 11], absent]), np.concatenate([lengths[: 1 << 11], a_len]))
    jw = jnp.zeros((cfg.n_counter_words,), jnp.uint32)
    state = torch.zeros(cfg.n_counter_words, dtype=torch.int32).view(torch.uint32)
    for increment, (ks, ls) in ((True, (keys, lengths)), (False, delete), (True, (keys, lengths))):
        jw = make_counter_fn(jcfg, increment=increment)(jw, jnp.asarray(ks), jnp.asarray(ls))
        counting.flat_counting_update_plain(state, torch.from_numpy(ks), torch.from_numpy(ls), cfg,
                                            increment=increment)
        np.testing.assert_array_equal(state.view(torch.int32).numpy().view(np.uint32), np.asarray(jw))
    probe = np.concatenate([keys[1 << 11 :], absent])
    p_len = np.concatenate([lengths[1 << 11 :], a_len])
    got = counting.flat_counting_query_plain(state, torch.from_numpy(probe), torch.from_numpy(p_len),
                                             cfg).numpy()
    want = np.asarray(make_counting_query_fn(jcfg)(jw, jnp.asarray(probe), jnp.asarray(p_len)))
    valid = p_len >= 0
    np.testing.assert_array_equal(got[valid], want[valid])
    assert not got[~valid].any() and got[: (1 << 11) - 40].all()


@pytest.mark.parametrize("k", [1, 7, 16])
def test_plain_query_on_config_4_traffic(k):
    """Config 4's own traffic (benchmarks/run.py config4) at m = 2^16
    counters: insert n keys, delete the first half, query all n with
    padding; the query the partitioned kernel probes (most deleted keys
    stop at a zero counter). Plain update and query against tpubloom's JAX
    functions; the held half is present."""
    cfg = FilterConfig(m=1 << 16, k=k, key_len=L, counting=True)
    jcfg = tpubloom.FilterConfig(m=1 << 16, k=k, key_len=L, counting=True)
    n = 1 << 11
    keys, lengths = _keys(np.random.default_rng(40 + k), n + 64)
    lengths[n:] = -1
    d_len = lengths[: n // 2].copy()
    jw = jnp.zeros((cfg.n_counter_words,), jnp.uint32)
    state = torch.zeros(cfg.n_counter_words, dtype=torch.int32).view(torch.uint32)
    for increment, ks, ls in ((True, keys, lengths), (False, keys[: n // 2], d_len)):
        jw = make_counter_fn(jcfg, increment=increment)(jw, jnp.asarray(ks), jnp.asarray(ls))
        counting.flat_counting_update_plain(state, torch.from_numpy(ks), torch.from_numpy(ls), cfg,
                                            increment=increment)
    np.testing.assert_array_equal(state.view(torch.int32).numpy().view(np.uint32), np.asarray(jw))
    got = counting.flat_counting_query_plain(state, torch.from_numpy(keys), torch.from_numpy(lengths),
                                             cfg).numpy()
    want = np.asarray(make_counting_query_fn(jcfg)(jw, jnp.asarray(keys), jnp.asarray(lengths)))
    np.testing.assert_array_equal(got[:n], want[:n])
    assert got[n // 2 : n].all() and not got[n:].any()
    assert got[: n // 2].sum() < n // 8  # the deleted keys: false positives only
