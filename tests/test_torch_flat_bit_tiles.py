"""The partitioned flat bit insert (``tpubloom_torch/csrc/flat_bits.cu``) and
the early-exit bit query from the CPU: the wrapper's choice of insert
kernel (``sweep.flat_takes_tiles`` with ``FLAT_BIT_TILE_CROSSOVER``, pure
Python: positions a state sector; routed slots by their owned share; never
a partitioned bit query), the plain partition at 32 bits a word
(``bitops.flat_tile_counts_plain``) against positions from ``tpubloom``'s
numpy oracle, the plain insert against ``tpubloom``'s ``make_insert_fn`` on
a dense batch with a crowd and padding (the shape that takes the
partitioned kernel on the card), and the plain query against
``make_query_fn`` at config 2's fill, scaled down. Everything is made with
numpy from a seed, and every comparison is exact. The kernels themselves
run on the card (``tests/test_torch_gpu_flat.py``)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpubloom
from tpubloom.cpu_ref import murmur3_32_np, positions_np
from tpubloom.filter import make_insert_fn, make_query_fn
from tpubloom_torch import FilterConfig
from tpubloom_torch.ops import bitops, sweep
from tpubloom_torch.ops.hashing import ShardRoute

L = 16
CONFIG2 = FilterConfig(m=1 << 30, k=10, key_len=L)  # BASELINE config 2, flat
SECTORS2 = CONFIG2.n_words // 8


def _keys(rng, n, crowd=0):
    keys = rng.integers(0, 256, (n, L), dtype=np.uint8)
    lengths = np.full(n, L, dtype=np.int32)
    keys[:crowd] = keys[0]
    return keys, lengths


def _u32(state):
    return state.view(torch.int32).numpy().view(np.uint32)


@pytest.mark.parametrize("batch", [0, 1, 10_002, 1 << 13, 1 << 15, 1 << 16, 1 << 17, 1 << 18,
                                   1 << 20])
def test_bit_insert_picks_the_kernel_by_shape(batch):
    """Config 2: the insert takes the partitioned kernel from
    FLAT_BIT_TILE_CROSSOVER positions a state sector; the query never."""
    per_sector = batch * 10 / SECTORS2
    assert sweep.flat_takes_tiles(CONFIG2, batch, query=False) is (
        batch > 0 and per_sector >= sweep.FLAT_BIT_TILE_CROSSOVER)
    assert sweep.flat_takes_tiles(CONFIG2, batch, query=True) is False


@pytest.mark.parametrize("batch,tiled", [(10_002, False), (1 << 20, True)])
def test_config_2_calls_take_their_kernel(batch, tiled):
    """An ``insert_batch`` of 10 K ``bytes`` keys (and two more) keeps the
    thread-a-key kernel; ``insert_packed`` of 2^20 keys takes the
    partitioned one."""
    assert sweep.flat_takes_tiles(CONFIG2, batch, query=False) is tiled


@pytest.mark.parametrize("log2m", [20, 24, 30])
def test_bit_crossover_scales_with_the_state(log2m):
    """The smallest batch that takes the partitioned insert is the
    crossover's positions a sector of the state over k: it grows with m."""
    cfg = FilterConfig(m=1 << log2m, k=10, key_len=L)
    first = math.ceil(sweep.FLAT_BIT_TILE_CROSSOVER * (cfg.n_words // 8) / 10)
    assert sweep.flat_takes_tiles(cfg, first, query=False)
    assert not sweep.flat_takes_tiles(cfg, first - 1, query=False)


@pytest.mark.parametrize("log2m,shard_lo,spd", [(30, 0, 64), (30, 16, 16), (36, 0, 64),
                                                (36, 48, 16)])
def test_routed_bit_slots_by_their_owned_share(log2m, shard_lo, spd):
    """A flat sharded bit filter over 64 shards: a slot's state is its spd
    shards of m / 64 bits, and its expected positions are its owned share of
    B k, so a slot of a quarter of the shards decides as the whole state
    does. Config 5 flat (m = 2^36) at its B = 2^18 stays on the thread-a-key
    kernel; a config-2-sized state (m = 2^30) at 2^20 keys takes the
    partitioned one."""
    cfg = FilterConfig(m=1 << log2m, k=10, key_len=L, shards=64)
    route = ShardRoute(64, shard_lo, spd)
    assert sweep._state_words(cfg, route) == spd * (cfg.m_per_shard // 32)
    whole = FilterConfig(m=1 << log2m, k=10, key_len=L)
    for batch in (1 << 16, 1 << 18, 1 << 20):
        assert (sweep.flat_takes_tiles(cfg, batch, route, query=False)
                == sweep.flat_takes_tiles(whole, batch, query=False))
        assert not sweep.flat_takes_tiles(cfg, batch, route, query=True)
    if log2m == 36:
        assert not sweep.flat_takes_tiles(cfg, 1 << 18, route, query=False)
    else:
        assert sweep.flat_takes_tiles(cfg, 1 << 20, route, query=False)


@pytest.mark.parametrize("tile_log2", [2, 6, 14])
def test_bit_tile_counts_match_the_oracle(tile_log2):
    """Entries a tile of 2^tile_log2 words (2^(tile_log2 + 5) bits): each
    valid key's k positions, padding left out, a crowd counted k times a
    copy."""
    cfg = FilterConfig(m=1 << 18, k=10, key_len=L)
    rng = np.random.default_rng(tile_log2)
    keys, lengths = _keys(rng, 3000, crowd=300)
    lengths[-50:] = -1
    got = bitops.flat_tile_counts_plain(torch.from_numpy(keys), torch.from_numpy(lengths), cfg,
                                        tile_log2)
    pos = positions_np(keys[:-50], lengths[:-50], m=cfg.m, k=cfg.k, seed=cfg.seed)
    want = np.bincount((pos >> np.uint64(tile_log2 + 5)).astype(np.int64).ravel(),
                       minlength=-(-(cfg.m // 32) >> tile_log2))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == 2950 * 10


@pytest.mark.parametrize("shard_lo,spd", [(0, 16), (4, 4), (12, 4)])
def test_routed_bit_tile_counts_land_in_the_keys_shards(shard_lo, spd):
    """A slot's entries: the owned keys' positions at local shard x
    m_per_shard + pos, so each shard's tiles hold exactly its keys'."""
    cfg = FilterConfig(m=1 << 20, k=10, key_len=L, shards=16)
    route = ShardRoute(16, shard_lo, spd)
    rng = np.random.default_rng(shard_lo + spd)
    keys, lengths = _keys(rng, 4000)
    tile_log2 = 8  # 256 words a tile, 8 a shard of 2^16 bits
    got = bitops.flat_tile_counts_plain(torch.from_numpy(keys), torch.from_numpy(lengths), cfg,
                                        tile_log2, route).numpy()
    assert got.shape == (spd * 8,)
    shard = murmur3_32_np(keys, lengths, cfg.seed ^ 0x517CC1B7) % 16
    pos = positions_np(keys, lengths, m=cfg.m_per_shard, k=cfg.k, seed=cfg.seed)
    for s in range(spd):
        mine = pos[shard == shard_lo + s] >> np.uint64(tile_log2 + 5)
        want = np.bincount(mine.astype(np.int64).ravel(), minlength=8)
        np.testing.assert_array_equal(got[8 * s : 8 * (s + 1)], want)


@pytest.mark.parametrize("k", [1, 2, 10])
def test_plain_insert_matches_tpubloom_on_a_dense_batch(k):
    """m = 2^16 bits, 2^13 keys with a crowd of one key over an eighth of
    them and padding: a batch the card gives the partitioned insert. Two
    inserts (the second over the first's words, half its keys old), then
    the query of held and absent keys, against tpubloom's JAX functions."""
    cfg = FilterConfig(m=1 << 16, k=k, key_len=L)
    assert sweep.flat_takes_tiles(cfg, 1 << 13, query=False)
    jcfg = tpubloom.FilterConfig(m=1 << 16, k=k, key_len=L)
    rng = np.random.default_rng(k)
    first, f_len = _keys(rng, 1 << 13, crowd=1 << 10)
    f_len[-40:] = -1
    second, s_len = _keys(rng, 1 << 13)
    second[: 1 << 12] = first[: 1 << 12]
    s_len[-7:] = -1
    jw = jnp.zeros((cfg.n_words,), jnp.uint32)
    state = torch.zeros(cfg.n_words, dtype=torch.int32).view(torch.uint32)
    ins = make_insert_fn(jcfg)
    for ks, ls in ((first, f_len), (second, s_len)):
        jw = ins(jw, jnp.asarray(ks), jnp.asarray(ls))
        bitops.flat_insert_plain(state, torch.from_numpy(ks), torch.from_numpy(ls), cfg)
        np.testing.assert_array_equal(_u32(state), np.asarray(jw))
    probe, p_len = _keys(rng, 1 << 12)
    probe[: 1 << 11] = first[: 1 << 11]
    got = bitops.flat_query_plain(state, torch.from_numpy(probe), torch.from_numpy(p_len),
                                  cfg).numpy()
    want = np.asarray(make_query_fn(jcfg)(jw, jnp.asarray(probe), jnp.asarray(p_len)))
    np.testing.assert_array_equal(got, want)
    assert got[: 1 << 11].all()


def test_plain_query_at_config_2_fill():
    """Config 2's traffic (benchmarks/run.py config2) scaled to m = 2^20: the
    100 M keys a 2^30-bit filter takes become 97,656 here (two launches of
    2^15 keys and a tail of 32,120, padded), a fill of ~0.61; then the
    queries of a held batch and an absent one, half each. The verdicts equal
    tpubloom's over the valid prefix, false positives included."""
    cfg = FilterConfig(m=1 << 20, k=10, key_len=L)
    jcfg = tpubloom.FilterConfig(m=1 << 20, k=10, key_len=L)
    rng = np.random.default_rng(2)
    n, b = 97_656, 1 << 15
    keys = rng.integers(0, 256, (3 * b, L), dtype=np.uint8)
    lengths = np.full(3 * b, L, dtype=np.int32)
    lengths[n:] = -1
    jw = jnp.zeros((cfg.n_words,), jnp.uint32)
    state = torch.zeros(cfg.n_words, dtype=torch.int32).view(torch.uint32)
    ins = make_insert_fn(jcfg)
    for lo in range(0, 3 * b, b):
        ks, ls = keys[lo : lo + b], lengths[lo : lo + b]
        jw = ins(jw, jnp.asarray(ks), jnp.asarray(ls))
        bitops.flat_insert_plain(state, torch.from_numpy(ks), torch.from_numpy(ls), cfg)
    words = _u32(state)
    np.testing.assert_array_equal(words, np.asarray(jw))
    fill = int(np.unpackbits(words.view(np.uint8)).sum()) / cfg.m
    assert abs(fill - (1 - math.exp(-10 * n / cfg.m))) < 0.005  # 1 - e^-0.931 = 0.606
    absent = rng.integers(0, 256, (b, L), dtype=np.uint8)
    qry = make_query_fn(jcfg)
    for probe, p_len, held in ((keys[:b], lengths[:b], True), (absent, np.full(b, L, np.int32), False)):
        p_len = p_len.copy()
        p_len[-9:] = -1
        got = bitops.flat_query_plain(state, torch.from_numpy(probe), torch.from_numpy(p_len),
                                      cfg).numpy()
        want = np.asarray(qry(jw, jnp.asarray(probe), jnp.asarray(p_len)))
        np.testing.assert_array_equal(got[:-9], want[:-9])
        assert not got[-9:].any()
        if held:
            assert got[:-9].all()
        else:  # false positives at fill^k: 0.606^10 = 0.0067
            assert 0 < int(got.sum()) < b // 50
