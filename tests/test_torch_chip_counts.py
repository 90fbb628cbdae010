"""``chip_smoke.touched``, the helper behind the distinct words and 32-byte
sectors that chip_smoke.py prints for the update kernels, against a
brute-force numpy count (a Python set a key) at a small size."""

import numpy as np
import pytest
import torch

import chip_smoke
from tpubloom_torch.ops import blocked


def _brute(rows, words, w, valid):
    n_words = n_sectors = 0
    for r, ws, ok in zip(rows, words, valid):
        if ok:
            g = {int(r) * w + int(x) for x in ws}
            n_words += len(g)
            n_sectors += len({x // 8 for x in g})  # 8 u32 words a 32-byte sector
    return n_words, n_sectors


@pytest.mark.parametrize("words_per_row", [4, 16, 128])
def test_touched_matches_brute_force(words_per_row):
    rng = np.random.default_rng(words_per_row)
    n, k = 3000, 7
    rows = rng.integers(0, 1 << 20, n)
    words = rng.integers(0, words_per_row, (n, k))
    valid = rng.random(n) < 0.8
    got = chip_smoke.touched(torch.from_numpy(rows), torch.from_numpy(words), words_per_row,
                             torch.from_numpy(valid))
    want_words, want_sectors = _brute(rows, words, words_per_row, valid)
    assert (got["words"], got["sectors"], got["keys"]) == (want_words, want_sectors, int(valid.sum()))
    assert got["sectors_per_key"] <= got["words_per_key"] <= k


def test_touched_at_the_main_path_geometry():
    """block_bits 512 (W = 16), k = 7: ~16 (1 - (15/16)^7) = 5.82 words and
    ~2 (1 - 2^-7) = 1.98 sectors a key, from the filter's own positions."""
    rng = np.random.default_rng(3)
    keys = torch.from_numpy(rng.integers(0, 256, (20000, 16), dtype=np.uint8))
    lengths = torch.full((20000,), 16, dtype=torch.int32)
    blk, pos = blocked.block_positions(keys, lengths, n_blocks=1 << 14, block_bits=512, k=7,
                                       seed=0, block_hash="chunk")
    got = chip_smoke.touched(blk, pos >> 5, 16, lengths >= 0)
    want_words, want_sectors = _brute(blk.numpy(), (pos >> 5).numpy(), 16, np.ones(20000, bool))
    assert (got["words"], got["sectors"]) == (want_words, want_sectors)
    assert abs(got["words_per_key"] - 16 * (1 - (15 / 16) ** 7)) < 0.05
    assert abs(got["sectors_per_key"] - 2 * (1 - 2 ** -7)) < 0.02


@pytest.mark.parametrize("counting_layout", [False, True])
def test_flat_footprint_matches_brute_force(counting_layout):
    """``chip_smoke.flat_footprint``: a flat key's words and sectors summed
    over the keys (one request a position), and the sectors distinct over
    the launch (what the bound counts), padding left out."""
    from tpubloom_torch import FilterConfig
    from tpubloom_torch.ops import bitops

    rng = np.random.default_rng(7 + counting_layout)
    cfg = FilterConfig(m=1 << 16, k=10, key_len=16, counting=counting_layout)
    keys = torch.from_numpy(rng.integers(0, 256, (3000, 16), dtype=np.uint8))
    lengths = torch.full((3000,), 16, dtype=torch.int32)
    lengths[-100:] = -1
    got, widx, valid = chip_smoke.flat_footprint(cfg, keys, lengths)
    _, pos = bitops.routed_positions(keys, lengths, cfg)
    per_word = 8 if counting_layout else 32
    want_words, want_sectors = _brute(np.zeros(3000, np.int64), (pos // per_word).numpy(), 1,
                                      valid.numpy())
    distinct = {int(p) // per_word // 8 for p in pos[valid].reshape(-1)}
    assert (got["words"], got["sectors"], got["keys"]) == (want_words, want_sectors, 2900)
    assert got["distinct_sectors"] == len(distinct)
    assert torch.equal(widx, pos // per_word)


@pytest.mark.parametrize("words", [1, 77, 1 << 12])
def test_bits_set_matches_a_popcount(words):
    """``chip_smoke.bits_set``, the fill of config 2's traffic: the set bits
    of a uint32 state against numpy's bit count."""
    rng = np.random.default_rng(words)
    state = rng.integers(0, 1 << 32, words, dtype=np.uint64).astype(np.uint32)
    got = chip_smoke.bits_set(torch.from_numpy(state.view(np.int32)).view(torch.uint32))
    assert got == int(np.unpackbits(state.view(np.uint8)).sum())


@pytest.mark.parametrize("tiled_ms,want", [
    ((5, 2.5, 2, 1), 1.0), ((1, 4, 2, 2), 2.0), ((5, 4, 3, 9), None), ((1, 2, 3, 4), None),
])
def test_crossover_is_where_the_partitioned_kernel_stays_faster(tiled_ms, want):
    """``chip_smoke.crossover_at``: the smallest positions a sector from
    which the partitioned kernel is the faster at every larger batch
    (thread-a-key 3 ms at each of 0.5, 1, 2, 4 positions a sector)."""
    runs = [{"positions_per_sector": p, "thread_a_key_insert_ms": 3, "tiled_insert_ms": t}
            for p, t in zip((0.5, 1.0, 2.0, 4.0), tiled_ms)]
    assert chip_smoke.crossover_at(runs, "insert") == want


@pytest.mark.parametrize("fill_keys", [0, 300, 3000])
def test_query_reads_stop_at_the_first_zero_bit(fill_keys):
    """``chip_smoke.query_reads``, the reads the early-exit bit query's bound
    counts: each valid key's positions through its first zero bit (all k of
    a held key), against a loop over the keys, and their distinct sectors."""
    from tpubloom_torch import FilterConfig
    from tpubloom_torch.ops import bitops

    rng = np.random.default_rng(fill_keys)
    cfg = FilterConfig(m=1 << 14, k=10, key_len=16)
    state = torch.zeros(cfg.n_words, dtype=torch.int32).view(torch.uint32)
    old = torch.from_numpy(rng.integers(0, 256, (fill_keys, 16), dtype=np.uint8))
    bitops.flat_insert_plain(state, old, torch.full((fill_keys,), 16, dtype=torch.int32), cfg)
    keys = torch.from_numpy(rng.integers(0, 256, (400, 16), dtype=np.uint8))
    keys[:100] = old[:100] if fill_keys >= 100 else keys[:100]
    lengths = torch.full((400,), 16, dtype=torch.int32)
    lengths[-20:] = -1
    got = chip_smoke.query_reads(state, cfg, keys, lengths)
    valid, pos = bitops.routed_positions(keys, lengths, cfg)
    words = state.view(torch.int32).numpy().view(np.uint32)
    n_read, sectors = 0, set()
    for ok, ps in zip(valid.tolist(), pos.tolist()):
        for p in ps if ok else ():
            n_read += 1
            sectors.add(p >> 8)
            if not (int(words[p >> 5]) >> (p & 31)) & 1:
                break
    assert got == {"keys": 380, "positions_read": n_read, "distinct_sectors": len(sectors)}
    if fill_keys == 0:  # an empty filter: every key stops at its first read
        assert n_read == 380
    else:  # the 100 held keys read all k
        assert 1000 + 280 <= n_read < 3800
