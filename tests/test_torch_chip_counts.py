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
