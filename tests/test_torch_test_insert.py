"""The port's test-and-insert (``sweep.blocked_test_insert``) against
``tpubloom``'s, and the host side of its fused kernel
(``tpubloom_torch/csrc/blocked_test_insert.cu``).

On the CPU the wrapper takes the plain version, as every port wrapper does
for a CPU tensor. Here it is held, on a hot-row batch (one key over a
quarter of the batch, and hundreds of distinct keys hashed into one row,
beside held keys, fresh keys, within-batch duplicates and tail padding),
against ``tpubloom``'s ``make_blocked_test_insert_fn`` and against the
``PRES`` Pallas kernels in interpret mode: K3 ``_fat_kernel`` through
``make_sweep_insert_fn(..., with_presence=True, storage_fat=True)`` and
K1 ``_kernel``'s narrow presence branch. All exact (tolerance 0): state
bytes and verdicts. Then the fused kernel's partition as the host sees it
(keys a row tile; a tile, and so a row, is never split), the crossover
decision, and the shapes and devices the wrapper refuses. The kernel
itself runs only on the card: ``tests/test_torch_gpu.py``
(``test_test_insert_kernels_match_plain``), a file that does not import
JAX, since the card's machine has none."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpubloom.config import FilterConfig as JConfig
from tpubloom.cpu_ref import CPUBlockedBloomFilter
from tpubloom.filter import make_blocked_test_insert_fn
from tpubloom.ops import blocked as jblocked
from tpubloom.ops import sweep as jsweep
from tpubloom_torch.config import FilterConfig
from tpubloom_torch.filter import blocked_device_shape
from tpubloom_torch.ops import blocked, sweep

K, L, BB = 7, 16, 512
W = BB // 32
TILE_LOG2 = 14  # csrc/flat_partition.cuh kTileLog2: 64 KiB of state a tile


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _configs(nb, block_hash="chunk", block_bits=BB):
    kw = {"m": nb * block_bits, "k": K, "key_len": L, "block_bits": block_bits,
          "block_hash": block_hash}
    return JConfig(**kw), FilterConfig(**kw)


def _hot_batch(cfg, b, seed, *, n_pad=29):
    """A pre-populated state and a hot-row batch of ``b`` keys: an eighth
    held, a quarter one repeated key, a crowd of distinct keys that all
    hash into one row, the rest fresh with within-batch duplicates, and
    tail padding. Returns ``(words, batch, lengths, hot_at, crowd_row)``:
    ``hot_at`` is the index of one copy of the repeated key."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, 256, (cfg.n_blocks * 2, L), dtype=np.uint8)
    oracle = CPUBlockedBloomFilter(JConfig(**{f: getattr(cfg, f) for f in (
        "m", "k", "key_len", "block_bits", "block_hash")}), use_native=False)
    oracle.insert_batch([bytes(r) for r in pre])
    batch = rng.integers(0, 256, (b, L), dtype=np.uint8)
    lengths = np.full((b,), L, np.int32)
    batch[: b // 8] = pre[: b // 8]
    # a crowd: distinct keys of one row, picked from a pool by their hash
    pool = rng.integers(0, 256, (1 << 16, L), dtype=np.uint8)
    blk, _ = blocked.block_positions(_t(pool), _t(np.full((1 << 16,), L, np.int32)),
                                     n_blocks=cfg.n_blocks, block_bits=cfg.block_bits, k=K,
                                     seed=cfg.seed, block_hash=cfg.block_hash)
    blk = blk.numpy()
    crowd_row = int(np.bincount(blk).argmax())
    crowd = pool[blk == crowd_row][: b // 8]
    batch[b // 8 : b // 8 + len(crowd)] = crowd
    hot = rng.choice(np.arange(b // 2, b - n_pad), b // 4, replace=False)
    batch[hot] = batch[b // 8 + len(crowd)]
    batch[b // 2 - 40 : b // 2] = batch[b // 8 + len(crowd) + 1 : b // 8 + len(crowd) + 41]
    lengths[b - n_pad:] = -1
    batch[b - n_pad:] = 0
    return oracle.words.copy(), batch, lengths, int(hot[0]), crowd_row


def _rows(cfg, batch, lengths) -> np.ndarray:
    blk, _ = blocked.block_positions(_t(batch), _t(np.maximum(lengths, 0)), n_blocks=cfg.n_blocks,
                                     block_bits=cfg.block_bits, k=K, seed=cfg.seed,
                                     block_hash=cfg.block_hash)
    return blk.numpy()


@pytest.mark.parametrize("block_hash", ["chunk", "ap"])
def test_cpu_test_insert_matches_tpubloom_on_hot_row_batch(block_hash):
    """The wrapper's CPU path (the plain version) against
    ``make_blocked_test_insert_fn`` on a hot-row batch: the same state
    and pre-batch presence."""
    jcfg, cfg = _configs(1024, block_hash)
    words, batch, lengths, _, _ = _hot_batch(cfg, 2048, 21)
    st, pres = make_blocked_test_insert_fn(jcfg)(jnp.asarray(words), jnp.asarray(batch),
                                                 jnp.asarray(lengths))
    state = _t(words.copy().view(np.uint32))
    present = sweep.blocked_test_insert(state, _t(batch), _t(lengths), cfg).numpy()
    np.testing.assert_array_equal(state.numpy(), np.asarray(st))
    np.testing.assert_array_equal(present, np.asarray(pres))
    assert present[: 2048 // 8].all() and not present[-29:].any()


@pytest.fixture(scope="module")
def k3_hot():
    """K3 with PRES in interpret mode on a hot-row batch (NB=1024,
    B=2048, where the fat chooser takes the shape)."""
    jcfg, cfg = _configs(1024)
    assert jsweep.choose_fat_params(1024, 2048, W, presence=True) is not None
    words, batch, lengths, hot_at, crowd_row = _hot_batch(cfg, 2048, 22)
    fat = blocked_device_shape(cfg)
    fn = jsweep.make_sweep_insert_fn(jcfg, interpret=True, with_presence=True, storage_fat=True)
    st, pres = fn(jnp.asarray(words.reshape(fat)), jnp.asarray(batch), jnp.asarray(lengths))
    return cfg, words, batch, lengths, np.asarray(st), np.asarray(pres), hot_at, crowd_row


def test_cpu_test_insert_matches_k3_presence_on_hot_row_batch(k3_hot):
    cfg, words, batch, lengths, st, pres, _, _ = k3_hot
    state = _t(words.reshape(blocked_device_shape(cfg)).view(np.uint32).copy())
    present = sweep.blocked_test_insert(state, _t(batch), _t(lengths), cfg).numpy()
    np.testing.assert_array_equal(state.numpy(), st)
    np.testing.assert_array_equal(present, pres)


def test_hot_row_copies_all_report_the_pre_batch_state(k3_hot):
    """Every copy of the hot key, and every key of the crowded row, reports
    its membership before the batch, as K3 does."""
    cfg, words, batch, lengths, _, pres, hot_at, crowd_row = k3_hot
    state = _t(words.view(np.uint32).copy())
    present = sweep.blocked_test_insert(state, _t(batch), _t(lengths), cfg).numpy()
    hot = np.flatnonzero((batch == batch[hot_at]).all(axis=1) & (lengths >= 0))
    assert len(hot) > 2048 // 4 and len(set(present[hot])) == 1
    np.testing.assert_array_equal(present[hot], pres[hot])
    crowd = np.flatnonzero((_rows(cfg, batch, lengths) == crowd_row) & (lengths >= 0))
    assert len(crowd) >= 40
    np.testing.assert_array_equal(present[crowd], pres[crowd])


def test_cpu_test_insert_matches_k1_presence_on_hot_batch():
    """K1's narrow presence branch (``_kernel`` with PRES: at NB=8192 and
    B=64 the fat chooser rejects the shape) on a batch whose quarter is
    one key."""
    nb, b = 8192, 64
    jcfg, cfg = _configs(nb)
    assert jsweep.choose_fat_params(nb, b, W, presence=True) is None
    rng = np.random.default_rng(23)
    pre = rng.integers(0, 256, (3000, L), dtype=np.uint8)
    oracle = CPUBlockedBloomFilter(jcfg, use_native=False)
    oracle.insert_batch([bytes(r) for r in pre])
    batch = np.concatenate([pre[:8], rng.integers(0, 256, (b - 8, L), dtype=np.uint8)])
    batch[[20, 27, 31, 40, 44, 47, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59]] = pre[3]
    lengths = np.full((b,), L, np.int32)
    lengths[-4:] = -1
    batch[-4:] = 0
    fn = jsweep.make_sweep_insert_fn(jcfg, interpret=True, with_presence=True)
    st, pres = fn(jnp.asarray(oracle.words), jnp.asarray(batch), jnp.asarray(lengths))
    state = _t(oracle.words.copy())
    present = sweep.blocked_test_insert(state, _t(batch), _t(lengths), cfg).numpy()
    np.testing.assert_array_equal(state.numpy(), np.asarray(st))
    np.testing.assert_array_equal(present, np.asarray(pres))
    assert present[[20, 27, 31, 40, 44, 47]].all() and not present[-4:].any()


# -- the fused kernel's partition, as the host sees it ----------------------------


@pytest.mark.parametrize("block_bits", [128, 512, 4096])
@pytest.mark.parametrize("tile_log2", [TILE_LOG2, 9])
def test_tile_counts_plain_match_tpubloom_rows(block_bits, tile_log2):
    """Keys a row tile: each valid key once, in the tile of the row
    ``tpubloom``'s blocked spec gives it; padding in none."""
    _, cfg = _configs(1 << 13, block_bits=block_bits)
    rng = np.random.default_rng(block_bits + tile_log2)
    batch = rng.integers(0, 256, (5000, L), dtype=np.uint8)
    lengths = rng.integers(0, L + 1, 5000).astype(np.int32)
    lengths[-17:] = -1
    batch[np.arange(L)[None, :] >= np.maximum(lengths, 0)[:, None]] = 0
    jblk, _ = jblocked.block_positions(jnp.asarray(batch), jnp.asarray(np.maximum(lengths, 0)),
                                       n_blocks=cfg.n_blocks, block_bits=block_bits, k=K,
                                       seed=cfg.seed, block_hash=cfg.block_hash)
    rows_per_tile = (1 << tile_log2) // (block_bits // 32)
    want = np.bincount(np.asarray(jblk)[lengths >= 0] // rows_per_tile,
                       minlength=-(-cfg.n_blocks // rows_per_tile))
    got = blocked.test_insert_tile_counts_plain(_t(batch), _t(lengths), cfg, tile_log2).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() == (lengths >= 0).sum()


@pytest.mark.parametrize("block_bits", [128, 256, 512, 1024, 2048, 4096])
def test_tiles_hold_whole_rows(block_bits):
    """A tile is whole rows (its 2^14 words divide by the row's W), and one
    CTA sweeps a tile, so every key of a row, however hot, is one CTA's:
    the keys of the hot row and of the crowded row all count in the tile
    of their row."""
    w = block_bits // 32
    assert (1 << TILE_LOG2) % w == 0
    _, cfg = _configs(2048 if block_bits <= 512 else 512, block_bits=block_bits)
    _, batch, lengths, hot_at, crowd_row = _hot_batch(cfg, 2048, block_bits)
    counts = blocked.test_insert_tile_counts_plain(_t(batch), _t(lengths), cfg, TILE_LOG2)
    rows_per_tile = (1 << TILE_LOG2) // w
    rows = _rows(cfg, batch, lengths)
    blk = rows[lengths >= 0]
    for row in (rows[hot_at], crowd_row):
        assert counts[row // rows_per_tile] >= (blk == row).sum() >= 40
    assert counts.sum() == len(blk)


# -- the crossover decision --------------------------------------------------------


@pytest.mark.parametrize("per_row", [0.0, 0.01, 0.12, 0.125, 0.5, 1.0, 4.0])
def test_crossover_decision(per_row, monkeypatch):
    """The fused kernel from BLOCKED_TEST_INSERT_CROSSOVER keys a row of the
    filter; never for an empty batch."""
    _, cfg = _configs(1 << 23)
    batch = int(per_row * cfg.n_blocks)
    want = batch > 0 and batch >= sweep.BLOCKED_TEST_INSERT_CROSSOVER * cfg.n_blocks
    assert sweep.blocked_test_insert_fused(cfg, batch) == want
    monkeypatch.setattr(sweep, "BLOCKED_TEST_INSERT_CROSSOVER", 0.125)
    assert sweep.blocked_test_insert_fused(cfg, batch) == (batch > 0 and per_row >= 0.125)


def test_cpu_tensors_never_launch():
    """On the CPU the wrapper takes the plain version whatever the batch:
    no launch is counted, the fused kernel's included."""
    _, cfg = _configs(64)
    sweep.reset_launch_counts()
    state = torch.zeros(64 * W, dtype=torch.int32).view(torch.uint32)
    keys = torch.zeros((4096, L), dtype=torch.uint8)
    keys[:, 0] = torch.arange(4096) % 256
    keys[:, 1] = torch.arange(4096) // 256
    lengths = torch.full((4096,), L, dtype=torch.int32)
    assert sweep.blocked_test_insert_fused(cfg, 4096)
    present = sweep.blocked_test_insert(state, keys, lengths, cfg)
    assert present.dtype == torch.bool and not present.any()
    assert not any(sweep.launch_counts().values())


# -- what the wrapper refuses ------------------------------------------------------


def _args(cfg, n=8):
    return (torch.zeros(cfg.n_blocks * cfg.words_per_block, dtype=torch.int32).view(torch.uint32),
            torch.zeros((n, L), dtype=torch.uint8), torch.full((n,), L, dtype=torch.int32))


@pytest.mark.parametrize("case", ["meta_device", "mixed_devices", "state_dtype", "state_words",
                                  "keys_dtype", "keys_width", "lengths_shape", "flat_config",
                                  "counting_config"])
def test_wrapper_refuses(case):
    _, cfg = _configs(64)
    state, keys, lengths = _args(cfg)
    err = ValueError
    if case == "meta_device":
        state, keys, lengths = (t.to("meta") for t in (state, keys, lengths))
    elif case == "mixed_devices":
        keys = keys.to("meta")
    elif case == "state_dtype":
        state, err = state.view(torch.int32), TypeError
    elif case == "state_words":
        state = state[:-4]
    elif case == "keys_dtype":
        keys = keys.to(torch.int32)
    elif case == "keys_width":
        keys = torch.zeros((8, 6), dtype=torch.uint8)
    elif case == "lengths_shape":
        lengths = lengths[:-1]
    elif case == "flat_config":
        cfg = FilterConfig(m=64 * BB, k=K, key_len=L)
        state = torch.zeros(cfg.n_words, dtype=torch.int32).view(torch.uint32)
    elif case == "counting_config":
        cfg = FilterConfig(m=64 * BB // 4, k=K, key_len=L, block_bits=BB, counting=True)
    with pytest.raises(err):
        sweep.blocked_test_insert(state, keys, lengths, cfg)
