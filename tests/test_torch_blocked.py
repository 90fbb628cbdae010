"""The plain versions of the port's two kernels against the TPU kernels
they replace, run in interpret mode — at the shape tests/test_fat_sweep.py
uses (NB=8192, B=8192, block_bits=512, k=7), where tpubloom's choosers
really select the fat kernels:

* tpubloom_torch test-and-insert / insert vs K3 (``_fat_kernel`` through
  ``make_sweep_insert_fn(..., with_presence=True, storage_fat=True)``);
* tpubloom_torch query vs K5 (``_fat_query_kernel`` through
  ``make_sweep_query_fn(..., storage_fat=True)``);
* tpubloom_torch test-and-insert vs K1's narrow presence branch
  (``_kernel`` with ``PRES``, at m=2^22 and B=64, where the fat chooser
  rejects the shape).

All comparisons are exact (tolerance 0): state bytes and verdicts. Each
interpret-mode call costs seconds on the CPU, so each runs once, in a
module-scoped fixture."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpubloom.config import FilterConfig as JConfig
from tpubloom.cpu_ref import CPUBlockedBloomFilter
from tpubloom.ops import sweep as jsweep
from tpubloom_torch.config import FilterConfig
from tpubloom_torch.filter import blocked_device_shape
from tpubloom_torch.ops import blocked, sweep

NB, BB, K, B, L = 8192, 512, 7, 8192, 16
W = BB // 32
JCFG = JConfig(m=NB * BB, k=K, key_len=L, block_bits=BB)
CFG = FilterConfig(m=NB * BB, k=K, key_len=L, block_bits=BB)
FAT = blocked_device_shape(CFG)
N_PRE, N_OLD, N_DUP, N_PAD = 4096, 1024, 512, 100


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _state(words: np.ndarray) -> torch.Tensor:
    return _t(words.reshape(FAT).astype(np.uint32))


@pytest.fixture(scope="module")
def data():
    """A pre-populated state (the numpy oracle) and a test-and-insert
    batch of: keys already in the filter, fresh keys, within-batch
    duplicates of fresh keys, and tail padding."""
    rng = np.random.default_rng(11)
    pre = rng.integers(0, 256, (N_PRE, L), dtype=np.uint8)
    oracle = CPUBlockedBloomFilter(JCFG, use_native=False)
    oracle.insert_batch([bytes(r) for r in pre])
    fresh = rng.integers(0, 256, (B - N_OLD - N_DUP, L), dtype=np.uint8)
    batch = np.concatenate([pre[:N_OLD], fresh, fresh[:N_DUP]])
    lengths = np.full((B,), L, np.int32)
    lengths[B - N_PAD:] = -1
    batch[B - N_PAD:] = 0
    return oracle.words.copy(), batch, lengths


@pytest.fixture(scope="module")
def k3(data):
    """K3 in interpret mode: (state after, presence)."""
    words, batch, lengths = data
    fn = jsweep.make_sweep_insert_fn(
        JCFG, interpret=True, with_presence=True, storage_fat=True
    )
    st, pres = fn(jnp.asarray(words.reshape(FAT)), jnp.asarray(batch), jnp.asarray(lengths))
    return np.asarray(st), np.asarray(pres)


@pytest.fixture(scope="module")
def k5(data, k3):
    """K5 in interpret mode, on K3's output state: a batch of inserted
    keys, fresh keys and tail padding."""
    _, batch, lengths = data
    rng = np.random.default_rng(12)
    q = batch.copy()
    q[B // 2 : B - N_PAD] = rng.integers(0, 256, (B // 2 - N_PAD, L), dtype=np.uint8)
    fn = jsweep.make_sweep_query_fn(JCFG, interpret=True, storage_fat=True)
    hits = fn(jnp.asarray(k3[0]), jnp.asarray(q), jnp.asarray(lengths))
    return q, np.asarray(hits)


def test_fat_kernels_selected_at_this_shape():
    assert jsweep.choose_fat_params(NB, B, W, presence=True) is not None
    assert jsweep.choose_fat_query_params(NB, B, W) is not None


def test_test_insert_matches_k3(data, k3):
    words, batch, lengths = data
    st = _state(words)
    present = blocked.blocked_test_insert_plain(st, _t(batch), _t(lengths), CFG)
    np.testing.assert_array_equal(st.numpy(), k3[0])
    np.testing.assert_array_equal(present.numpy(), k3[1])


def test_presence_contract(data, k3):
    """Keys already present report True, padding False, and each
    within-batch duplicate reports the same pre-batch verdict as its
    first copy."""
    words, batch, lengths = data
    present = sweep.blocked_test_insert(_state(words), _t(batch), _t(lengths), CFG).numpy()
    assert present[:N_OLD].all()
    assert not present[B - N_PAD:].any()
    n = N_DUP - N_PAD  # the copies at the batch's end that padding left
    np.testing.assert_array_equal(present[N_OLD : N_OLD + n], present[B - N_DUP : B - N_PAD])
    # fresh keys are overwhelmingly absent before the batch (fill ~0.4%)
    assert present[N_OLD : B - N_DUP].mean() < 0.01


def test_insert_matches_k3_state_and_oracle(data, k3):
    words, batch, lengths = data
    st = _state(words)
    sweep.blocked_insert(st, _t(batch), _t(lengths), CFG)
    np.testing.assert_array_equal(st.numpy(), k3[0])
    oracle = CPUBlockedBloomFilter(JCFG, use_native=False)
    oracle.words = words.copy()
    oracle.insert_batch([bytes(r) for r in batch[: B - N_PAD]])
    np.testing.assert_array_equal(st.numpy().reshape(NB, W), oracle.words)


def test_replay_reports_all_present(data, k3):
    _, batch, lengths = data
    st = _t(k3[0].copy())
    again = sweep.blocked_test_insert(st, _t(batch), _t(lengths), CFG).numpy()
    assert again[: B - N_PAD].all() and not again[B - N_PAD:].any()
    np.testing.assert_array_equal(st.numpy(), k3[0])  # replay sets nothing new


def test_query_matches_k5(k3, k5):
    q, hits = k5
    lengths = np.full((B,), L, np.int32)
    lengths[B - N_PAD:] = -1
    st = _t(k3[0].copy())
    got = sweep.blocked_query(st, _t(q), _t(lengths), CFG).numpy()
    np.testing.assert_array_equal(got, hits)
    assert got[: B // 2].all() and not got[B - N_PAD:].any()
    np.testing.assert_array_equal(st.numpy(), k3[0])  # the query writes nothing


def test_query_matches_k5_mixed_verdicts():
    """K5 at a fill where fresh keys meet false positives: 64 keys a
    block (NB=512, m=2^18), a query of 2048 keys, a quarter held, the
    rest fresh, and tail padding. The plain query gives K5's verdicts,
    false positives included."""
    nb, bq, n_pad = 512, 2048, 37
    jcfg = JConfig(m=nb * BB, k=K, key_len=L, block_bits=BB)
    cfg = FilterConfig(m=nb * BB, k=K, key_len=L, block_bits=BB)
    assert jsweep.choose_fat_query_params(nb, bq, W) is not None
    rng = np.random.default_rng(14)
    pre = rng.integers(0, 256, (64 * nb, L), dtype=np.uint8)
    oracle = CPUBlockedBloomFilter(jcfg, use_native=False)
    oracle.insert_batch([bytes(r) for r in pre])
    q = np.concatenate([pre[: bq // 4], rng.integers(0, 256, (bq - bq // 4, L), dtype=np.uint8)])
    lengths = np.full((bq,), L, np.int32)
    lengths[bq - n_pad:] = -1
    q[bq - n_pad:] = 0
    fat = blocked_device_shape(cfg)
    fn = jsweep.make_sweep_query_fn(jcfg, interpret=True, storage_fat=True)
    hits = np.asarray(fn(jnp.asarray(oracle.words.reshape(fat)), jnp.asarray(q), jnp.asarray(lengths)))
    st = _t(oracle.words.reshape(fat).copy())
    got = sweep.blocked_query(st, _t(q), _t(lengths), cfg).numpy()
    np.testing.assert_array_equal(got, hits)
    fresh = got[bq // 4 : bq - n_pad]
    assert got[: bq // 4].all() and not got[bq - n_pad:].any()
    assert 0 < fresh.sum() < fresh.size  # false positives among the fresh keys


def test_test_insert_matches_k1_presence_branch():
    """K1's narrow presence branch: at m=2^22 (NB=8192), k=7 and B=64 the
    fat chooser rejects the shape, so ``make_sweep_insert_fn(...,
    with_presence=True)`` runs ``_kernel`` with ``PRES`` on the logical
    ``[NB, W]`` view (tpubloom/ops/sweep.py:2335-2389). The port's
    test-and-insert gives the same state and pre-batch presence, for old
    keys, fresh keys, within-batch duplicates and tail padding."""
    nb, b, n_pad = 8192, 64, 8
    jcfg = JConfig(m=nb * BB, k=K, key_len=L, block_bits=BB)
    cfg = FilterConfig(m=nb * BB, k=K, key_len=L, block_bits=BB)
    assert jsweep.choose_fat_params(nb, b, W, presence=True) is None
    rng = np.random.default_rng(13)
    pre = rng.integers(0, 256, (3000, L), dtype=np.uint8)
    oracle = CPUBlockedBloomFilter(jcfg, use_native=False)
    oracle.insert_batch([bytes(r) for r in pre])
    fresh = rng.integers(0, 256, (32, L), dtype=np.uint8)
    batch = np.concatenate([pre[:16], fresh, fresh[:16]])
    lengths = np.full((b,), L, np.int32)
    lengths[b - n_pad:] = -1
    batch[b - n_pad:] = 0
    fn = jsweep.make_sweep_insert_fn(jcfg, interpret=True, with_presence=True)
    st, pres = fn(jnp.asarray(oracle.words), jnp.asarray(batch), jnp.asarray(lengths))
    state = _t(oracle.words.copy())
    present = sweep.blocked_test_insert(state, _t(batch), _t(lengths), cfg).numpy()
    np.testing.assert_array_equal(state.numpy(), np.asarray(st))
    np.testing.assert_array_equal(present, np.asarray(pres))
    assert present[:16].all() and not present[b - n_pad:].any()
    np.testing.assert_array_equal(present[16:24], present[48:56])  # duplicates: pre-batch state
