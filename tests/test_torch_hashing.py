"""The port's hash front-end against tpubloom's: murmur3_32, fnv1a_32 and
block_positions in plain PyTorch (tpubloom_torch.ops) must equal the JAX
functions (tpubloom.ops) bit for bit — tolerance 0 — on the same
numpy-seeded keys, and the published vectors pinned in test_hashing.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_hashing import FNV1A_VECTORS, MURMUR3_VECTORS
from tpubloom.ops import blocked as jblocked
from tpubloom.ops import hashing as jhashing
from tpubloom.utils.packing import pack_keys as jpack_keys
from tpubloom_torch.ops import blocked as tblocked
from tpubloom_torch.ops import hashing as thashing
from tpubloom_torch.utils.packing import pack_keys, pack_keys_dense

L = 16
SEEDS = [0, 0x9747B28C, 0xFFFFFFFF]


def _keys(n=512, seed=3):
    """Keys of every length 0..L (each length appears), numpy-seeded."""
    rng = np.random.default_rng(seed)
    lengths = np.arange(n, dtype=np.int32) % (L + 1)
    keys = rng.integers(0, 256, (n, L), dtype=np.uint8)
    return pack_keys_dense(keys, lengths)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("key,seed,want", MURMUR3_VECTORS)
def test_murmur3_published_vectors(key, seed, want):
    ks, ls = pack_keys([key], 64)
    assert int(thashing.murmur3_32(_t(ks), _t(ls), seed)[0]) == want


@pytest.mark.parametrize("key,want", FNV1A_VECTORS)
def test_fnv1a_published_vectors(key, want):
    ks, ls = pack_keys([key], 64)
    assert int(thashing.fnv1a_32(_t(ks), _t(ls))[0]) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_murmur3_matches_jax(seed):
    ks, ls = _keys()
    want = np.asarray(jhashing.murmur3_32(jnp.asarray(ks), jnp.asarray(ls), seed))
    got = thashing.murmur3_32(_t(ks), _t(ls), seed).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_fnv1a_and_base_hashes_match_jax():
    ks, ls = _keys(seed=4)
    seed = 0x9747B28C
    want = jhashing.base_hashes(jnp.asarray(ks), jnp.asarray(ls), seed)
    got = thashing.base_hashes(_t(ks), _t(ls), seed)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))


@pytest.mark.parametrize("block_hash", ["chunk", "ap"])
@pytest.mark.parametrize("block_bits", [64, 256, 512])
def test_block_positions_match_jax(block_bits, block_hash):
    ks, ls = _keys(seed=5)
    kw = dict(n_blocks=1 << 11, block_bits=block_bits, k=7, seed=0x9747B28C,
              block_hash=block_hash)
    jblk, jbit = jblocked.block_positions(jnp.asarray(ks), jnp.asarray(ls), **kw)
    tblk, tbit = tblocked.block_positions(_t(ks), _t(ls), **kw)
    np.testing.assert_array_equal(tblk.numpy(), np.asarray(jblk).astype(np.int64))
    np.testing.assert_array_equal(tbit.numpy(), np.asarray(jbit).astype(np.int64))


def test_build_masks_match_jax():
    rng = np.random.default_rng(6)
    bit = rng.integers(0, 512, (64, 7)).astype(np.uint32)
    want = np.asarray(jblocked.build_masks(jnp.asarray(bit), 16))
    got = tblocked.build_masks(_t(bit.astype(np.int64)), 16).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_pack_keys_matches_tpubloom():
    rng = np.random.default_rng(7)
    keys = [rng.bytes(int(rng.integers(0, L + 1))) for _ in range(300)]
    for batch in (keys, [k.hex()[:L] for k in keys]):  # bytes fast path, str loop
        got = pack_keys(batch, L)
        want = jpack_keys(batch, L)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    long = [b"x" * 40]
    with pytest.raises(ValueError):
        pack_keys(long, L)
    np.testing.assert_array_equal(
        pack_keys(long, L, key_policy="digest")[0],
        jpack_keys(long, L, key_policy="digest")[0],
    )
