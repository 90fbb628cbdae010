"""The port's two sketch queries, ``sweep.cms_estimate`` and
``sweep.cuckoo_query`` (on the CPU: the plain versions their CUDA kernels
are held against on the card), against ``tpubloom.ops.cms.cms_estimate``
and ``tpubloom.ops.cuckoo.cuckoo_query``, at the edge shapes of the card
tests in ``tests/test_torch_gpu_sketch.py``:

* the count-min estimate at depths 1, 9 and 64, a power-of-two width and
  mod-walk widths, key widths 8, 28 and 32, on a grid with counters at
  2^32 - 1 (some keys' every counter);
* the cuckoo query at key widths 8, 16, 28 and 32 on a table holding half
  the keys, at one key and at a full batch;
* padding rows whose key bytes are nonzero, which answer 0 / False.

Inputs come from numpy with a seed; every comparison is exact (tolerance
0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpubloom.ops import cms as jcms
from tpubloom.ops import cuckoo as jcuckoo
from tpubloom_torch import FilterConfig
from tpubloom_torch.ops import sweep

M32 = 0xFFFFFFFF


def _keys(rng, n, L, every=5):
    """``uint8[n, L]`` keys zero past random lengths; every ``every``-th
    row padding (length -1) with nonzero key bytes."""
    lens = rng.integers(0, L + 1, n).astype(np.int32)
    keys = rng.integers(0, 256, (n, L), dtype=np.uint8)
    keys[np.arange(L)[None, :] >= lens[:, None]] = 0
    keys[::every] = rng.integers(1, 256, (keys[::every].shape[0], L), dtype=np.uint8)
    lens[::every] = -1
    return keys, lens


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32).numpy().view(np.uint32)


@pytest.mark.parametrize("L", [8, 28, 32])
@pytest.mark.parametrize("width,depth", [(1 << 12, 1), (992, 9), (10_016, 64)])
def test_cms_estimate_matches_jax(width, depth, L):
    rng = np.random.default_rng(width + depth + L)
    seed = depth * 31 + L
    grid = rng.integers(0, 1 << 32, width * depth, dtype=np.uint64).astype(np.uint32)
    grid[rng.random(grid.size) < (0.99 if depth == 9 else 0.3)] = M32
    keys, lens = _keys(rng, 3001, L)
    cfg = FilterConfig(m=width, k=depth, kind="cms", key_len=L, seed=seed)
    est = sweep.cms_estimate(torch.from_numpy(grid.view(np.int32)).view(torch.uint32),
                             torch.from_numpy(keys), torch.from_numpy(lens), cfg)
    pos = jcms.cms_positions(jnp.asarray(keys), jnp.asarray(lens), width=width, depth=depth,
                             seed=seed)
    want = np.asarray(jcms.cms_estimate(jnp.asarray(grid), pos, jnp.asarray(lens >= 0)))
    np.testing.assert_array_equal(_u32(est), want)
    assert not want[::5].any()
    if depth == 9:
        assert (want == M32).any(), "some keys' every counter at 2^32 - 1"


@pytest.mark.parametrize("L", [8, 16, 28, 32])
@pytest.mark.parametrize("n", [1, 4099])
def test_cuckoo_query_matches_jax(L, n):
    rng = np.random.default_rng(L * 10 + n)
    cfg = FilterConfig(m=1 << 14, k=2, kind="cuckoo", key_len=L, seed=L + 3)
    keys, lens = _keys(rng, 4100, L)
    state = torch.zeros(cfg.m, dtype=torch.int32).view(torch.uint32)
    ok, _ = sweep.cuckoo_insert(state, torch.from_numpy(keys[::2].copy()),
                                torch.from_numpy(lens[::2].copy()), cfg)
    keys, lens = keys[1 : 1 + n], lens[1 : 1 + n]
    got = sweep.cuckoo_query(state, torch.from_numpy(keys), torch.from_numpy(lens), cfg)
    n_buckets = cfg.m // 4
    fp, i1 = jcuckoo.derive(jnp.asarray(keys), jnp.asarray(lens), n_buckets=n_buckets, seed=cfg.seed)
    slots = jnp.asarray(_u32(state).reshape(n_buckets, 4))
    want = np.asarray(jcuckoo.cuckoo_query(slots, fp, i1, jnp.asarray(lens >= 0)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want[4::5].any()
    if n > 1:  # every key stored (rows 2, 4, ... of the table's batch) is found
        assert want[1::2][ok.numpy()[1 : 1 + len(want[1::2])]].all()
