"""The CUDA kernels against their plain PyTorch versions, on the card, at a
small size. Marked ``gpu``; each test skips (inside the ``cuda`` fixture,
never at import or collection) where no CUDA device is present. On the
card:

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest

All comparisons are exact (tolerance 0): state words and verdicts."""

import numpy as np
import pytest
import torch

from tpubloom_torch import BlockedBloomFilter, FilterConfig
from tpubloom_torch.ops import blocked, sweep

pytestmark = pytest.mark.gpu
L = 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _batch(rng, n, dev, n_pad=37):
    keys = rng.integers(0, 256, (n, L), dtype=np.uint8)
    lengths = rng.integers(0, L + 1, n).astype(np.int32)
    lengths[-n_pad:] = -1
    keys[np.arange(L)[None, :] >= np.maximum(lengths, 0)[:, None]] = 0
    keys[n // 2 : n // 2 + 100] = keys[:100]  # within-batch duplicates
    lengths[n // 2 : n // 2 + 100] = lengths[:100]
    return torch.from_numpy(keys).to(dev), torch.from_numpy(lengths).to(dev)


def _equal_words(a, b):
    return torch.equal(a.view(torch.int32).cpu(), b.view(torch.int32).cpu())


@pytest.mark.parametrize(
    "block_bits,block_hash",
    [(512, "chunk"), (512, "ap"), (128, "chunk"), (1024, "chunk"), (4096, "ap")],
)
def test_kernels_match_plain(cuda, block_bits, block_hash):
    cfg = FilterConfig(m=1 << 22, k=7, key_len=L, block_bits=block_bits, block_hash=block_hash)
    rng = np.random.default_rng(block_bits)
    f = BlockedBloomFilter(cfg, cuda)
    sweep.reset_launch_counts()
    for _ in range(2):
        prev, prev_len = _batch(rng, 4096, cuda)
        sweep.blocked_insert(f.words, prev, prev_len, cfg)
    keys, lengths = _batch(rng, 4096, cuda)
    keys[:500], lengths[:500] = prev[:500], prev_len[:500]  # keys already in
    s_k = f.words.view(torch.int32).clone().view(torch.uint32)
    s_p = f.words.view(torch.int32).clone().view(torch.uint32)
    p_k = sweep.blocked_test_insert(s_k, keys, lengths, cfg)
    p_p = blocked.blocked_test_insert_plain(s_p, keys, lengths, cfg)
    torch.cuda.synchronize()
    assert _equal_words(s_k, s_p)
    assert torch.equal(p_k.cpu(), p_p.cpu())
    q_k = sweep.blocked_query(s_k, keys, lengths, cfg)
    q_p = blocked.blocked_query_plain(s_k, keys, lengths, cfg)
    assert torch.equal(q_k.cpu(), q_p.cpu())
    assert bool(q_k[lengths >= 0].all()) and not bool(q_k[lengths < 0].any())
    assert sweep.launch_counts() == {"blocked_query": 2, "blocked_insert": 3}


def test_filter_on_card_matches_cpu(cuda):
    cfg = FilterConfig(m=1 << 20, k=7, key_len=L, block_bits=512)
    gpu, cpu = BlockedBloomFilter(cfg), BlockedBloomFilter(cfg, device="cpu")
    assert gpu.words.is_cuda
    rng = np.random.default_rng(5)
    for _ in range(3):
        keys = [rng.bytes(int(rng.integers(0, L + 1))) for _ in range(1500)]
        np.testing.assert_array_equal(
            gpu.insert_batch(keys, return_presence=True),
            cpu.insert_batch(keys, return_presence=True),
        )
        rows = rng.integers(0, 256, (3000, L), dtype=np.uint8)
        gpu.insert_packed(rows)
        cpu.insert_packed(rows)
        probe = np.concatenate([rows[:500], rng.integers(0, 256, (500, L), dtype=np.uint8)])
        np.testing.assert_array_equal(gpu.include_packed(probe), cpu.include_packed(probe))
    assert gpu.to_bytes() == cpu.to_bytes()
    assert gpu.bits_set() == cpu.bits_set()


def test_wrapper_rejects_bad_tensors(cuda):
    cfg = FilterConfig(m=1 << 20, k=7, key_len=L, block_bits=512)
    f = BlockedBloomFilter(cfg, cuda)
    keys = torch.zeros((64, L), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        sweep.blocked_query(f.words, keys, torch.zeros(64, dtype=torch.int64, device=cuda), cfg)
    with pytest.raises(ValueError):
        sweep.blocked_query(f.words, keys[:, :6], torch.zeros(64, dtype=torch.int32, device=cuda), cfg)
    with pytest.raises(ValueError):
        sweep.blocked_insert(f.words, keys.cpu(), torch.zeros(64, dtype=torch.int32), cfg)
