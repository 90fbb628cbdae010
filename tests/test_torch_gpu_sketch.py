"""The sketch kernels (``tpubloom_torch/csrc/cuckoo.cu``, ``csrc/cms.cu``)
and the scalable filter on the card, at a small size. Marked ``gpu``; each
test skips (inside the ``cuda`` fixture, never at import or collection)
where no CUDA device is present. On the card:

    python -m pytest tests/test_torch_gpu_sketch.py -m gpu -q --noconftest

All comparisons are exact (tolerance 0), each kernel against its plain
version on a CPU copy of the same state and keys:

* the cuckoo insert, delete and query at 2^6 to 2^16 slots, key widths 8,
  16 and 32, with an overfill (FULL keys and unwound chains), duplicates
  and padded lanes, one launch counted a call;
* the count-min update and estimate at power-of-two and other widths, with
  unit increments, weights near 2^32 that wrap, duplicates and padding;
* ``CuckooFilter``, ``CountMinSketch``, ``TopKSketch`` and
  ``ScalableBloomFilter`` (flat and blocked layers) on the card against the
  same classes on the CPU, and their checkpoints restored on the card."""

import numpy as np
import pytest
import torch

from tpubloom_torch import (
    CountMinSketch, CuckooFilter, FilterConfig, ScalableBloomFilter, TopKSketch,
)
from tpubloom_torch import checkpoint as ck
from tpubloom_torch.ops import sweep

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _batch(rng, n, L=16, pad=0, dup=0):
    lens = rng.integers(1, L + 1, n).astype(np.int32)
    keys = rng.integers(0, 256, (n, L), dtype=np.uint8)
    keys[np.arange(L)[None, :] >= lens[:, None]] = 0
    if dup:
        keys[-dup:] = keys[0]
        lens[-dup:] = lens[0]
    keys = np.concatenate([keys, np.zeros((pad, L), np.uint8)])
    lens = np.concatenate([lens, np.full(pad, -1, np.int32)])
    return torch.from_numpy(keys), torch.from_numpy(lens)


def _zeros(n, dev):
    return torch.zeros(n, dtype=torch.int32, device=dev).view(torch.uint32)


def _same(a, b):
    return torch.equal(a.view(torch.int32).cpu(), b.view(torch.int32).cpu())


def _count(name):
    torch.cuda.synchronize()
    return sweep.launch_counts()[name]


@pytest.mark.parametrize("L", [8, 16, 32])
@pytest.mark.parametrize("log2m,batch,n_batches", [(6, 40, 3), (12, 2560, 2), (16, 30000, 3)])
def test_cuckoo_kernels_equal_plain(cuda, log2m, batch, n_batches, L):
    rng = np.random.default_rng(log2m * 100 + L)
    cfg = FilterConfig(m=1 << log2m, k=2, kind="cuckoo", key_len=L, seed=log2m)
    dev_state, cpu_state = _zeros(cfg.m, cuda), _zeros(cfg.m, "cpu")
    sweep.reset_launch_counts()
    full = kicks_seen = 0
    batches = []
    for b in range(n_batches):
        keys, lens = _batch(rng, batch, L, pad=24, dup=5)
        batches.append((keys, lens))
        ok, kicks = sweep.cuckoo_insert(dev_state, keys.to(cuda), lens.to(cuda), cfg)
        pok, pkicks = sweep.cuckoo_insert(cpu_state, keys, lens, cfg)
        assert _count("cuckoo_insert") == b + 1
        assert _same(dev_state, cpu_state)
        assert torch.equal(ok.cpu(), pok) and torch.equal(kicks.cpu(), pkicks)
        full += int(((lens >= 0) & ~pok).sum())
        kicks_seen += int(pkicks.sum())
        q = sweep.cuckoo_query(dev_state, keys.to(cuda), lens.to(cuda), cfg)
        assert torch.equal(q.cpu(), sweep.cuckoo_query(cpu_state, keys, lens, cfg))
    assert _count("cuckoo_query") == n_batches
    if log2m > 6:
        assert full > 0 and kicks_seen > 0, "the overfill must reject and kick"
    for keys, lens in batches[:1] * 2:
        d = sweep.cuckoo_delete(dev_state, keys.to(cuda), lens.to(cuda), cfg)
        assert torch.equal(d.cpu(), sweep.cuckoo_delete(cpu_state, keys, lens, cfg))
        assert _same(dev_state, cpu_state)
    assert _count("cuckoo_delete") == 2


@pytest.mark.parametrize("prefetch", [True, False])
@pytest.mark.parametrize("log2m,batch", [(6, 40), (12, 2560), (16, 30000)])
def test_cuckoo_walk_variants_equal_plain(cuda, log2m, batch, prefetch):
    """Both second launches of the walk (the warp with its prefetch lanes,
    and one thread alone) against the plain version, an overfill included."""
    rng = np.random.default_rng(log2m)
    cfg = FilterConfig(m=1 << log2m, k=2, kind="cuckoo", seed=log2m)
    dev_state, cpu_state = _zeros(cfg.m, cuda), _zeros(cfg.m, "cpu")
    for _ in range(3):
        keys, lens = _batch(rng, batch, pad=24, dup=5)
        ok, kicks = sweep._cuckoo_walk_on(prefetch, True, dev_state, keys.to(cuda),
                                          lens.to(cuda), cfg)
        pok, pkicks = sweep.cuckoo_insert(cpu_state, keys, lens, cfg)
        assert _same(dev_state, cpu_state)
        assert torch.equal(ok.cpu(), pok) and torch.equal(kicks.cpu(), pkicks)
    d, none = sweep._cuckoo_walk_on(prefetch, False, dev_state, keys.to(cuda), lens.to(cuda), cfg)
    assert none is None
    assert torch.equal(d.cpu(), sweep.cuckoo_delete(cpu_state, keys, lens, cfg))
    assert _same(dev_state, cpu_state)


def test_cuckoo_chase_follows_its_links(cuda):
    n_rows = 1 << 12
    order = torch.randperm(n_rows, generator=torch.Generator().manual_seed(0))
    buf = torch.zeros(n_rows * 4, dtype=torch.int32)
    buf[order * 4] = order.roll(-1).to(torch.int32)
    buf = buf.to(cuda)
    for steps in (1, 100, n_rows + 3):
        assert int(sweep._cuckoo_chase(buf, int(order[0]), steps)[0]) == int(order[steps % n_rows])


@pytest.mark.parametrize("width,depth", [(1 << 12, 4), (992, 7), (2_718_304, 7)])
def test_cms_kernels_equal_plain(cuda, width, depth):
    rng = np.random.default_rng(width)
    cfg = FilterConfig(m=width, k=depth, kind="cms", seed=width & 0xFFFF)
    dev_state, cpu_state = _zeros(width * depth, cuda), _zeros(width * depth, "cpu")
    sweep.reset_launch_counts()
    for b in range(3):
        keys, lens = _batch(rng, 20000, pad=40, dup=500)
        incs = rng.integers(0, 1 << 32, keys.shape[0], dtype=np.uint64).astype(np.uint32)
        incs[:300] = 0xFFFFFFFF - rng.integers(0, 3, 300).astype(np.uint32)
        incs = torch.from_numpy(incs.view(np.int32))  # moved as int32, viewed as uint32
        sweep.cms_update(dev_state, keys.to(cuda), lens.to(cuda), cfg,
                         incs.to(cuda).view(torch.uint32))
        sweep.cms_update(cpu_state, keys, lens, cfg, incs.view(torch.uint32))
        sweep.cms_update(dev_state, keys.to(cuda), lens.to(cuda), cfg)
        sweep.cms_update(cpu_state, keys, lens, cfg)
        assert _same(dev_state, cpu_state)
        est = sweep.cms_estimate(dev_state, keys.to(cuda), lens.to(cuda), cfg)
        assert _same(est, sweep.cms_estimate(cpu_state, keys, lens, cfg))
        assert not est.view(torch.int32)[-40:].any()
    assert _count("cms_update") == 6 and _count("cms_estimate") == 3


def test_kernels_refuse_what_they_cannot_take(cuda):
    cfg = FilterConfig(m=1 << 10, k=2, kind="cuckoo")
    keys, lens = _batch(np.random.default_rng(0), 64)
    buf = _zeros(cfg.m + 4, cuda)
    with pytest.raises(ValueError, match="16-byte"):
        sweep.cuckoo_insert(buf[1 : cfg.m + 1], keys.to(cuda), lens.to(cuda), cfg)
    with pytest.raises(ValueError, match="share a device"):
        sweep.cuckoo_query(buf[: cfg.m], keys, lens, cfg)
    c = FilterConfig(m=64, k=2, kind="cms")
    with pytest.raises(ValueError, match="increments"):
        sweep.cms_update(_zeros(128, cuda), keys.to(cuda), lens.to(cuda), c,
                         torch.ones(64, dtype=torch.int64, device=cuda))


def _keys(rng, n):
    return [rng.bytes(int(rng.integers(1, 17))) for _ in range(n)]


def test_sketch_classes_on_card_equal_cpu(cuda, tmp_path):
    rng = np.random.default_rng(9)
    keys = _keys(rng, 5000)
    cfg = FilterConfig(m=1 << 12, k=2, kind="cuckoo", key_name="cf")
    a, b = CuckooFilter(cfg), CuckooFilter(cfg, "cpu")
    for f in (a, b):
        f.insert_batch(keys)
    np.testing.assert_array_equal(a.take_insert_flags(), b.take_insert_flags())
    np.testing.assert_array_equal(a.delete_batch(keys[:100]), b.delete_batch(keys[:100]))
    np.testing.assert_array_equal(a.include_batch(keys), b.include_batch(keys))
    assert a.stats() == b.stats() and a.words_logical.tolist() == b.words_logical.tolist()
    for kind, cls in (("cms", CountMinSketch), ("topk", TopKSketch)):
        cfg = FilterConfig(m=992, k=5, kind=kind, topk=10 if kind == "topk" else 0, key_name=kind)
        a, b = cls(cfg), cls(cfg, "cpu")
        stream = [keys[int(i) % 400] for i in rng.zipf(1.2, 8000)]
        for f in (a, b):
            f.insert_batch(stream)
        w = [int(x) for x in rng.integers(0, 1 << 32, 64)]
        np.testing.assert_array_equal(a.increment_batch(keys[:64], w),
                                      b.increment_batch(keys[:64], w))
        np.testing.assert_array_equal(a.estimate_batch(keys[:500]), b.estimate_batch(keys[:500]))
        np.testing.assert_array_equal(a.words_logical, b.words_logical)
        assert a.stats() == b.stats()
        if kind == "topk":
            assert a.topk_list() == b.topk_list()
        g = ck.restore_blob(ck.snapshot_blob(a, seq=3)[2])
        assert g.device.type == "cuda"
        np.testing.assert_array_equal(g.words_logical, a.words_logical)
        assert getattr(g, "topk_list", list)() == getattr(a, "topk_list", list)()


@pytest.mark.parametrize("block_bits", [0, 512])
def test_scalable_on_card_equals_cpu(cuda, block_bits, tmp_path):
    base = FilterConfig(m=512, k=1, key_len=16, block_bits=block_bits, key_name="s")
    a = ScalableBloomFilter(1000, 0.01, config=base)
    b = ScalableBloomFilter(1000, 0.01, config=base, device="cpu")
    rng = np.random.default_rng(block_bits)
    keys = _keys(rng, 9000)
    for off in range(0, 9000, 1300):
        a.insert_batch(keys[off : off + 1300])
        b.insert_batch(keys[off : off + 1300])
    assert a.n_layers == b.n_layers == 4
    for x, y in zip(a.layers, b.layers, strict=True):
        np.testing.assert_array_equal(x.words_logical, y.words_logical)
    probe = keys + _keys(rng, 4000)
    np.testing.assert_array_equal(a.include_batch(probe), b.include_batch(probe))
    sink = ck.FileSink(str(tmp_path))
    cp = ck.AsyncCheckpointer(a, sink)
    assert cp.trigger() and cp.close(final_checkpoint=False) and cp.checkpoints_written == 1
    g = ck.restore(base, sink, expect_scalable=True)
    for x, y in zip(g.layers, a.layers, strict=True):
        assert x.words.device.type == "cuda"
        np.testing.assert_array_equal(x.words_logical, y.words_logical)
