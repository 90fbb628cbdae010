"""The flat CUDA kernels (``tpubloom_torch/csrc/flat_bloom.cu``) against
their plain PyTorch versions, on the card, at a small size. Marked
``gpu``; each test skips (inside the ``cuda`` fixture, never at import or
collection) where no CUDA device is present. On the card:

    python -m pytest tests/test_torch_gpu_flat.py -m gpu -q --noconftest

All comparisons are exact (tolerance 0): state words and verdicts. The
kernels give a key a thread and no sort, so keys that share a word race:
the contention cases crowd thousands of keys onto eight words, and a
counting batch repeats one key past saturation and deletes past the
floor. Batches are ragged (partial blocks of threads) and padded; keys of
28 bytes take the hash from memory, 16-byte keys from registers; m =
10,000,000 takes the mod walk, m = 2^33 the 64-bit walk's high word. The
routed kernels run on every slot of a 1-slot and a 4-slot placement, so
the ``shard_lo != 0`` branch runs too."""

import numpy as np
import pytest
import torch

from tpubloom_torch import BloomFilter, CountingBloomFilter, FilterConfig, ShardedBloomFilter
from tpubloom_torch.ops import bitops, counting, hashing, sweep
from tpubloom_torch.ops.hashing import ShardRoute

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _batch(rng, n, dev, key_len=16, n_pad=37, crowd=0):
    """n keys of random lengths with within-batch duplicates, ``crowd``
    copies of the first key, and ``n_pad`` padding entries at the tail."""
    keys = rng.integers(0, 256, (n, key_len), dtype=np.uint8)
    lengths = rng.integers(0, key_len + 1, n).astype(np.int32)
    n_pad = min(n_pad, n // 2)
    if n_pad:
        lengths[-n_pad:] = -1
    keys[np.arange(key_len)[None, :] >= np.maximum(lengths, 0)[:, None]] = 0
    dup = min(100, n // 4)
    keys[n // 2 : n // 2 + dup], lengths[n // 2 : n // 2 + dup] = keys[:dup], lengths[:dup]
    if crowd:
        keys[:crowd], lengths[:crowd] = rng.integers(0, 256, key_len, dtype=np.uint8), key_len
    return torch.from_numpy(keys).to(dev), torch.from_numpy(lengths).to(dev)


def _zeros(n, dev):
    return torch.zeros(n, dtype=torch.int32, device=dev).view(torch.uint32)


def _clone(t):
    return t.view(torch.int32).clone().view(torch.uint32)


def _equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _update(state, keys, lengths, cfg, *, increment=True, route=None, plain=False):
    if cfg.counting:
        fn = counting.flat_counting_update_plain if plain else sweep.flat_counting_update
        return fn(state, keys, lengths, cfg, increment=increment, route=route)
    if plain:
        return bitops.flat_insert_plain(state, keys, lengths, cfg, route)
    return sweep.flat_insert(state, keys, lengths, cfg, route=route)


def _query(state, keys, lengths, cfg, *, route=None, plain=False):
    if plain:
        fn = counting.flat_counting_query_plain if cfg.counting else bitops.flat_query_plain
        return fn(state, keys, lengths, cfg, route)
    fn = sweep.flat_counting_query if cfg.counting else sweep.flat_query
    return fn(state, keys, lengths, cfg, route=route)


def _check_steps(state, cfg, batches, probe, route=None):
    """Each batch through the kernel and the plain version from the same
    state (counting: insert, delete, insert in turn); then the query of
    ``probe`` on the kernel's state."""
    for step, (keys, lengths) in enumerate(batches):
        s_p = _clone(state)
        increment = not (cfg.counting and step % 3 == 1)
        _update(state, keys, lengths, cfg, increment=increment, route=route)
        _update(s_p, keys, lengths, cfg, increment=increment, route=route, plain=True)
        torch.cuda.synchronize()
        assert _equal(state, s_p), step
    q_k = _query(state, *probe, cfg, route=route)
    q_p = _query(state, *probe, cfg, route=route, plain=True)
    assert torch.equal(q_k.cpu(), q_p.cpu())
    assert not bool(q_k[probe[1] < 0].any())
    return q_k


@pytest.mark.parametrize("counting_layout", [False, True])
@pytest.mark.parametrize("m,k,key_len", [
    (1 << 22, 7, 16), (10_000_000, 7, 16), (1 << 20, 10, 28), (1 << 16, 64, 16),
])
def test_flat_kernels_match_plain(cuda, counting_layout, m, k, key_len):
    cfg = FilterConfig(m=m, k=k, key_len=key_len, counting=counting_layout)
    rng = np.random.default_rng(m % 1000 + k + counting_layout)
    state = _zeros(sweep._state_words(cfg), cuda)
    sweep.reset_launch_counts()
    batches = [_batch(rng, n, cuda, key_len) for n in (4096 + 13, 1, 33, 2048)]
    probe = _batch(rng, 3000, cuda, key_len)
    probe[0][:1000], probe[1][:1000] = batches[0][0][:1000], batches[0][1][:1000]
    hits = _check_steps(state, cfg, batches, probe)
    assert bool(hits.any())
    name = "flat_counting_update" if counting_layout else "flat_insert"
    query = "flat_counting_query" if counting_layout else "flat_query"
    assert sweep.launch_counts() == {**dict.fromkeys(sweep.LAUNCHES, 0), name: 4, query: 1}


@pytest.mark.parametrize("counting_layout", [False, True])
def test_flat_kernels_crowded_words(cuda, counting_layout):
    """Thousands of keys on eight words: m = 256 bits or 64 counters, a
    batch of distinct keys and one of a single key 3000 times (saturating
    every counter it touches), then deletes past the floor."""
    m = 64 if counting_layout else 256
    cfg = FilterConfig(m=m, k=7, key_len=16, counting=counting_layout)
    rng = np.random.default_rng(8 + counting_layout)
    state = _zeros(8, cuda)
    batches = [_batch(rng, 5000, cuda), _batch(rng, 5000, cuda, crowd=3000),
               _batch(rng, 5000, cuda, crowd=4000), _batch(rng, 700, cuda)]
    _check_steps(state, cfg, batches, _batch(rng, 1000, cuda))
    words = state.view(torch.int32).cpu().numpy().view(np.uint32)
    if counting_layout:
        assert (words != 0).all()
    else:
        assert (words == 0xFFFFFFFF).all()


def test_flat_kernels_64_bit_walk(cuda):
    """m = 2^33 bits (1 GiB): the walk's high word carries into the
    position (and its word index passes 2^27)."""
    cfg = FilterConfig(m=1 << 33, k=5, key_len=16)
    rng = np.random.default_rng(33)
    keys, lengths = _batch(rng, 4096, cuda)
    hi, _ = hashing.positions(keys, lengths.clamp(min=0), m=cfg.m, k=cfg.k, seed=cfg.seed)
    assert bool((hi > 0).any())
    state = _zeros(cfg.n_words, cuda)
    hits = _check_steps(state, cfg, [(keys, lengths), _batch(rng, 2048, cuda)], (keys, lengths))
    assert torch.equal(hits.cpu(), lengths.cpu() >= 0)


@pytest.mark.parametrize("n_slots", [1, 4])
@pytest.mark.parametrize("counting_layout", [False, True])
@pytest.mark.parametrize("m,key_len", [(1 << 22, 16), (9_999_872, 28)])
def test_flat_routed_kernels_match_plain(cuda, n_slots, counting_layout, m, key_len):
    """The routed kernels on each slot's state: old keys, duplicates,
    padding and keys other slots own (which change nothing and answer
    False); m = 9,999,872 over 16 shards takes the mod walk in a shard."""
    cfg = FilterConfig(m=m, k=7, key_len=key_len, shards=16, counting=counting_layout)
    rng = np.random.default_rng(n_slots + 2 * counting_layout + key_len)
    spd = 16 // n_slots
    sweep.reset_launch_counts()
    for i in range(n_slots):
        route = ShardRoute(16, i * spd, spd)
        state = _zeros(sweep._state_words(cfg, route), cuda)
        batches = [_batch(rng, n, cuda, key_len) for n in (4096 + 13, 2048, 3000)]
        probe = _batch(rng, 3000, cuda, key_len)
        probe[0][:1000], probe[1][:1000] = batches[2][0][:1000], batches[2][1][:1000]
        hits = _check_steps(state, cfg, batches, probe, route=route)
        owned, _ = bitops.routed_positions(probe[0], probe[1], cfg, route)
        assert not bool(hits[~owned].any())
        if n_slots > 1:
            assert bool(owned.any()) and not bool(owned.all())
    name = "sharded_flat_counting_update" if counting_layout else "sharded_flat_insert"
    query = "sharded_flat_counting_query" if counting_layout else "sharded_flat_query"
    assert sweep.launch_counts() == {**dict.fromkeys(sweep.LAUNCHES, 0), name: 3 * n_slots,
                                     query: n_slots}


@pytest.mark.parametrize("counting_layout", [False, True])
def test_flat_filters_on_card_match_cpu(cuda, counting_layout):
    """BloomFilter / CountingBloomFilter and the flat ShardedBloomFilter on
    the card (1 and 4 slots) against the same filters on the CPU."""
    cfg = FilterConfig(m=1 << 22, k=7, key_len=16, counting=counting_layout)
    scfg = cfg.replace(shards=16)
    cls = CountingBloomFilter if counting_layout else BloomFilter
    gpu, cpu = cls(cfg), cls(cfg, device="cpu")
    s4, s1 = ShardedBloomFilter(scfg, devices=["cuda"] * 4), ShardedBloomFilter(scfg)
    scpu = ShardedBloomFilter(scfg, devices=["cpu"] * 4)
    assert gpu.words.is_cuda and all(w.is_cuda for w in s4.slot_words + s1.slot_words)
    rng = np.random.default_rng(11 + counting_layout)
    keys = [rng.bytes(int(rng.integers(0, 17))) for _ in range(1500)]
    rows = rng.integers(0, 256, (3000, 16), dtype=np.uint8)
    probe = np.concatenate([rows[:500], rng.integers(0, 256, (500, 16), dtype=np.uint8)])
    sweep.reset_launch_counts()
    for f in (gpu, cpu, s4, s1, scpu):
        f.insert_batch(keys)
        f.insert_packed(rows)
        if counting_layout:
            f.delete_batch(keys[:700])
    for got, want in ((gpu, cpu), (s4, scpu), (s1, scpu)):
        np.testing.assert_array_equal(got.include_packed(probe), want.include_packed(probe))
        np.testing.assert_array_equal(got.include_batch(keys), want.include_batch(keys))
        assert got.to_bytes() == want.to_bytes()
    if not counting_layout:
        assert gpu.to_redis_bitmap() == cpu.to_redis_bitmap()
        assert s4.to_redis_bitmap() == s1.to_redis_bitmap() == scpu.to_redis_bitmap()
        assert gpu.bits_set() == cpu.bits_set()
    launches = sweep.launch_counts()
    name = "flat_counting_update" if counting_layout else "flat_insert"
    assert launches[name] == (3 if counting_layout else 2)
    assert launches[f"sharded_{name}"] == 5 * (3 if counting_layout else 2)


def test_flat_wrappers_reject_bad_tensors(cuda):
    cfg = FilterConfig(m=1 << 20, k=7, key_len=16)
    f = BloomFilter(cfg, cuda)
    keys = torch.zeros((64, 16), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        sweep.flat_query(f.words, keys, torch.zeros(64, dtype=torch.int64, device=cuda), cfg)
    with pytest.raises(ValueError):
        sweep.flat_insert(f.words, keys.cpu(), torch.zeros(64, dtype=torch.int32), cfg)
    with pytest.raises(ValueError):
        sweep.flat_counting_update(f.words, keys, torch.zeros(64, dtype=torch.int32, device=cuda),
                                   cfg, increment=True)
