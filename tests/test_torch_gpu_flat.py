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
the ``shard_lo != 0`` branch runs too.

The flat counting wrappers have two kernels each: the thread-a-key one
and, for a batch whose positions cover enough of the state
(``sweep.flat_takes_tiles``), the partitioned one
(``tpubloom_torch/csrc/flat_counting.cu``), whose source sets and reports
the partition's geometry and scratch. The partitioned cases take
shapes on both sides of the crossover (a dense batch of 2^16 keys on 2^20
counters, a sparse one of 2^10), a ragged m (not a multiple of the 2^17
counters of a tile), a crowd of one key past saturation, tiles shared by
several sweep CTAs (one tile, 14 pieces, counters left unsaturated), a
delete of absent keys, padding, routed slots of 1, 2 and 4, k from 1 to
16, and config 4's own traffic (half the keys deleted, all queried), where
the partitioned query's probe answers most keys; each checks which kernel
ran from the launch counts, and both kernels are also held on the same
shapes through the wrappers' private entries."""

import math

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


def _tiled_calls(cfg, sizes, route=None, query=False):
    """How many of these batch sizes the wrapper gives the partitioned kernel."""
    return sum(sweep._takes_tiles(cfg, n, route, query) for n in sizes)


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
    expect = {name: 4, query: 1,
              f"{name}_tiled": _tiled_calls(cfg, [b[0].shape[0] for b in batches], query=False)}
    if counting_layout:
        expect[f"{query}_tiled"] = _tiled_calls(cfg, [probe[0].shape[0]], query=True)
    assert sweep.launch_counts() == {**dict.fromkeys(sweep.LAUNCHES, 0), **expect}


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
    route = ShardRoute(16, 0, spd)  # every slot has the same geometry
    expect = {name: 3 * n_slots, query: n_slots,
              f"{name}_tiled": n_slots * _tiled_calls(cfg, [4096 + 13, 2048, 3000], route)}
    if counting_layout:
        expect[f"{query}_tiled"] = n_slots * _tiled_calls(cfg, [3000], route, query=True)
    assert sweep.launch_counts() == {**dict.fromkeys(sweep.LAUNCHES, 0), **expect}


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


# -- the partitioned flat counting kernels ----------------------------------------


def _variant(before):
    """Which kernel the last counting call took, from the launch counts."""
    after = sweep.launch_counts()
    tiled = sum(after[n] - before[n] for n in after if n.endswith("_tiled"))
    return "tiled" if tiled else "thread_a_key"


def _planned(cfg, n, route, query):
    return "tiled" if sweep._takes_tiles(cfg, n, route, query) else "thread_a_key"


def _check_counting_ops(state, cfg, ops, probes, route=None):
    """Each ``(keys, lengths, increment)`` of ``ops`` through the kernel and
    the plain version from the same state, then each probe's verdicts;
    each call must take the kernel the wrapper's choice names. The other
    kernel runs each op too, on a copy of the state (and each probe), and
    must give the same words and verdicts. Returns the kernels taken, in
    order."""
    taken = []
    other = _clone(state)
    for keys, lengths, increment in ops:
        s_p = _clone(state)
        before = sweep.launch_counts()
        sweep.flat_counting_update(state, keys, lengths, cfg, increment=increment, route=route)
        taken.append(_variant(before))
        assert taken[-1] == _planned(cfg, keys.shape[0], route, False)
        sweep._flat_counting_update_on(taken[-1] != "tiled", other, keys, lengths, cfg,
                                       increment=increment, route=route)
        counting.flat_counting_update_plain(s_p, keys, lengths, cfg, increment=increment, route=route)
        torch.cuda.synchronize()
        assert _equal(state, s_p), (len(taken), taken[-1])
        assert _equal(other, s_p), (len(taken), "the other kernel")
    for keys, lengths in probes:
        before = sweep.launch_counts()
        q_k = sweep.flat_counting_query(state, keys, lengths, cfg, route=route)
        taken.append(_variant(before))
        assert taken[-1] == _planned(cfg, keys.shape[0], route, True)
        q_o = sweep._flat_counting_query_on(taken[-1] != "tiled", state, keys, lengths, cfg, route=route)
        q_p = counting.flat_counting_query_plain(state, keys, lengths, cfg, route)
        assert torch.equal(q_k.cpu(), q_p.cpu()), taken[-1]
        assert torch.equal(q_o.cpu(), q_p.cpu()), "the other kernel"
        assert not bool(q_k[lengths < 0].any())
    return taken


def _dense_and_sparse(rng, dev, n=1 << 16, n_sparse=16, key_len=16):
    """Updates and probes on both sides of the crossover: a dense insert,
    a delete of half of it and as many absent keys, a crowd of one key
    over half a batch inserted and deleted, a sparse insert and delete."""
    dense = _batch(rng, n, dev, key_len)
    absent = _batch(rng, n // 2, dev, key_len)
    delete = (torch.cat([dense[0][: n // 2], absent[0]]), torch.cat([dense[1][: n // 2], absent[1]]))
    crowd = _batch(rng, n, dev, key_len, crowd=n // 2)
    sparse = _batch(rng, n_sparse, dev, key_len)
    ops = [(*dense, True), (*delete, False), (*crowd, True), (*crowd, False), (*crowd, True),
           (*sparse, True), (*sparse, False)]
    probe = (torch.cat([dense[0][n // 2 :], absent[0]]), torch.cat([dense[1][n // 2 :], absent[1]]))
    return ops, [probe, (probe[0][:n_sparse], probe[1][:n_sparse])]


@pytest.mark.parametrize("k", [1, 3, 7, 16])
def test_flat_counting_partitioned_matches_plain(cuda, k):
    """m = 2^20 counters (8 tiles): 2^16 keys take the partitioned kernels,
    16 keys the thread-a-key ones."""
    cfg = FilterConfig(m=1 << 20, k=k, key_len=16, counting=True)
    rng = np.random.default_rng(100 + k)
    state = _zeros(sweep._state_words(cfg), cuda)
    ops, probes = _dense_and_sparse(rng, cuda)
    taken = _check_counting_ops(state, cfg, ops, probes)
    assert taken == ["tiled"] * 5 + ["thread_a_key"] * 2 + ["tiled", "thread_a_key"]
    assert bool(state.view(torch.int32).any())


def test_flat_counting_partitioned_ragged_m(cuda):
    """m = 10,000,000 counters (the mod walk): 1,250,000 words, 77 tiles,
    the last of 4,816 words; keys of 28 bytes hash from memory."""
    cfg = FilterConfig(m=10_000_000, k=7, key_len=28, counting=True)
    tile_log2, _ = sweep.flat_tile_geometry()
    n_words = sweep._state_words(cfg)
    assert (-(-n_words >> tile_log2), n_words - (76 << tile_log2)) == (77, 4816)
    assert sweep._takes_tiles(cfg, 1 << 16, None, False)
    rng = np.random.default_rng(77)
    state = _zeros(sweep._state_words(cfg), cuda)
    ops, probes = _dense_and_sparse(rng, cuda, key_len=28)
    taken = _check_counting_ops(state, cfg, ops, probes)
    assert taken[0] == "tiled" and taken[-1] == "thread_a_key"


@pytest.mark.parametrize("k", [2, 7])
def test_flat_counting_partitioned_shared_tiles(cuda, k):
    """One tile (m = 2^17 counters) and 2^15 keys: 14 sweep CTAs share it
    (k = 7), each applying its counts with a CAS loop, and most counters
    stay below 15, so a lost update would show; then the same keys
    deleted, down to all-zero words."""
    cfg = FilterConfig(m=1 << 17, k=k, key_len=16, counting=True)
    keys, lengths = _batch(np.random.default_rng(k), 1 << 15, cuda, n_pad=0)
    state = _zeros(sweep._state_words(cfg), cuda)
    ops = [(keys, lengths, True), (keys, lengths, False)]
    assert _check_counting_ops(state, cfg, ops, [(keys, lengths)]) == ["tiled"] * 3
    assert not bool(state.view(torch.int32).any())


@pytest.mark.parametrize("n_slots", [1, 2, 4])
@pytest.mark.parametrize("m,key_len", [(1 << 22, 16), (9_999_872, 28)])
def test_flat_counting_partitioned_routed(cuda, n_slots, m, key_len):
    """The routed partitioned kernels on every slot of 1, 2 and 4 (16
    shards): the tiles run over the slot's shard-major words; keys other
    slots own change nothing and answer False."""
    cfg = FilterConfig(m=m, k=7, key_len=key_len, shards=16, counting=True)
    rng = np.random.default_rng(n_slots + key_len)
    spd = 16 // n_slots
    for i in range(n_slots):
        route = ShardRoute(16, i * spd, spd)
        state = _zeros(sweep._state_words(cfg, route), cuda)
        ops, probes = _dense_and_sparse(rng, cuda, n=1 << 16, n_sparse=1 << 8, key_len=key_len)
        taken = _check_counting_ops(state, cfg, ops, probes, route=route)
        assert taken[0] == "tiled" and taken[-1] == "thread_a_key"


def test_flat_tiled_plan_at_config_4_flat(cuda):
    """The partition flat_counting.cu plans at config 4 flat (m = 2^30
    counters, k = 7, B = 2^22): tiles of 2^14 words, pieces of 2^14
    entries; its scratch, the 8.7 MB count matrix, the scans and two
    buffers of 29.4 M entries of 4 bytes (update) or 8 (query); a routed
    slot plans over its own words; shapes it cannot hold answer -1 and keep
    the thread-a-key kernel."""
    assert sweep.flat_tile_geometry() == (14, 1 << 14)
    cfg = FilterConfig(m=1 << 30, k=7, key_len=16, counting=True)
    assert sweep.flat_tiled_scratch_bytes(cfg, 1 << 22, query=False) == 252_350_480
    assert sweep.flat_tiled_scratch_bytes(cfg, 1 << 22, query=True) == 487_231_504
    scfg = cfg.replace(shards=64)
    quarter = ShardRoute(64, 16, 16)
    assert (sweep.flat_tiled_scratch_bytes(scfg, 1 << 22, quarter, query=False)
            < sweep.flat_tiled_scratch_bytes(scfg, 1 << 22, ShardRoute(64, 0, 64), query=False))
    big = FilterConfig(m=1 << 33, k=7, key_len=16, counting=True)  # 2^16 tiles
    assert sweep.flat_tiled_scratch_bytes(big, 1 << 26, query=False) == -1
    assert sweep.flat_takes_tiles(big, 1 << 26, query=False) and not sweep._takes_tiles(big, 1 << 26, None, False)
    k8 = FilterConfig(m=1 << 30, k=8, key_len=16, counting=True)
    assert sweep.flat_tiled_scratch_bytes(k8, (1 << 28) - 1, query=True) > 0
    assert sweep.flat_tiled_scratch_bytes(k8, 1 << 28, query=True) == -1  # 2^31 entries


@pytest.mark.parametrize("k", [1, 2, 7])
def test_flat_counting_partitioned_config_4_traffic(cuda, k):
    """Config 4's own traffic at m = 2^20 counters: insert n = 2^16 keys,
    delete the first half, query all n with padding, on each kernel held
    through the private entries: the query's probe stops most deleted keys
    at a zero counter; the rest meet one in the sweep, or are false
    positives, as in the plain version."""
    cfg = FilterConfig(m=1 << 20, k=k, key_len=16, counting=True)
    rng = np.random.default_rng(400 + k)
    n = 1 << 16  # distinct 16-byte keys, then 64 of padding
    keys = torch.from_numpy(rng.integers(0, 256, (n + 64, 16), dtype=np.uint8)).to(cuda)
    lengths = torch.full((n + 64,), 16, dtype=torch.int32, device=cuda)
    lengths[n:] = -1
    d_len = lengths[: n // 2].clone()
    for tiled in (True, False):
        state = _zeros(sweep._state_words(cfg), cuda)
        sweep._flat_counting_update_on(tiled, state, keys, lengths, cfg, increment=True)
        sweep._flat_counting_update_on(tiled, state, keys[: n // 2], d_len, cfg, increment=False)
        s_p = _zeros(sweep._state_words(cfg), cuda)
        counting.flat_counting_update_plain(s_p, keys, lengths, cfg, increment=True)
        counting.flat_counting_update_plain(s_p, keys[: n // 2], d_len, cfg, increment=False)
        assert _equal(state, s_p), tiled
        sweep.reset_launch_counts()
        got = sweep._flat_counting_query_on(tiled, state, keys, lengths, cfg)
        assert sweep.launch_counts()["flat_counting_query_tiled"] == int(tiled)
        want = counting.flat_counting_query_plain(state, keys, lengths, cfg)
        assert torch.equal(got.cpu(), want.cpu()), tiled
        assert bool(got[n // 2 : n].all()) and not bool(got[n:].any())
        assert int(got[: n // 2].sum()) < n // 8  # the deleted keys: false positives only


# -- the partitioned flat bit insert and the early-exit bit query --------------------


def _check_insert_ops(state, cfg, batches, route=None):
    """Each batch through the wrapper's insert, which must take the kernel
    its crossover names; the other kernel runs it too, on a copy of the
    state, and the plain version on another: the words of all three must
    be equal after every batch. Returns the kernels taken, in order."""
    taken = []
    other = _clone(state)
    for step, (keys, lengths) in enumerate(batches):
        s_p = _clone(state)
        before = sweep.launch_counts()
        sweep.flat_insert(state, keys, lengths, cfg, route=route)
        taken.append(_variant(before))
        assert taken[-1] == _planned(cfg, keys.shape[0], route, False)
        sweep._flat_insert_on(taken[-1] != "tiled", other, keys, lengths, cfg, route=route)
        bitops.flat_insert_plain(s_p, keys, lengths, cfg, route)
        torch.cuda.synchronize()
        assert _equal(state, s_p), (step, taken[-1])
        assert _equal(other, s_p), (step, "the other kernel")
    return taken


def _check_bit_query(state, cfg, keys, lengths, route=None):
    """The query kernel (and each group size the library times) against
    the plain version; padding and keys the slot does not own answer
    False."""
    got = sweep.flat_query(state, keys, lengths, cfg, route=route)
    want = bitops.flat_query_plain(state, keys, lengths, cfg, route)
    assert torch.equal(got.cpu(), want.cpu())
    owned, _ = bitops.routed_positions(keys, lengths, cfg, route)
    assert not bool(got[~owned].any())
    if route is None:
        fn = sweep._flat_library().tpb_flat_query_group
        for group in (1, 2, 4):
            out = torch.empty(keys.shape[0], dtype=torch.uint8, device=state.device)
            err = fn(state.data_ptr(), keys.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                     keys.shape[0], keys.shape[1], *sweep._flat_args(cfg, None),
                     group, torch.cuda.current_stream().cuda_stream)
            assert err == 0
            assert torch.equal(out.view(torch.bool).cpu(), want.cpu()), group
    return got


@pytest.mark.parametrize("k", [1, 2, 10])
def test_flat_insert_partitioned_matches_plain(cuda, k):
    """m = 2^22 bits (8 tiles): a dense batch of 2^16 keys (duplicates,
    padding) takes the partitioned insert, a batch of 16 keys the
    thread-a-key one; then a crowd of one key over half a batch."""
    cfg = FilterConfig(m=1 << 22, k=k, key_len=16)
    rng = np.random.default_rng(800 + k)
    state = _zeros(cfg.n_words, cuda)
    dense, sparse = _batch(rng, 1 << 16, cuda), _batch(rng, 16, cuda)
    crowd = _batch(rng, 1 << 16, cuda, crowd=1 << 15)
    taken = _check_insert_ops(state, cfg, [dense, sparse, crowd, dense])
    assert taken == ["tiled", "thread_a_key", "tiled", "tiled"]
    probe = (torch.cat([dense[0][: 1 << 15], crowd[0][-(1 << 15):]]),
             torch.cat([dense[1][: 1 << 15], crowd[1][-(1 << 15):]]))
    hits = _check_bit_query(state, cfg, *probe)
    assert bool(hits[: (1 << 15)][probe[1][: 1 << 15] >= 0].all())


@pytest.mark.parametrize("m,n_tiles,last", [(10_000_000, 20, 1204), (1_048_544, 2, 16_383),
                                             (524_384, 2, 3)])
def test_flat_insert_partitioned_ragged_m(cuda, m, n_tiles, last):
    """m = 10,000,000 bits (the mod walk): 312,500 words, 20 tiles, the last
    of 1,204 words. A bit state's words need not be a multiple of 4: m = 32
    x 32,767 bits gives a last tile of 16,383 words with thousands of
    entries (its mask's 16-byte zeroing runs past its words), m = 32 x
    16,387 a last tile of 3 words with a few (ORed into the state one by
    one). Keys of 28 bytes hash from memory."""
    cfg = FilterConfig(m=m, k=7, key_len=28)
    tile_log2, _ = sweep.flat_tile_geometry()
    assert (-(-cfg.n_words >> tile_log2), cfg.n_words - ((n_tiles - 1) << tile_log2)) == (n_tiles, last)
    rng = np.random.default_rng(last)
    state = _zeros(cfg.n_words, cuda)
    batches = [_batch(rng, 1 << 16, cuda, key_len=28), _batch(rng, 50, cuda, key_len=28),
               _batch(rng, (1 << 16) + 77, cuda, key_len=28, crowd=1 << 13)]
    taken = _check_insert_ops(state, cfg, batches)  # the 50 keys: the crossover decides
    assert taken[0] == taken[2] == "tiled"
    _check_bit_query(state, cfg, *_batch(rng, 4000, cuda, key_len=28))


@pytest.mark.parametrize("k", [1, 7])
def test_flat_insert_partitioned_shared_tiles(cuda, k):
    """One tile (m = 2^19 bits) and 2^15 keys: up to 14 sweep CTAs share it,
    each ORing its own mask tile into the state; the fill stays below 1, so a
    lost OR would show. Then a crowd of one key over the whole batch."""
    cfg = FilterConfig(m=1 << 19, k=k, key_len=16)
    rng = np.random.default_rng(1900 + k)
    state = _zeros(cfg.n_words, cuda)
    batches = [_batch(rng, 1 << 15, cuda, n_pad=0), _batch(rng, 1 << 15, cuda, crowd=1 << 15)]
    assert _check_insert_ops(state, cfg, batches) == ["tiled", "tiled"]
    words = state.view(torch.int32).cpu().numpy().view(np.uint32)
    fill = int(np.unpackbits(words.view(np.uint8)).sum()) / cfg.m
    assert 0.0 < fill < 0.5


@pytest.mark.parametrize("n_slots", [1, 2, 4])
@pytest.mark.parametrize("m,key_len", [(1 << 26, 16), (9_999_872, 28)])
def test_flat_insert_partitioned_routed(cuda, n_slots, m, key_len):
    """The routed partitioned insert on every slot of 1, 2 and 4 (16
    shards): the tiles run over the slot's shard-major words; keys other
    slots own set nothing and answer False in the query."""
    cfg = FilterConfig(m=m, k=10, key_len=key_len, shards=16)
    rng = np.random.default_rng(n_slots + key_len + 26)
    spd = 16 // n_slots
    for i in range(n_slots):
        route = ShardRoute(16, i * spd, spd)
        state = _zeros(sweep._state_words(cfg, route), cuda)
        dense = _batch(rng, 1 << 16, cuda, key_len)
        batches = [dense, _batch(rng, 1 << 16, cuda, key_len, crowd=1 << 13),
                   _batch(rng, 16, cuda, key_len)]
        taken = _check_insert_ops(state, cfg, batches, route=route)
        assert taken == ["tiled", "tiled", "thread_a_key"]
        probe = (torch.cat([dense[0][:2000], _batch(rng, 2000, cuda, key_len)[0]]),
                 torch.cat([dense[1][:2000], _batch(rng, 2000, cuda, key_len)[1]]))
        hits = _check_bit_query(state, cfg, *probe, route=route)
        owned, _ = bitops.routed_positions(probe[0], probe[1], cfg, route)
        assert bool(hits[:2000][owned[:2000]].all())
        if n_slots > 1:
            assert bool(owned.any()) and not bool(owned.all())


@pytest.mark.parametrize("k", [1, 2, 3, 10])
@pytest.mark.parametrize("fill", [0.01, 0.6])
def test_flat_query_stops_at_a_zero_bit(cuda, k, fill):
    """The query at a low fill (most absent keys stop at their first read)
    and at config 2's fill of ~0.6 (an absent key reads ~2.5 words), for k
    of one group, of a whole group, of one more, and config 2's 10: held
    keys all present, absent keys and padding as the plain version says,
    false positives included; each group size the library has agrees."""
    cfg = FilterConfig(m=1 << 20, k=k, key_len=16)
    n = int(-math.log(1 - fill) * cfg.m / k)
    rng = np.random.default_rng(int(fill * 100) + k)
    state = _zeros(cfg.n_words, cuda)
    held = torch.from_numpy(rng.integers(0, 256, (n, 16), dtype=np.uint8)).to(cuda)
    full = torch.full((n,), 16, dtype=torch.int32, device=cuda)
    for lo in range(0, n, 1 << 16):
        sweep.flat_insert(state, held[lo : lo + (1 << 16)], full[lo : lo + (1 << 16)], cfg)
    words = state.view(torch.int32).cpu().numpy().view(np.uint32)
    assert abs(int(np.unpackbits(words.view(np.uint8)).sum()) / cfg.m - fill) < 0.01
    b = min(n, 1 << 14)
    absent = torch.from_numpy(rng.integers(0, 256, (b, 16), dtype=np.uint8)).to(cuda)
    probe = torch.cat([held[:b], absent])
    lengths = torch.cat([full[:b], full[:b]])
    lengths[-5:] = -1
    hits = _check_bit_query(state, cfg, probe, lengths)
    assert bool(hits[:b].all()) and not bool(hits[-5:].any())


def test_flat_query_routed_keys_a_slot_does_not_own(cuda):
    """The routed query on 4 slots of a filter filled to ~0.6: each slot
    answers its owned held keys True and every key it does not own False,
    and the OR over the slots equals the unsharded filter's verdicts."""
    cfg = FilterConfig(m=1 << 24, k=10, key_len=16, shards=16)
    rng = np.random.default_rng(416)
    n = int(-math.log(0.4) * cfg.m / 10)
    keys = torch.from_numpy(rng.integers(0, 256, (n, 16), dtype=np.uint8)).to(cuda)
    full = torch.full((n,), 16, dtype=torch.int32, device=cuda)
    probe = torch.cat([keys[:3000], torch.from_numpy(rng.integers(0, 256, (3000, 16),
                                                                  dtype=np.uint8)).to(cuda)])
    p_len = full[:6000].clone()
    p_len[-3:] = -1
    verdict = torch.zeros(6000, dtype=torch.bool, device=cuda)
    for i in range(4):
        route = ShardRoute(16, 4 * i, 4)
        state = _zeros(sweep._state_words(cfg, route), cuda)
        for lo in range(0, n, 1 << 16):
            sweep.flat_insert(state, keys[lo : lo + (1 << 16)], full[lo : lo + (1 << 16)], cfg,
                              route=route)
        verdict |= _check_bit_query(state, cfg, probe, p_len, route=route)
    assert bool(verdict[:3000].all()) and not bool(verdict[-3:].any())
    assert 0 < int(verdict[3000:].sum()) < 300  # false positives at 0.6^10


def test_flat_insert_takes_the_kernel_its_crossover_gives(cuda):
    """BloomFilter at config 2 (m = 2^30 bits): insert_packed of 2^20 keys
    is one partitioned launch; insert_batch of 10 K bytes keys one
    thread-a-key launch. On a 2^24-bit state the first batch at the
    crossover takes the partitioned kernel, the batch one key smaller the
    thread-a-key one."""
    f = BloomFilter(FilterConfig(m=1 << 30, k=10, key_len=16))
    rng = np.random.default_rng(2)
    sweep.reset_launch_counts()
    f.insert_packed(rng.integers(0, 256, (1 << 20, 16), dtype=np.uint8))
    assert sweep.launch_counts() == {**dict.fromkeys(sweep.LAUNCHES, 0), "flat_insert": 1,
                                     "flat_insert_tiled": 1}
    sweep.reset_launch_counts()
    f.insert_batch([rng.bytes(int(n)) for n in rng.integers(0, 17, 10_000)])
    assert sweep.launch_counts() == {**dict.fromkeys(sweep.LAUNCHES, 0), "flat_insert": 1}
    del f
    cfg = FilterConfig(m=1 << 24, k=10, key_len=16)
    first = math.ceil(sweep.FLAT_BIT_TILE_CROSSOVER * (cfg.n_words // 8) / 10)
    state = _zeros(cfg.n_words, cuda)
    batches = [_batch(rng, first, cuda, n_pad=0), _batch(rng, first - 1, cuda, n_pad=0)]
    assert _check_insert_ops(state, cfg, batches) == ["tiled", "thread_a_key"]


def test_flat_bits_plan_at_config_2(cuda):
    """The partition flat_partition.cuh plans for the bit insert at config 2
    (m = 2^30 bits, k = 10, B = 2^20): 2,048 tiles; 512 chunks' count
    matrix, the scans and two buffers of 10.5 M entries of 4 bytes; a state
    of 2^32 bits or more, or more than 2^14 tiles, answers -1 and keeps the
    thread-a-key kernel; 2^31 bits (4,096 tiles) is held."""
    cfg = FilterConfig(m=1 << 30, k=10, key_len=16)
    nbytes = sweep.flat_tiled_scratch_bytes(cfg, 1 << 20, query=False)
    entries = 10 << 20
    assert 8 * entries < nbytes < 8 * entries + 5 * 2**20
    with pytest.raises(ValueError):
        sweep.flat_tiled_scratch_bytes(cfg, 1 << 20, query=True)
    big = FilterConfig(m=1 << 32, k=10, key_len=16)
    assert sweep.flat_tiled_scratch_bytes(big, 1 << 24, query=False) == -1
    assert sweep.flat_takes_tiles(big, 1 << 24, query=False)
    assert not sweep._takes_tiles(big, 1 << 24, None, False)
    assert sweep.flat_tiled_scratch_bytes(FilterConfig(m=1 << 31, k=10, key_len=16),
                                          1 << 24, query=False) > 0
