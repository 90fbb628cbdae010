"""The CUDA kernels against their plain PyTorch versions, on the card, at a
small size. Marked ``gpu``; each test skips (inside the ``cuda`` fixture,
never at import or collection) where no CUDA device is present. On the
card:

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest

All comparisons are exact (tolerance 0): state words and verdicts. The
routed (sharded) kernels run on one slot's state, for every slot of a
1-slot and a 4-slot placement, so the ``shard_lo != 0`` branch runs too.

The update kernels (insert, counting update) walk each warp's work list
with a group of lanes a key: block_bits 128 to 1024 take the staged path
(W = block_bits / 32 lanes a key for the insert, W / 4 for the counting
update's 16-byte CAS), 2048 and 4096 the wide path. Ragged
batches leave partial warps and partial groups; the contention cases
crowd thousands of keys into eight blocks; the mostly-unowned cases give
a routed slot a batch of which it owns a few keys.

The query kernel gathers each key's row with W / 4 lanes (block_bits 128
to 1024; 2048 and 4096 take the chunk kernel); its routed twin first
compacts the keys its slot owns when the slot owns only some shards. Its
cases fill the filter to 32 keys a block or more, so that fresh keys meet
false positives and the verdicts are mixed."""

import numpy as np
import pytest
import torch

from tpubloom_torch import (
    BlockedBloomFilter, BlockedCountingBloomFilter, FilterConfig, ShardedBloomFilter,
)
from tpubloom_torch.ops import blocked, counting, hashing, sweep
from tpubloom_torch.ops.hashing import ShardRoute

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


_NO_LAUNCH = dict.fromkeys(sweep.LAUNCHES, 0)


@pytest.mark.parametrize(
    "block_bits,block_hash",
    [(512, "chunk"), (512, "ap"), (128, "chunk"), (256, "chunk"), (1024, "chunk"),
     (2048, "chunk"), (4096, "ap")],
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
    assert sweep.launch_counts() == {**_NO_LAUNCH, "blocked_query": 2, "blocked_insert": 3}


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


def _clone(t):
    return t.view(torch.int32).clone().view(torch.uint32)


@pytest.mark.parametrize(
    "block_bits,block_hash",
    [(512, "chunk"), (512, "ap"), (128, "chunk"), (256, "ap"), (1024, "chunk"),
     (2048, "chunk"), (4096, "ap")],
)
@pytest.mark.parametrize("view", ["storage", "logical"])
def test_counting_kernels_match_plain(cuda, block_bits, block_hash, view):
    """Insert, delete and query through the counting kernels and their
    plain versions from the same state: old keys, within-batch
    duplicates, a quarter of the batch one key (its counters saturate at
    15, then floor at 0) and padding; the state as the filter's storage or
    as its logical [NB, W] view."""
    cfg = FilterConfig(m=1 << 22, k=7, key_len=L, counting=True, block_bits=block_bits,
                       block_hash=block_hash)
    rng = np.random.default_rng(block_bits + len(view))
    f = BlockedCountingBloomFilter(cfg, cuda)
    state = f.words if view == "storage" else f.words.view(cfg.n_blocks, cfg.words_per_block)
    sweep.reset_launch_counts()
    for _ in range(2):
        prev, prev_len = _batch(rng, 4096, cuda)
        sweep.blocked_counting_update(state, prev, prev_len, cfg, increment=True)
    keys, lengths = _batch(rng, 4096, cuda)
    keys[:500], lengths[:500] = prev[:500], prev_len[:500]  # keys already in
    keys[1000:2024], lengths[1000:2024] = keys[1000].clone(), L  # one hot key
    s_k, s_p = _clone(state), _clone(state)
    for increment in (True, False):
        sweep.blocked_counting_update(s_k, keys, lengths, cfg, increment=increment)
        counting.blocked_counting_update_plain(s_p, keys, lengths, cfg, increment=increment)
        torch.cuda.synchronize()
        assert _equal_words(s_k, s_p)
        if increment:
            q_k = sweep.blocked_counting_query(s_k, keys, lengths, cfg)
            q_p = counting.blocked_counting_query_plain(s_k, keys, lengths, cfg)
            assert torch.equal(q_k.cpu(), q_p.cpu())
            assert bool(q_k[lengths >= 0].all()) and not bool(q_k[lengths < 0].any())
    assert not bool(sweep.blocked_counting_query(s_k, keys[1000:1001], lengths[1000:1001], cfg)[0])
    assert sweep.launch_counts() == {**_NO_LAUNCH, "blocked_counting_update": 4,
                                     "blocked_counting_query": 2}


def test_counting_filter_on_card_matches_cpu(cuda):
    cfg = FilterConfig(m=1 << 20, k=7, key_len=L, counting=True, block_bits=512)
    gpu, cpu = BlockedCountingBloomFilter(cfg), BlockedCountingBloomFilter(cfg, device="cpu")
    assert gpu.words.is_cuda
    rng = np.random.default_rng(6)
    for _ in range(3):
        keys = [rng.bytes(int(rng.integers(0, L + 1))) for _ in range(1500)]
        gpu.insert_batch(keys + keys[:40] * 20)
        cpu.insert_batch(keys + keys[:40] * 20)
        rows = rng.integers(0, 256, (3000, L), dtype=np.uint8)
        gpu.insert_packed(rows)
        cpu.insert_packed(rows)
        gpu.delete_batch(keys[:700])
        cpu.delete_batch(keys[:700])
        probe = np.concatenate([rows[:500], rng.integers(0, 256, (500, L), dtype=np.uint8)])
        np.testing.assert_array_equal(gpu.include_packed(probe), cpu.include_packed(probe))
        np.testing.assert_array_equal(gpu.include_batch(keys), cpu.include_batch(keys))
    assert gpu.to_bytes() == cpu.to_bytes()


def _slot_state(cfg, route, dev):
    n = route.shards_per_dev * cfg.n_blocks_per_shard * cfg.words_per_block
    return torch.zeros(n, dtype=torch.int32, device=dev).view(torch.uint32)


_ROUTED_GEOMETRIES = [(512, "chunk"), (512, "ap"), (128, "chunk"), (256, "chunk"),
                      (1024, "ap"), (2048, "chunk"), (4096, "ap")]


@pytest.mark.parametrize("n_slots", [1, 4])
@pytest.mark.parametrize("block_bits,block_hash", _ROUTED_GEOMETRIES)
def test_routed_kernels_match_plain(cuda, block_bits, block_hash, n_slots):
    """The routed insert and query on each slot's state against their
    routed plain versions: old keys, within-batch duplicates, padding,
    and keys other slots own (which set nothing and answer False)."""
    cfg = FilterConfig(m=1 << 24, k=7, key_len=L, block_bits=block_bits,
                       block_hash=block_hash, shards=16)
    rng = np.random.default_rng(block_bits + n_slots)
    spd = 16 // n_slots
    sweep.reset_launch_counts()
    for i in range(n_slots):
        route = ShardRoute(16, i * spd, spd)
        state = _slot_state(cfg, route, cuda)
        for _ in range(2):
            prev, prev_len = _batch(rng, 4096, cuda)
            sweep.blocked_insert(state, prev, prev_len, cfg, route=route)
        keys, lengths = _batch(rng, 4096, cuda)
        keys[:500], lengths[:500] = prev[:500], prev_len[:500]
        s_k, s_p = _clone(state), _clone(state)
        sweep.blocked_insert(s_k, keys, lengths, cfg, route=route)
        blocked.blocked_insert_plain(s_p, keys, lengths, cfg, route)
        torch.cuda.synchronize()
        assert _equal_words(s_k, s_p)
        q_k = sweep.blocked_query(s_k, keys, lengths, cfg, route=route)
        q_p = blocked.blocked_query_plain(s_k, keys, lengths, cfg, route)
        assert torch.equal(q_k.cpu(), q_p.cpu())
        owned = blocked.routed_blocks(keys, lengths, cfg, route, block_bits=block_bits)[0]
        assert bool(q_k[owned].all()) and not bool(q_k[~owned].any())
        if n_slots > 1:
            assert bool(owned.any()) and not bool(owned.all())
    assert sweep.launch_counts() == {**_NO_LAUNCH, "sharded_blocked_insert": 3 * n_slots,
                                     "sharded_blocked_query": n_slots}


@pytest.mark.parametrize("n_slots", [1, 4])
@pytest.mark.parametrize("block_bits,block_hash", _ROUTED_GEOMETRIES)
def test_routed_counting_kernels_match_plain(cuda, block_bits, block_hash, n_slots):
    """The routed counting update (insert, then delete) and query on each
    slot's state against their routed plain versions, with a hot key
    (saturation at 15, then the floor at 0)."""
    cfg = FilterConfig(m=1 << 24, k=7, key_len=L, counting=True, block_bits=block_bits,
                       block_hash=block_hash, shards=16)
    rng = np.random.default_rng(block_bits + 10 * n_slots)
    spd = 16 // n_slots
    sweep.reset_launch_counts()
    for i in range(n_slots):
        route = ShardRoute(16, i * spd, spd)
        state = _slot_state(cfg, route, cuda)
        prev, prev_len = _batch(rng, 4096, cuda)
        sweep.blocked_counting_update(state, prev, prev_len, cfg, increment=True, route=route)
        keys, lengths = _batch(rng, 4096, cuda)
        keys[:500], lengths[:500] = prev[:500], prev_len[:500]
        keys[1000:2024], lengths[1000:2024] = keys[1000].clone(), L  # one hot key
        s_k, s_p = _clone(state), _clone(state)
        for increment in (True, False):
            sweep.blocked_counting_update(s_k, keys, lengths, cfg, increment=increment, route=route)
            counting.blocked_counting_update_plain(s_p, keys, lengths, cfg, increment=increment,
                                                   route=route)
            torch.cuda.synchronize()
            assert _equal_words(s_k, s_p)
            q_k = sweep.blocked_counting_query(s_k, keys, lengths, cfg, route=route)
            q_p = counting.blocked_counting_query_plain(s_k, keys, lengths, cfg, route)
            assert torch.equal(q_k.cpu(), q_p.cpu())
    assert sweep.launch_counts() == {**_NO_LAUNCH, "sharded_blocked_counting_update": 3 * n_slots,
                                     "sharded_blocked_counting_query": 2 * n_slots}


def _update(state, keys, lengths, cfg, *, increment=True, route=None, plain=False):
    """One update launch (or its plain version): the insert, or the
    counting filter's insert / delete."""
    if cfg.counting:
        fn = counting.blocked_counting_update_plain if plain else sweep.blocked_counting_update
        fn(state, keys, lengths, cfg, increment=increment, route=route)
    elif plain:
        blocked.blocked_insert_plain(state, keys, lengths, cfg, route)
    else:
        sweep.blocked_insert(state, keys, lengths, cfg, route=route)


def _keys(rng, n, dev, n_pad=0):
    keys = rng.integers(0, 256, (n, L), dtype=np.uint8)
    lengths = rng.integers(0, L + 1, n).astype(np.int32)
    if n_pad:
        lengths[-n_pad:] = -1
    keys[np.arange(L)[None, :] >= np.maximum(lengths, 0)[:, None]] = 0
    return torch.from_numpy(keys).to(dev), torch.from_numpy(lengths).to(dev)


@pytest.mark.parametrize("n", [1, 31, 33, 4096 + 13])
@pytest.mark.parametrize("block_bits", [128, 512, 4096])
@pytest.mark.parametrize("counting_layout", [False, True])
def test_update_kernels_ragged_batches(cuda, n, block_bits, counting_layout):
    """Batches that leave partial warps (1, 31, 33 keys) and a partial
    thread block, with padding at the tail where the batch has room."""
    cfg = FilterConfig(m=1 << 20, k=7, key_len=L, counting=counting_layout, block_bits=block_bits)
    rng = np.random.default_rng(n + block_bits)
    state = torch.zeros(cfg.n_blocks * cfg.words_per_block, dtype=torch.int32, device=cuda).view(torch.uint32)
    _update(state, *_keys(rng, 3000, cuda), cfg)
    keys, lengths = _keys(rng, n, cuda, n_pad=n // 8)
    s_k, s_p = _clone(state), _clone(state)
    for increment in (True, False) if counting_layout else (True,):
        _update(s_k, keys, lengths, cfg, increment=increment)
        _update(s_p, keys, lengths, cfg, increment=increment, plain=True)
        torch.cuda.synchronize()
        assert _equal_words(s_k, s_p)
        if increment:
            assert n == 1 or not _equal_words(s_k, state)


@pytest.mark.parametrize("block_hash", ["chunk", "ap"])
@pytest.mark.parametrize("counting_layout", [False, True])
def test_update_kernels_contention(cuda, block_hash, counting_layout):
    """4096 distinct keys in 8 blocks of 512 bits (m = 2^12 bits, or
    2^10 counters): every warp's groups race on the same rows. The
    counting filter saturates at 15 on the insert, then a delete of other
    keys floors counters at 0."""
    m = (1 << 10) if counting_layout else (1 << 12)
    cfg = FilterConfig(m=m, k=7, key_len=L, counting=counting_layout, block_bits=512,
                       block_hash=block_hash)
    assert cfg.n_blocks == 8
    rng = np.random.default_rng(11)
    s_k = torch.zeros(cfg.n_blocks * cfg.words_per_block, dtype=torch.int32, device=cuda).view(torch.uint32)
    s_p = _clone(s_k)
    for increment in (True, False) if counting_layout else (True,):
        keys, lengths = _keys(rng, 4096, cuda)
        _update(s_k, keys, lengths, cfg, increment=increment)
        _update(s_p, keys, lengths, cfg, increment=increment, plain=True)
        torch.cuda.synchronize()
        assert _equal_words(s_k, s_p)
        nib = (s_k.view(torch.int32).cpu().numpy().view(np.uint32)[:, None]
               >> (4 * np.arange(8, dtype=np.uint32))) & 15
        if not counting_layout:
            assert bool((s_k.view(torch.int32) != 0).any())
        else:
            assert (nib == (15 if increment else 0)).sum() > 0


@pytest.mark.parametrize("counting_layout", [False, True])
def test_routed_update_mostly_unowned(cuda, counting_layout):
    """A 4-slot placement (16 shards, 4 a slot) whose batch each slot owns
    only a few keys of: the work list holds those few, and nothing else
    of the slot's state changes."""
    cfg = FilterConfig(m=1 << 24, k=7, key_len=L, counting=counting_layout, block_bits=512,
                       shards=16)
    rng = np.random.default_rng(12)
    sweep.reset_launch_counts()
    for slot in range(4):
        route = ShardRoute(16, 4 * slot, 4)
        keys, lengths = _keys(rng, 8192, "cpu")
        owned = hashing.route_local(keys, lengths, route, cfg.seed)[1]
        pick = torch.cat([torch.nonzero(~owned)[:, 0], torch.nonzero(owned)[:64, 0]])
        pick = pick[torch.from_numpy(rng.permutation(pick.numel()))]
        keys, lengths = keys[pick].contiguous().to(cuda), lengths[pick].contiguous().to(cuda)
        state = _slot_state(cfg, route, cuda)
        s_k, s_p = _clone(state), _clone(state)
        for increment in (True, False) if counting_layout else (True,):
            _update(s_k, keys, lengths, cfg, increment=increment, route=route)
            _update(s_p, keys, lengths, cfg, increment=increment, route=route, plain=True)
            torch.cuda.synchronize()
            assert _equal_words(s_k, s_p)
            if increment:
                assert bool((s_k.view(torch.int32) != 0).any())
    name = "sharded_blocked_counting_update" if counting_layout else "sharded_blocked_insert"
    assert sweep.launch_counts() == {**_NO_LAUNCH, name: 4 * (2 if counting_layout else 1)}


@pytest.mark.parametrize("counting_layout", [False, True])
def test_sharded_filter_on_card_matches_cpu(cuda, counting_layout):
    """ShardedBloomFilter on 4 slots of the card against 4 CPU slots and
    one card slot: the same words and verdicts through every entry
    point."""
    cfg = FilterConfig(m=1 << 22, k=7, key_len=L, block_bits=512, shards=16,
                       counting=counting_layout)
    four, one = ShardedBloomFilter(cfg, devices=["cuda"] * 4), ShardedBloomFilter(cfg)
    cpu = ShardedBloomFilter(cfg, devices=["cpu"] * 4)
    assert all(w.is_cuda for w in four.slot_words + one.slot_words)
    rng = np.random.default_rng(7)
    sweep.reset_launch_counts()
    keys = [rng.bytes(int(rng.integers(0, L + 1))) for _ in range(1500)]
    rows = rng.integers(0, 256, (3000, L), dtype=np.uint8)
    probe = np.concatenate([rows[:500], rng.integers(0, 256, (500, L), dtype=np.uint8)])
    for f in (four, one, cpu):
        f.insert_batch(keys)
        f.insert_packed(rows)
        if counting_layout:
            f.delete_batch(keys[:700])
    want = cpu.include_packed(probe)
    for f in (four, one):
        np.testing.assert_array_equal(f.include_packed(probe), want)
        np.testing.assert_array_equal(f.include_batch(keys), cpu.include_batch(keys))
        assert f.to_bytes() == cpu.to_bytes()
    launches = sweep.launch_counts()
    name = "sharded_blocked_counting_update" if counting_layout else "sharded_blocked_insert"
    assert launches[name] == 5 * (3 if counting_layout else 2)


def _filled(cfg, rng, dev, route=None):
    """A state (the whole filter, or one slot's shards) holding
    max(32, block_bits / 8) keys a block, and the keys."""
    rows = cfg.n_blocks if route is None else route.shards_per_dev * cfg.n_blocks_per_shard
    lam = max(32, cfg.block_bits // 8)
    n_fill = lam * cfg.n_blocks  # a routed slot owns about its share of these keys
    state = torch.zeros(rows * cfg.words_per_block, dtype=torch.int32, device=dev).view(torch.uint32)
    keys, lengths = _keys(rng, n_fill, dev)
    sweep.blocked_insert(state, keys, lengths, cfg, route=route)
    return state, keys, lengths


def _probe(rng, n, held, held_len, dev, key_len=L):
    """n keys: a third the filter holds, the rest fresh (lengths 0..L),
    the last n // 8 padding."""
    keys = rng.integers(0, 256, (n, key_len), dtype=np.uint8)
    lengths = rng.integers(0, key_len + 1, n).astype(np.int32)
    keys[np.arange(key_len)[None, :] >= lengths[:, None]] = 0
    keys, lengths = torch.from_numpy(keys).to(dev), torch.from_numpy(lengths).to(dev)
    keys[: n // 3], lengths[: n // 3] = held[: n // 3], held_len[: n // 3]
    if n // 8:
        lengths[-(n // 8):] = -1
    return keys.contiguous(), lengths.contiguous()


@pytest.mark.parametrize("n", [1, 31, 33, 4109])
@pytest.mark.parametrize("block_bits", [128, 256, 512, 1024, 2048, 4096])
def test_query_kernel_mixed_verdicts(cuda, n, block_bits):
    """The query against its plain version on ragged batches of held
    keys, fresh keys of every length 0..L and padding, at a fill where
    fresh keys give false positives."""
    cfg = FilterConfig(m=block_bits * 64, k=7, key_len=L, block_bits=block_bits,
                       block_hash="chunk" if block_bits in (128, 512, 2048) else "ap")
    rng = np.random.default_rng(n + block_bits)
    state, held, held_len = _filled(cfg, rng, cuda)
    keys, lengths = _probe(rng, n, held, held_len, cuda)
    before = _clone(state)
    sweep.reset_launch_counts()
    got = sweep.blocked_query(state, keys, lengths, cfg)
    want = blocked.blocked_query_plain(state, keys, lengths, cfg)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want.cpu())
    assert _equal_words(state, before)  # the query writes nothing
    assert bool(got[: n // 3].all()) and not bool(got[lengths < 0].any())
    if n > 1000:
        fresh = got[n // 3 : n - n // 8]
        assert 0 < int(fresh.sum()) < fresh.numel()  # false positives: mixed verdicts
    assert sweep.launch_counts() == {**_NO_LAUNCH, "blocked_query": 1}


@pytest.mark.parametrize("block_bits", [128, 512, 4096])
def test_query_kernel_all_padding(cuda, block_bits):
    cfg = FilterConfig(m=block_bits * 64, k=7, key_len=L, block_bits=block_bits)
    rng = np.random.default_rng(3)
    state, held, held_len = _filled(cfg, rng, cuda)
    lengths = torch.full((300,), -1, dtype=torch.int32, device=cuda)
    got = sweep.blocked_query(state, held[:300].contiguous(), lengths, cfg)
    assert not bool(got.any())


@pytest.mark.parametrize("key_len", [8, 32])
def test_query_kernel_other_key_lengths(cuda, key_len):
    """Keys other than 16 bytes, which the kernel hashes from memory."""
    cfg = FilterConfig(m=512 * 64, k=7, key_len=key_len, block_bits=512)
    rng = np.random.default_rng(key_len)
    state = torch.zeros(cfg.n_blocks * cfg.words_per_block, dtype=torch.int32,
                        device=cuda).view(torch.uint32)
    held = rng.integers(0, 256, (64 * 64, key_len), dtype=np.uint8)
    held = torch.from_numpy(held).to(cuda)
    held_len = torch.full((held.shape[0],), key_len, dtype=torch.int32, device=cuda)
    sweep.blocked_insert(state, held, held_len, cfg)
    keys, lengths = _probe(rng, 4109, held, held_len, cuda, key_len=key_len)
    got = sweep.blocked_query(state, keys, lengths, cfg)
    assert torch.equal(got.cpu(), blocked.blocked_query_plain(state, keys, lengths, cfg).cpu())
    assert bool(got[: 4109 // 3].all())


_ROUTED_QUERY_CASES = [(1, "mixed"), (4, "mixed"), (4, "mostly_unowned"), (4, "unowned_only")]


@pytest.mark.parametrize("n_slots,batch", _ROUTED_QUERY_CASES)
@pytest.mark.parametrize("block_bits", [128, 512, 1024, 4096])
def test_routed_query_kernels(cuda, block_bits, n_slots, batch):
    """The routed query on every slot of a 1- or 4-slot placement against
    its routed plain version: a mixed batch, a batch of which the slot
    owns 64 keys, and one of which it owns none (every key False, no row
    read). A slot of the 4-slot placement compacts its owned keys (each
    verdict must land at its key's index); the 1-slot placement's slot
    owns every shard and routes each key in its own thread."""
    cfg = FilterConfig(m=block_bits * 256, k=7, key_len=L, block_bits=block_bits, shards=16,
                       block_hash="ap" if block_bits == 1024 else "chunk")
    rng = np.random.default_rng(block_bits + 7 * n_slots + len(batch))
    spd = 16 // n_slots
    sweep.reset_launch_counts()
    for slot in range(n_slots):
        route = ShardRoute(16, slot * spd, spd)
        state, held, held_len = _filled(cfg, rng, cuda, route)
        keys, lengths = _probe(rng, 4109, held, held_len, cuda)
        owned = hashing.route_local(keys.cpu(), lengths.cpu(), route, cfg.seed)[1]
        if batch != "mixed":
            pick = torch.cat([torch.nonzero(~owned)[:, 0],
                              torch.nonzero(owned)[: 64 if batch == "mostly_unowned" else 0, 0]])
            pick = pick[torch.from_numpy(rng.permutation(pick.numel()))]
            keys, lengths, owned = keys[pick.to(cuda)].contiguous(), lengths[pick.to(cuda)].contiguous(), owned[pick]
        got = sweep.blocked_query(state, keys, lengths, cfg, route=route)
        want = blocked.blocked_query_plain(state, keys, lengths, cfg, route)
        assert torch.equal(got.cpu(), want.cpu())
        assert not bool(got.cpu()[~owned].any())
        if batch == "unowned_only":
            assert not bool(owned.any())
        elif batch == "mostly_unowned":
            assert int(owned.sum()) == 64 and bool(got.cpu()[owned].any())
        else:
            assert bool(got.cpu()[owned].any()) and (n_slots == 1 or not bool(owned.all()))
    assert sweep.launch_counts() == {**_NO_LAUNCH, "sharded_blocked_insert": n_slots,
                                     "sharded_blocked_query": n_slots}
