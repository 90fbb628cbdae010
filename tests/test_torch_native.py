"""The port's host C++ library (``tpubloom_torch.native``) and the numpy
position spec of ``tpubloom_torch.cpu_ref`` against ``tpubloom``'s, byte
for byte (tolerance 0): each C function through its wrapper against
``tpubloom.native``'s, and ``murmur3_32_np`` / ``fnv1a_32_np`` /
``positions_np`` / ``blocked_positions_np`` against ``tpubloom.cpu_ref``'s.
Key lengths 0, 1 and ``key_len`` are in every batch, with the pad bytes
past a key's length zero (the hash-kernel contract). Also: the chunk
pool's refusal raises the reference's exception class, the wrappers
refuse arrays they cannot hand to C, and a failed ``g++`` build raises
with the compiler's log wherever the native path is used."""

import numpy as np
import pytest

from tpubloom import cpu_ref as jcpu
from tpubloom import native as jnative
from tpubloom_torch import FilterConfig, cpu_ref, native
from tpubloom_torch.ops import _build
from tpubloom_torch.utils.packing import pack_keys_dense

SEEDS = [0, 0x9747B28C, 0xFFFFFFFF]
KEY_LENS = [16, 28]


def _keys(key_len: int, n: int = 600, seed: int = 7):
    rng = np.random.default_rng(seed + key_len)
    keys = rng.integers(0, 256, (n, key_len), dtype=np.uint8)
    lens = rng.integers(0, key_len + 1, n).astype(np.int32)
    lens[:3] = (0, 1, key_len)
    return pack_keys_dense(keys, lens)


@pytest.fixture(scope="module", autouse=True)
def _reference_library():
    assert jnative.available(), "tpubloom's native library must build for the parity tests"


@pytest.mark.parametrize("key_len", KEY_LENS)
@pytest.mark.parametrize("seed", SEEDS)
def test_murmur3_batch_matches_reference(key_len, seed):
    keys, lens = _keys(key_len)
    got = native.murmur3_batch(keys, lens, seed)
    assert np.array_equal(got, jnative.murmur3_batch(keys, lens, seed))
    assert np.array_equal(cpu_ref.murmur3_32_np(keys, lens, seed), jcpu.murmur3_32_np(keys, lens, seed))
    assert np.array_equal(got, cpu_ref.murmur3_32_np(keys, lens, seed))


@pytest.mark.parametrize("key_len", KEY_LENS)
def test_fnv1a_batch_matches_reference(key_len):
    keys, lens = _keys(key_len)
    got = native.fnv1a_batch(keys, lens)
    assert np.array_equal(got, jnative.fnv1a_batch(keys, lens))
    assert np.array_equal(cpu_ref.fnv1a_32_np(keys, lens), jcpu.fnv1a_32_np(keys, lens))
    assert np.array_equal(got, cpu_ref.fnv1a_32_np(keys, lens))


# power-of-two m (the 64-bit walk, up to 2^36), config 1's m and a prime (the mod walk)
@pytest.mark.parametrize("m", [1 << 10, 1 << 20, 1 << 36, 10_000_000, 1_000_003])
@pytest.mark.parametrize("k", [1, 7, 13])
def test_positions_batch_matches_reference(m, k):
    keys, lens = _keys(16)
    kw = dict(m=m, k=k, seed=0x9747B28C)
    got = native.positions_batch(keys, lens, **kw)
    assert np.array_equal(got, jnative.positions_batch(keys, lens, **kw))
    assert np.array_equal(cpu_ref.positions_np(keys, lens, **kw), jcpu.positions_np(keys, lens, **kw))
    assert np.array_equal(got, cpu_ref.positions_np(keys, lens, **kw))


@pytest.mark.parametrize("m", [1 << 16, 10_000_000, 99_968])
@pytest.mark.parametrize("k", [3, 7])
def test_hash_insert_and_query_match_reference(m, k):
    keys, lens = _keys(16, n=2000)
    kw = dict(m=m, k=k, seed=5)
    got, want = np.zeros((m + 31) // 32, np.uint32), np.zeros((m + 31) // 32, np.uint32)
    native.hash_insert(got, keys[:1000], lens[:1000], **kw)
    jnative.hash_insert(want, keys[:1000], lens[:1000], **kw)
    assert np.array_equal(got, want)
    hits = native.hash_query(got, keys, lens, **kw)
    assert np.array_equal(hits, jnative.hash_query(want, keys, lens, **kw))
    assert hits[:1000].all()


@pytest.mark.parametrize("block_hash", ["chunk", "ap"])
@pytest.mark.parametrize("block_bits,k", [(512, 7), (256, 4), (1024, 9), (512, 16)])
def test_blocked_insert_and_query_match_reference(block_hash, block_bits, k):
    if block_hash == "chunk" and k * (block_bits - 1).bit_length() > 96:
        k = 96 // (block_bits - 1).bit_length()
    keys, lens = _keys(16, n=2000)
    n_blocks = (1 << 16) // block_bits
    kw = dict(n_blocks=n_blocks, block_bits=block_bits, k=k, seed=11, block_hash=block_hash)
    shape = (n_blocks, block_bits // 32)
    got, want = np.zeros(shape, np.uint32), np.zeros(shape, np.uint32)
    native.blocked_insert(got, keys[:1000], lens[:1000], **kw)
    jnative.blocked_insert(want, keys[:1000], lens[:1000], **kw)
    assert np.array_equal(got, want)
    hits = native.blocked_query(got, keys, lens, **kw)
    assert np.array_equal(hits, jnative.blocked_query(want, keys, lens, **kw))
    assert hits[:1000].all()
    blk, bit = cpu_ref.blocked_positions_np(keys, lens, **kw)
    jblk, jbit = jcpu.blocked_positions_np(keys, lens, **kw)
    assert np.array_equal(blk, jblk) and np.array_equal(bit, jbit)


def test_chunk_pool_refusal_raises_the_reference_class():
    keys, lens = _keys(16, n=8)
    kw = dict(n_blocks=64, block_bits=512, k=11, seed=0, block_hash="chunk")  # 11 x 9 bits > 96
    words = np.zeros((64, 16), np.uint32)
    for fn, ref in ((native.blocked_insert, jnative.blocked_insert),
                    (native.blocked_query, jnative.blocked_query)):
        with pytest.raises(Exception) as ours:
            fn(words, keys, lens, **kw)
        with pytest.raises(Exception) as theirs:
            ref(words.copy(), keys, lens, **kw)
        assert type(ours.value) is type(theirs.value) is ValueError
    with pytest.raises(Exception) as ours:
        cpu_ref.blocked_positions_np(keys, lens, **kw)
    with pytest.raises(Exception) as theirs:
        jcpu.blocked_positions_np(keys, lens, **kw)
    assert type(ours.value) is type(theirs.value) is ValueError
    assert not words.any()


@pytest.mark.parametrize("key_len", [1, 16, 28])
def test_pack_joined_matches_reference(key_len):
    rng = np.random.default_rng(key_len)
    keys = [rng.bytes(int(n)) for n in rng.integers(0, key_len + 1, 500)] + [b"", b"x"[:key_len]]
    lens = np.array([len(k) for k in keys], np.int32)
    joined = b"".join(keys)
    got = native.pack_joined(joined, lens, key_len)
    assert np.array_equal(got, jnative.pack_joined(joined, lens, key_len))
    assert got.shape == (len(keys), key_len) and got.dtype == np.uint8
    assert np.array_equal(native.pack_joined(b"", np.zeros(0, np.int32), key_len),
                          jnative.pack_joined(b"", np.zeros(0, np.int32), key_len))


@pytest.mark.parametrize("lens,joined", [([3, 17], b"a" * 20), ([-1, 2], b"a"), ([2, 2], b"abc")])
def test_pack_joined_refuses_what_the_reference_refuses(lens, joined):
    lens = np.array(lens, np.int32)
    with pytest.raises(ValueError):
        native.pack_joined(joined, lens, 16)
    with pytest.raises(ValueError):
        jnative.pack_joined(joined, lens, 16)


def test_wrappers_refuse_arrays_they_cannot_hand_to_c():
    keys, lens = _keys(16, n=8)
    blocked = dict(n_blocks=64, block_bits=512, k=7, seed=0, block_hash="ap")
    for words in (np.zeros((64, 16), np.int32), np.zeros((32, 16), np.uint32),
                  np.zeros((16, 64), np.uint32).T):
        with pytest.raises(ValueError, match="words"):
            native.blocked_insert(words, keys, lens, **blocked)
    with pytest.raises(ValueError, match="words"):
        native.hash_insert(np.zeros(10, np.uint32), keys, lens, m=1 << 10, k=7, seed=0)
    with pytest.raises(ValueError, match="k must be"):
        native.blocked_query(np.zeros((64, 16), np.uint32), keys, lens, **{**blocked, "k": 65})
    with pytest.raises(ValueError, match="lens"):
        native.murmur3_batch(keys, np.full(8, 17, np.int32), 0)
    with pytest.raises(ValueError, match="shapes"):
        native.fnv1a_batch(keys, lens[:4])


def test_library_builds_from_the_checkout_with_g_plus_plus():
    assert "bloomhash" in _build.host_sources()
    assert "bloomhash" not in _build.sources()  # not in the nvcc list
    assert native.available()
    path = _build.library_path("bloomhash")
    assert path.exists() and path.parent == _build.BUILD_DIR
    assert "-march=native" not in _build.GXX_FLAGS


def test_failed_build_raises_with_the_compiler_log(tmp_path, monkeypatch):
    (tmp_path / "bloomhash.cpp").write_text("int broken( { return 0; }\n")
    monkeypatch.setattr(_build, "NATIVE_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_loaded", {})
    keys, lens = _keys(16, n=4)
    calls = [
        native.available,
        lambda: native.murmur3_batch(keys, lens, 0),
        lambda: cpu_ref.CPUBloomFilter(FilterConfig(m=1 << 10, k=3)),
        lambda: cpu_ref.CPUBlockedBloomFilter(FilterConfig(m=1 << 12, k=3, block_bits=512)),
        lambda: cpu_ref.CPUBloomFilter(FilterConfig(m=1 << 10, k=3), use_native=True),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match=r"(?s)bloomhash: g\+\+ exit \d+.*error"):
            call()
    assert not list((tmp_path / "_build").glob("*.so"))
    # numpy was asked for: no build, no error
    f = cpu_ref.CPUBloomFilter(FilterConfig(m=1 << 10, k=3), use_native=False)
    assert not f.use_native
