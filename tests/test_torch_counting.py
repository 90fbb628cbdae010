"""The port's blocked counting filter against tpubloom's, on the CPU, exact
(tolerance 0) on counter words, verdicts, to_bytes() and n_inserted:

* the plain update (``blocked_counting_update_plain``) against the two TPU
  counting kernels it replaces, run in Pallas interpret mode: K4
  (``_fat_count_kernel``, through ``make_sweep_counter_fn(...,
  storage_fat=True)``) on the fat storage and K2 (``_count_kernel``,
  through ``apply_counter_updates``) on the logical ``[NB, W]`` array.
  The cases: a pre-populated state with old keys, fresh keys, a quarter
  of the batch one repeated key and tail padding; and 40 copies of one
  key (saturation at 15, then the floor at 0). Each interpret-mode call
  costs seconds, so each runs once, in a module-scoped fixture;
* ``tpubloom_torch.BlockedCountingBloomFilter(cfg, device="cpu")``
  against ``tpubloom.BlockedCountingBloomFilter`` over several rounds of
  every entry point;
* membership needing all k counters, the guards, and interop.

m = 2^20 counters, k = 7, block_bits = 512 (n_blocks = 8192, W = 16)
unless a test says otherwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpubloom
from tpubloom.filter import make_blocked_counter_fn, make_blocked_counting_query_fn
from tpubloom.ops import blocked as jblocked
from tpubloom.ops import sweep as jsweep
from tpubloom_torch import BlockedBloomFilter, BlockedCountingBloomFilter, FilterConfig
from tpubloom_torch import interop
from tpubloom_torch.filter import blocked_device_shape
from tpubloom_torch.ops import blocked, counting, sweep

M, K, L, BB = 1 << 20, 7, 16, 512
JCFG = tpubloom.FilterConfig(m=M, k=K, key_len=L, counting=True, block_bits=BB)
CFG = FilterConfig(m=M, k=K, key_len=L, counting=True, block_bits=BB)
NB, W, CPB = CFG.n_blocks, CFG.words_per_block, CFG.counters_per_block
FAT = blocked_device_shape(CFG)
B, N_PAD = 1024, 37
# where each case's batch puts its parts
N_OLD, N_HOT = 200, B // 4
N_COPIES = 40


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy: the kernels update in place


def _scatter_update(words_logical, keys, lengths, increment):
    """tpubloom's ground truth: the flat counter_update on the raveled
    array (``make_blocked_counter_fn`` on its scatter path)."""
    fn = make_blocked_counter_fn(JCFG.replace(insert_path="scatter"), increment=increment)
    return np.asarray(fn(jnp.asarray(words_logical), jnp.asarray(keys), jnp.asarray(lengths)))


def _k4(words, keys, lengths, increment):
    fn = jsweep.make_sweep_counter_fn(JCFG, increment=increment, interpret=True, storage_fat=True)
    out = fn(jnp.asarray(words.reshape(FAT)), jnp.asarray(keys), jnp.asarray(lengths))
    return np.asarray(out).reshape(NB, W)


def _k2(words, keys, lengths, increment):
    valid = jnp.asarray(lengths) >= 0
    blk, cpos = jblocked.block_positions(
        jnp.asarray(keys), jnp.maximum(jnp.asarray(lengths), 0),
        n_blocks=NB, block_bits=CPB, k=K, seed=JCFG.seed, block_hash=JCFG.block_hash,
    )
    out = jsweep.apply_counter_updates(
        jnp.asarray(words.reshape(NB, W)), blk, cpos, valid,
        counters_per_block=CPB, k=K, increment=increment, interpret=True,
    )
    return np.asarray(out)


def _k4_window_overflows(keys, lengths):
    """Whether K4's update windows overflow on this batch, which sends
    tpubloom's whole batch to its scatter fallback instead of the kernel
    (``apply_fat_counter_updates``)."""
    J, R8, S, KJ, KBJ = jsweep.choose_fat_params(NB, B, W, counting=True)
    NBJ = NB // J
    P8 = NBJ // R8
    valid = jnp.asarray(lengths) >= 0
    blk, _ = jblocked.block_positions(
        jnp.asarray(keys), jnp.maximum(jnp.asarray(lengths), 0),
        n_blocks=NB, block_bits=CPB, k=K, seed=JCFG.seed, block_hash=JCFG.block_hash,
    )
    blkv = jnp.where(valid, blk, NB)
    skey = jnp.where(
        valid, (blkv % J).astype(jnp.uint32) * NBJ + (blkv // J).astype(jnp.uint32),
        jnp.uint32(J * NBJ),
    )
    pack = jsweep.fat_pack(W, False)
    _, starts = jsweep._fat_stream(
        jnp.sort(skey), jnp.zeros((B, W), jnp.uint32), None,
        J=J, NBJ=NBJ, P8=P8, R8=R8, KBJ=KBJ, W=W, pack=pack,
    )
    return bool(jsweep._fat_window_overflow(starts, J=J, P8=P8, S=S, KJ=KJ, KBJ=KBJ, pack=pack))


def _case(name):
    """(pre-batch state uint32[NB, W], keys uint8[B, L], lengths int32[B])."""
    rng = np.random.default_rng(31 if name == "skew" else 32)
    keys = rng.integers(0, 256, (B, L), dtype=np.uint8)
    lengths = np.full((B,), L, np.int32)
    state = np.zeros((NB, W), np.uint32)
    if name == "skew":
        # old keys already counted, a quarter of the batch one repeated
        # key, fresh keys, tail padding
        pre = rng.integers(0, 256, (2048, L), dtype=np.uint8)
        state = _scatter_update(state, pre, np.full((2048,), L, np.int32), True)
        keys[:N_OLD] = pre[:N_OLD]
        keys[N_OLD : N_OLD + N_HOT] = keys[N_OLD]
    else:
        # N_COPIES copies of one key: its counters saturate at 15 on the
        # insert and floor at 0 on the delete
        keys[:N_COPIES] = keys[0]
    lengths[B - N_PAD :] = -1
    keys[B - N_PAD :] = 0
    return state, keys, lengths


CASES = ("skew", "saturate")


@pytest.fixture(scope="module")
def runs():
    """For each case: the pre-batch state, the batch, and the state after
    the insert and after the delete of the same batch, through the
    scatter ground truth, K4 and K2 (interpret mode)."""
    out = {}
    for name in CASES:
        state, keys, lengths = _case(name)
        r = {"state": state, "keys": keys, "lengths": lengths}
        for kernel, fn in (("scatter", _scatter_update), ("k4", _k4), ("k2", _k2)):
            ins = fn(state, keys, lengths, True)
            r[kernel] = (ins, fn(ins, keys, lengths, False))
        out[name] = r
    return out


def test_k4_runs_at_this_shape_and_skew_takes_its_fallback():
    """K4 itself runs on the saturation case; the quarter-skew case
    overflows its windows, where tpubloom sends the batch to the scatter
    fallback (the Hopper kernel has no window to overflow)."""
    assert jsweep.choose_fat_params(NB, B, W, counting=True) is not None
    assert not _k4_window_overflows(*_case("saturate")[1:])
    assert _k4_window_overflows(*_case("skew")[1:])


@pytest.mark.parametrize("kernel", ["k4", "k2", "scatter"])
@pytest.mark.parametrize("name", CASES)
def test_plain_update_matches_tpu_kernel(runs, name, kernel):
    r = runs[name]
    want_ins, want_del = r[kernel]
    st = _t(r["state"].reshape(FAT))
    keys, lengths = _t(r["keys"]), _t(r["lengths"])
    counting.blocked_counting_update_plain(st, keys, lengths, CFG, increment=True)
    np.testing.assert_array_equal(st.numpy().reshape(NB, W), want_ins)
    sweep.blocked_counting_update(st, keys, lengths, CFG, increment=False)
    np.testing.assert_array_equal(st.numpy().reshape(NB, W), want_del)


@pytest.mark.parametrize("view", ["fat", "logical"])
def test_update_saturates_then_floors(runs, view):
    """The hot key's counters read 15 after the insert and 0 after the
    delete, through either view of the same state."""
    r = runs["saturate"]
    shape = FAT if view == "fat" else (NB, W)
    st = _t(r["state"].reshape(shape))
    keys, lengths = _t(r["keys"]), _t(r["lengths"])
    sweep.blocked_counting_update(st, keys, lengths, CFG, increment=True)
    blk, cpos = blocked.block_positions(
        keys[:1], lengths[:1], n_blocks=NB, block_bits=CPB, k=K, seed=CFG.seed,
        block_hash=CFG.block_hash,
    )
    row = st.view(torch.int32).reshape(NB, W)[int(blk[0])].to(torch.int64) & 0xFFFFFFFF
    cnt = (row[cpos[0] >> 3] >> (4 * (cpos[0] & 7))) & 15
    assert cnt.tolist() == [15] * K
    sweep.blocked_counting_update(st, keys, lengths, CFG, increment=False)
    np.testing.assert_array_equal(st.numpy().reshape(NB, W), r["k2"][1])
    assert not st.numpy().any()  # every counter of the batch floored back to 0


@pytest.mark.parametrize("name", CASES)
def test_plain_query_matches_tpubloom(runs, name):
    r = runs[name]
    ins = r["k4"][0]
    rng = np.random.default_rng(33)
    probe = r["keys"].copy()
    probe[B // 2 : B - N_PAD] = rng.integers(0, 256, (B // 2 - N_PAD, L), dtype=np.uint8)
    want = np.asarray(
        make_blocked_counting_query_fn(JCFG, storage_fat=True)(
            jnp.asarray(ins.reshape(FAT)), jnp.asarray(probe), jnp.asarray(r["lengths"])
        )
    )
    got = sweep.blocked_counting_query(_t(ins.reshape(FAT)), _t(probe), _t(r["lengths"]), CFG).numpy()
    valid = r["lengths"] >= 0
    np.testing.assert_array_equal(got[valid], want[valid])
    assert got[: B // 2][valid[: B // 2]].all()
    assert not got[~valid].any()  # padding answers False


def _keys(rng, n, fixed=False):
    if fixed:
        return rng.integers(0, 256, (n, L), dtype=np.uint8)
    return [rng.bytes(int(rng.integers(0, L + 1))) for _ in range(n)]


@pytest.mark.parametrize(
    "block_bits,block_hash", [(512, "chunk"), (512, "ap"), (256, "chunk")]
)
def test_filter_matches_jax(block_bits, block_hash):
    kw = dict(m=M, k=K, key_len=L, counting=True, block_bits=block_bits, block_hash=block_hash)
    port = BlockedCountingBloomFilter(FilterConfig(**kw), device="cpu")
    ref = tpubloom.BlockedCountingBloomFilter(tpubloom.FilterConfig(**kw))
    rng = np.random.default_rng(block_bits + len(block_hash))
    old = []
    for step in range(3):
        # fresh keys, repeats of the last round's keys, and one key 20
        # times (its counters saturate)
        hot = _keys(rng, 1)
        keys = _keys(rng, 600) + old[:150] + hot * 20
        port.insert_batch(keys)
        ref.insert_batch(keys)
        rows = _keys(rng, 400, fixed=True)
        assert port.insert_packed(rows) == ref.insert_packed(rows) == 400
        probe = keys + _keys(rng, 300)
        np.testing.assert_array_equal(port.include_batch(probe), ref.include_batch(probe))
        probe_rows = np.concatenate([rows[:100], _keys(rng, 100, fixed=True)])
        np.testing.assert_array_equal(port.include_packed(probe_rows), ref.include_packed(probe_rows))
        # delete some of this round's keys, the hot key more often than it
        # was inserted (the floor), and keys never inserted
        gone = keys[:200] + hot * 25 + _keys(rng, 50)
        port.delete_batch(gone)
        ref.delete_batch(gone)
        np.testing.assert_array_equal(port.include_batch(probe), ref.include_batch(probe))
        staged = _keys(rng, 300, fixed=True)
        port.launch_insert(port.stage_batch(rows=staged))
        ref.launch_insert(ref.stage_batch(rows=staged))
        hits, n = port.launch_query(port.stage_batch([bytes(r) for r in staged[:100]] + probe[:100]))
        want, n_ref = ref.launch_query(ref.stage_batch([bytes(r) for r in staged[:100]] + probe[:100]))
        assert n == n_ref == 200
        np.testing.assert_array_equal(hits.numpy()[:n], np.asarray(want)[:n])
        np.testing.assert_array_equal(port.words_logical, ref.words_logical)
        assert port.n_inserted == ref.n_inserted and port.n_queried == ref.n_queried
        old = keys
    assert port.to_bytes() == ref.to_bytes()
    assert port.stats() == ref.stats()
    again = BlockedCountingBloomFilter.from_bytes(port.config, port.to_bytes(), device="cpu")
    assert again.to_bytes() == port.to_bytes()


def test_device_arrays_api_and_clear():
    port = BlockedCountingBloomFilter(CFG, device="cpu")
    rng = np.random.default_rng(34)
    rows = _t(_keys(rng, 256, fixed=True))
    lengths = torch.full((256,), L, dtype=torch.int32)
    lengths[200:] = -1
    port.insert_arrays(rows, lengths, n_valid=200)
    assert port.n_inserted == 200
    hits = port.include_arrays(rows, lengths)
    assert hits[:200].all() and not hits[200:].any()
    key = bytes(rows[0].numpy())
    assert port.include(key) and key in port
    port.insert(key)
    port.delete(key)
    assert key in port  # one of its two copies remains
    port.clear()
    assert port.n_inserted == 0 and not port.words_logical.any()


def test_query_requires_all_counters():
    """With every counter of the key set the key is present; zeroing any
    single one of them makes it absent — the hand-crafted words of
    tests/test_counting_blocked.py, through both packages."""
    key = b"all-counters-key"
    keys, lengths = _t(np.frombuffer(key, np.uint8)[None, :].copy()), torch.tensor([L], dtype=torch.int32)
    blk, cpos = blocked.block_positions(
        keys, lengths, n_blocks=NB, block_bits=CPB, k=K, seed=CFG.seed, block_hash=CFG.block_hash,
    )
    jblk, jcpos = jblocked.block_positions(
        jnp.asarray(keys.numpy()), jnp.asarray(lengths.numpy()),
        n_blocks=NB, block_bits=CPB, k=K, seed=JCFG.seed, block_hash=JCFG.block_hash,
    )
    assert int(blk[0]) == int(np.asarray(jblk)[0])
    np.testing.assert_array_equal(cpos[0].numpy(), np.asarray(jcpos)[0])
    blk = int(blk[0])
    counters = sorted(set(cpos[0].tolist()))
    query = make_blocked_counting_query_fn(JCFG)

    def words_with(cs):
        w = np.zeros((NB, W), np.uint32)
        for c in cs:
            w[blk, c >> 3] |= np.uint32(1) << np.uint32(4 * (c & 7))
        return w

    for cs, want in [(counters, True)] + [([c for c in counters if c != d], False) for d in counters]:
        w = words_with(cs)
        got = bool(sweep.blocked_counting_query(_t(w), keys, lengths, CFG)[0])
        assert got == want == bool(np.asarray(query(jnp.asarray(w), jnp.asarray(keys.numpy()),
                                                    jnp.asarray(lengths.numpy())))[0])


@pytest.mark.parametrize(
    "kw",
    [
        dict(m=1 << 30, k=7, block_bits=512),
        dict(m=1 << 20, k=5, block_bits=256, block_hash="ap"),
        dict(m=1 << 12, k=7, block_bits=128),
        dict(m=1 << 24, k=20, block_bits=4096),
    ],
)
def test_counting_geometry_fills_the_state(kw):
    """The wrappers' size check (n_blocks · words_per_block) is m/8 words
    for counting configs: 4-bit counters, 8 to a word."""
    cfg = FilterConfig(counting=True, **kw)
    assert cfg.n_blocks * cfg.words_per_block == cfg.m // 8 == cfg.n_counter_words
    assert cfg.to_dict() == tpubloom.FilterConfig(counting=True, **kw).to_dict()


def test_guards():
    with pytest.raises(ValueError, match=r"m < 2\^31") as got:
        BlockedCountingBloomFilter(FilterConfig(m=1 << 31, k=K, counting=True, block_bits=BB), device="cpu")
    with pytest.raises(ValueError) as want:
        tpubloom.BlockedCountingBloomFilter(tpubloom.FilterConfig(m=1 << 31, k=K, counting=True, block_bits=BB))
    assert str(got.value) == str(want.value)
    f = BlockedCountingBloomFilter(CFG, device="cpu")
    with pytest.raises(ValueError, match="fill_ratio"):
        f.fill_ratio()
    with pytest.raises(TypeError):
        f.insert_batch([b"a"], return_presence=True)  # no test-and-insert here
    with pytest.raises(ValueError, match="BlockedCountingBloomFilter"):
        BlockedBloomFilter(CFG, device="cpu")
    # an unset counting / block_bits is forced, as in tpubloom
    plain = FilterConfig(m=M, k=K)
    assert BlockedCountingBloomFilter(plain, device="cpu").config.to_dict() == \
        tpubloom.BlockedCountingBloomFilter(tpubloom.FilterConfig(m=M, k=K)).config.to_dict()
    # each kernel takes only its own kind of config
    keys, lengths = torch.zeros((4, L), dtype=torch.uint8), torch.zeros(4, dtype=torch.int32)
    bit_cfg = FilterConfig(m=M, k=K, block_bits=BB)
    with pytest.raises(ValueError, match="counting"):
        sweep.blocked_counting_query(f.words, keys, lengths, bit_cfg)
    with pytest.raises(ValueError, match="counting"):
        sweep.blocked_insert(f.words, keys, lengths, CFG)


def test_cpu_tensors_count_no_launch():
    sweep.reset_launch_counts()
    f = BlockedCountingBloomFilter(CFG, device="cpu")
    f.insert_batch([b"a", b"b"])
    f.delete_batch([b"a"])
    assert f.include_batch([b"a", b"b"]).tolist() == [False, True]
    assert not any(sweep.launch_counts().values())


def test_interop_round_trip_both_ways():
    cfg = interop.config_from_dict(JCFG.to_dict())
    assert cfg.to_dict() == JCFG.to_dict()
    rng = np.random.default_rng(35)
    keys_a = _keys(rng, 800)
    ref = tpubloom.BlockedCountingBloomFilter(JCFG)
    ref.insert_batch(keys_a + keys_a[:100])
    # tpubloom -> port
    port = interop.filter_from_words(ref.words_logical, cfg, "cpu", n_inserted=ref.n_inserted)
    assert isinstance(port, BlockedCountingBloomFilter)
    assert port.to_bytes() == ref.to_bytes()
    probe = keys_a + _keys(rng, 400)
    np.testing.assert_array_equal(port.include_batch(probe), ref.include_batch(probe))
    # port -> tpubloom, after the port moves on
    port.delete_batch(keys_a[:300])
    port.insert_batch(_keys(rng, 500))
    back = tpubloom.BlockedCountingBloomFilter.from_bytes(JCFG, interop.words_to_numpy(port).tobytes())
    np.testing.assert_array_equal(back.words_logical, port.words_logical)
    np.testing.assert_array_equal(back.include_batch(probe), port.include_batch(probe))
