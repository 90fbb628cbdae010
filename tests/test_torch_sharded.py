"""The port's sharded filter array (``tpubloom_torch.ShardedBloomFilter``)
against tpubloom's (``tpubloom.parallel.sharded.ShardedBloomFilter`` on the
fake 8-device CPU mesh), on the CPU, exact (tolerance 0) on words, verdicts,
bytes and ``n_inserted``:

* routing: ``route_shards`` against tpubloom's and the numpy oracle;
* K1: the port's 8-slot filter against tpubloom's with
  ``insert_path="sweep"``, where the per-device loop runs K1 (``_kernel``)
  in interpret mode inside ``shard_map`` (m=2^25, k=5, shards=8, 512 keys);
  K2, its counting twin, with a delete of 200 keys. Each interpret-mode
  reference runs once, in a module-scoped fixture;
* the scatter path at test_sharded.py's shapes (m=2^20, k=5, shards 8 and
  16) on 1, 2 and 8 slots, in all four layouts (blocked and flat, bit and
  counting): every placement holds the same words as tpubloom, so the
  same words as each other;
* the packed, staged and array surfaces, bytes, the flat Redis bitmap,
  checkpoint blobs and FileSink directories across the packages, the
  per-slot phases, and the guards."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tpubloom
from tpubloom import checkpoint as jck
from tpubloom.cpu_ref import murmur3_32_np
from tpubloom.ops import hashing as jhashing
from tpubloom.ops.sweep import choose_fat_params
from tpubloom.parallel.sharded import ShardedBloomFilter as JSharded
from tpubloom.parallel.sharded import make_mesh
from tpubloom_torch import FilterConfig, ShardedBloomFilter, checkpoint, interop
from tpubloom_torch.obs import context as obs
from tpubloom_torch.ops import hashing, sweep
from tpubloom_torch.parallel.sharded import make_slots, shard_popcounts
from tpubloom_torch.utils.packing import pack_keys

L = 16
SMALL = dict(m=1 << 20, k=5, key_len=L, block_bits=512)
LAYOUTS = {
    "blocked": {}, "counting": {"counting": True},
    "flat": {"block_bits": 0}, "flat_counting": {"block_bits": 0, "counting": True},
}
BLOCKED_LAYOUTS = ["blocked", "counting"]  # K1 and K2 run only in the blocked layouts


def _keys(rng, n):
    return [rng.bytes(16) for _ in range(n)]


def _cpu(n_slots):
    return ["cpu"] * n_slots


def _cfgs(layout, shards=8, **kw):
    d = {**SMALL, "shards": shards, **LAYOUTS[layout], **kw}
    return FilterConfig(**d), tpubloom.FilterConfig(**d)


def _counting(layout):
    return LAYOUTS[layout].get("counting", False)


# -- routing ---------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 3, 8, 64])
def test_route_shards_matches_tpubloom(n):
    rng = np.random.default_rng(n)
    keys = [rng.bytes(int(rng.integers(0, L + 1))) for _ in range(300)] + [b"", b"a"]
    ks, ls = pack_keys(keys, L)
    ls[-40:] = -1  # padding: hashes as length 0
    ks[-40:] = 0
    lens0 = np.maximum(ls, 0)
    seed = FilterConfig(**SMALL).seed
    got = hashing.route_shards(torch.from_numpy(ks), torch.from_numpy(ls), n, seed).numpy()
    want = np.asarray(jhashing.route_shards(jnp.asarray(ks), jnp.asarray(lens0), n_shards=n, seed=seed))
    oracle = murmur3_32_np(ks, lens0, seed ^ jhashing.SEED_XOR_ROUTE) % np.uint32(n)
    assert hashing.SEED_XOR_ROUTE == jhashing.SEED_XOR_ROUTE
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle)
    assert got.min() >= 0 and got.max() < n
    # padding is never owned, whatever its routing hash says
    route = hashing.ShardRoute(n, 0, n)
    _, owned = hashing.route_local(torch.from_numpy(ks), torch.from_numpy(ls), route, seed)
    assert owned[:-40].all() and not owned[-40:].any()


# -- K1 and K2 in interpret mode inside shard_map ----------------------------------

K1_KW = dict(m=1 << 25, k=5, key_len=L, block_bits=512, shards=8)


@pytest.fixture(scope="module")
def sweep_refs():
    """tpubloom's sharded filters with ``insert_path="sweep"`` on the
    8-device mesh: the bit filter after 512 inserts (K1 in interpret mode)
    and the counting filter after 512 inserts and 200 deletes (K2). Returns
    ``{layout: (keys, probe, words_logical, verdicts)}``."""
    rng = np.random.default_rng(9)
    keys = _keys(rng, 512)
    probe = keys[:200] + _keys(rng, 300)
    out = {}
    for layout in BLOCKED_LAYOUTS:
        j = JSharded(tpubloom.FilterConfig(**K1_KW, **LAYOUTS[layout], insert_path="sweep"),
                     mesh=make_mesh(8))
        j.insert_batch(keys)
        if layout == "counting":
            j.delete_batch(keys[:200])
        out[layout] = (keys, probe, j.words_logical, j.include_batch(probe))
    return out


def test_k1_is_the_per_device_kernel_at_this_shape():
    cfg = tpubloom.FilterConfig(**K1_KW)
    # 512 keys over 8 devices: 64 a device on 8192 local rows, which the
    # fat chooser rejects, so the per-device loop runs K1 (and K2)
    assert cfg.n_blocks_per_shard == 8192
    assert choose_fat_params(cfg.n_blocks_per_shard, 512 // 8, cfg.words_per_block) is None
    assert choose_fat_params(cfg.n_blocks_per_shard, 512 // 8, cfg.words_per_block,
                             counting=True) is None


@pytest.mark.parametrize("layout", BLOCKED_LAYOUTS)
def test_matches_k1_and_k2_in_shard_map(layout, sweep_refs):
    keys, probe, words, verdicts = sweep_refs[layout]
    f = ShardedBloomFilter(FilterConfig(**K1_KW, **LAYOUTS[layout]), devices=_cpu(8))
    f.insert_batch(keys)
    if layout == "counting":
        f.delete_batch(keys[:200])
        assert f.n_inserted == 312
    np.testing.assert_array_equal(f.words_logical, words)
    np.testing.assert_array_equal(f.include_batch(probe), verdicts)
    assert f.include_batch(keys[200:]).all()


# -- the scatter path on 1, 2 and 8 slots ----------------------------------------


@pytest.fixture(scope="module")
def scatter_refs():
    """tpubloom's sharded filters on their default (scatter) path:
    ``{(layout, shards): (keys, probe, words_logical, verdicts)}``, built
    when first asked for."""
    memo = {}

    def get(layout, shards):
        if (layout, shards) not in memo:
            rng = np.random.default_rng(11 + shards)
            keys = _keys(rng, 500) + [b"", b"a", b"sharded-key"]
            _, jcfg = _cfgs(layout, shards)
            j = JSharded(jcfg)
            j.insert_batch(keys)
            if _counting(layout):
                j.delete_batch(keys[:200])
            probe = keys[:100] + _keys(rng, 400) + [b"", b"a"]
            memo[layout, shards] = (keys, probe, j.words_logical, j.include_batch(probe))
        return memo[layout, shards]

    return get


@pytest.mark.parametrize("n_slots", [1, 2, 8])
@pytest.mark.parametrize("shards", [8, 16])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_every_placement_matches_tpubloom(layout, shards, n_slots, scatter_refs):
    keys, probe, words, verdicts = scatter_refs(layout, shards)
    cfg, _ = _cfgs(layout, shards)
    f = ShardedBloomFilter(cfg, devices=_cpu(n_slots))
    assert len(f.slot_words) == n_slots and f.shards_per_dev == shards // n_slots
    f.insert_batch(keys)
    if _counting(layout):
        f.delete_batch(keys[:200])
    np.testing.assert_array_equal(f.words_logical, words)
    np.testing.assert_array_equal(f.include_batch(probe), verdicts)


# -- the packed, staged and array surfaces -----------------------------------------


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_packed_staged_and_array_surfaces_match_tpubloom(layout):
    cfg, jcfg = _cfgs(layout)
    f, j = ShardedBloomFilter(cfg, devices=_cpu(4)), JSharded(jcfg)
    rows = np.frombuffer(np.arange(700, dtype=np.uint64).tobytes(), np.uint8).reshape(700, 8)
    assert f.insert_packed(rows) == j.insert_packed(rows) == 700
    hits = f.include_packed(rows)
    np.testing.assert_array_equal(hits, j.include_packed(rows))
    assert hits.all()
    # staged: the bytes keys of a batch, launched without a fence
    rng = np.random.default_rng(3)
    more = _keys(rng, 300)
    fence = f.launch_insert(f.stage_batch(more))
    assert fence is None  # the CPU's work is done when the call returns
    j.launch_insert(j.stage_batch(more))
    hits, n = f.launch_query(f.stage_batch(rows=rows[:100]))
    jhits, jn = j.launch_query(j.stage_batch(rows=rows[:100]))
    assert n == jn == 100
    np.testing.assert_array_equal(hits.numpy(), np.asarray(jhits))
    # arrays already on the device, with padding that must not count
    ks, ls = pack_keys(_keys(rng, 60) + [b""] * 4, L)
    ls[-4:] = -1
    f.insert_arrays(torch.from_numpy(ks), torch.from_numpy(ls), n_valid=60)
    j.insert_arrays(jnp.asarray(ks), jnp.asarray(ls), n_valid=60)
    np.testing.assert_array_equal(
        f.include_arrays(torch.from_numpy(ks), torch.from_numpy(ls)).numpy(),
        np.asarray(j.include_arrays(jnp.asarray(ks), jnp.asarray(ls))),
    )
    np.testing.assert_array_equal(f.words_logical, j.words_logical)
    assert (f.n_inserted, f.n_queried) == (j.n_inserted, j.n_queried) == (1060, 864)
    assert f.include(more[0]) and f.include(more[0]) == j.include(more[0])
    f.insert(b"scalar")
    assert b"scalar" in f


# -- state across the packages ---------------------------------------------------


@pytest.fixture(scope="module")
def filled():
    """``{layout: (port filter on 8 slots, tpubloom filter, keys)}`` after
    the same inserts (and deletes, counting)."""
    out = {}
    rng = np.random.default_rng(21)
    for layout in LAYOUTS:
        cfg, jcfg = _cfgs(layout, key_name=f"sharded-{layout}")
        keys = _keys(rng, 600)
        f, j = ShardedBloomFilter(cfg, devices=_cpu(8)), JSharded(jcfg)
        for x in (f, j):
            x.insert_batch(keys)
            if _counting(layout):
                x.delete_batch(keys[:100])
        out[layout] = (f, j, keys)
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_bytes_cross_both_ways(layout, filled):
    f, j, keys = filled[layout]
    assert f.to_bytes() == j.to_bytes()
    back = JSharded.from_bytes(j.config, f.to_bytes())
    np.testing.assert_array_equal(back.words_logical, f.words_logical)
    port = ShardedBloomFilter.from_bytes(f.config, j.to_bytes(), devices=_cpu(2))
    np.testing.assert_array_equal(port.words_logical, j.words_logical)
    assert port.include_batch(keys[100:]).all()
    if layout == "flat":  # shard-major Redis bitmaps, both ways
        bitmap = f.to_redis_bitmap()
        assert bitmap == j.to_redis_bitmap() and len(bitmap) == f.config.m // 8
        back = JSharded.from_redis_bitmap(j.config, bitmap)
        np.testing.assert_array_equal(back.words_logical, f.words_logical)
        port = ShardedBloomFilter.from_redis_bitmap(f.config, j.to_redis_bitmap(), devices=_cpu(4))
        np.testing.assert_array_equal(port.words_logical, j.words_logical)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_checkpoint_blobs_cross_both_ways(layout, filled):
    f, j, keys = filled[layout]
    _, _, jblob = jck.snapshot_blob(j, seq=7)
    port = checkpoint.restore_blob(jblob, device="cpu")
    assert isinstance(port, ShardedBloomFilter) and len(port.slot_words) == 1
    assert port.to_bytes() == j.to_bytes()
    assert (port.n_inserted, port.n_queried) == (j.n_inserted, j.n_queried)
    # the port's blob of the same state: the same header and payload
    _, _, pblob = checkpoint.snapshot_blob(f, seq=7)
    f_header, f_payload = checkpoint._deserialize(pblob)
    j_header, j_payload = checkpoint._deserialize(jblob)
    assert f_payload == j_payload
    assert f_header["format"] == j_header["format"]
    assert f_header["config"] == j_header["config"]
    back = jck.restore_blob(pblob)
    assert isinstance(back, JSharded)
    np.testing.assert_array_equal(back.words_logical, f.words_logical)
    probe = keys + _keys(np.random.default_rng(5), 200)
    np.testing.assert_array_equal(back.include_batch(probe), f.include_batch(probe))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_file_sink_directories_cross(layout, filled, tmp_path):
    f, j, keys = filled[layout]
    jck.save(j, jck.FileSink(str(tmp_path / "j")), seq=3)
    port = checkpoint.restore(f.config, checkpoint.FileSink(str(tmp_path / "j")), device="cpu")
    assert isinstance(port, ShardedBloomFilter) and port._restored_seq == 3
    assert port.to_bytes() == j.to_bytes() and port.n_inserted == j.n_inserted
    port.insert_batch(_keys(np.random.default_rng(6), 100))
    checkpoint.save(port, checkpoint.FileSink(str(tmp_path / "p")), seq=4)
    back = jck.restore(j.config, jck.FileSink(str(tmp_path / "p")))
    assert isinstance(back, JSharded) and back._restored_seq == 4
    assert back.to_bytes() == port.to_bytes() and back.n_inserted == port.n_inserted


def test_interop_builds_a_sharded_filter(filled):
    for layout in ("blocked", "flat"):
        f, j, keys = filled[layout]
        g = interop.filter_from_words(j.words_logical, interop.config_from_dict(j.config.to_dict()),
                                      "cpu", n_inserted=j.n_inserted)
        assert isinstance(g, ShardedBloomFilter)
        np.testing.assert_array_equal(interop.words_to_numpy(g), j.words_logical)
        assert g.include_batch(keys).all()


def test_stats_and_fill_ratios_match_tpubloom(filled):
    for bits, counts in (("blocked", "counting"), ("flat", "flat_counting")):
        f, j, _ = filled[bits]
        assert f.shard_fill_ratios() == j.shard_fill_ratios()
        got, want = f.stats(), j.stats()
        assert got.keys() == want.keys()
        # (n_queried is left out: other tests query these filters)
        for key in ("m", "k", "shards", "n_inserted", "bits_set", "fill_ratio_per_shard"):
            assert got[key] == want[key], key
        for key in ("fill_ratio", "estimated_fpr", "predicted_fpr", "fpr_drift"):
            assert got[key] == pytest.approx(want[key], rel=1e-12, abs=1e-18), key
        assert got["devices"] == 8
        assert f.bits_set() == got["bits_set"]
        fc, jc, _ = filled[counts]
        assert fc.shard_fill_ratios() is None and fc.stats().keys() == jc.stats().keys()


def test_shard_popcounts_reduce_each_shard():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 1 << 32, (5, 3, 7), dtype=np.uint64).astype(np.uint32)
    words[2] = 0xFFFFFFFF
    t = torch.from_numpy(words.view(np.int32)).view(torch.uint32)
    want = np.unpackbits(words.view(np.uint8).reshape(5, -1), axis=1).sum(axis=1)
    np.testing.assert_array_equal(shard_popcounts(t, max_elems=10).numpy(), want)


# -- per-slot phases and the guards ---------------------------------------------


def test_kernel_shard_phases_are_monotone_under_a_request():
    cfg, _ = _cfgs("blocked")
    f = ShardedBloomFilter(cfg, devices=_cpu(4))
    keys = [b"phase-%d" % i for i in range(256)]
    with obs.request("InsertBatch") as ictx:
        f.insert_batch(keys)
    with obs.request("QueryBatch") as qctx:
        assert f.include_batch(keys).all()
    with obs.request("InsertBatch") as pctx:
        f.insert_packed(np.zeros((64, 8), np.uint8))
    for ctx, kphase in ((ictx, "kernel"), (qctx, "kernel_query"), (pctx, "kernel")):
        spans = [ctx.phases.get(f"kernel_shard{i}") for i in range(4)]
        assert all(s is not None for s in spans), sorted(ctx.phases)
        assert spans == sorted(spans)
        assert kphase in ctx.phases and "kernel_shard4" not in ctx.phases
    # one slot: the single kernel span, as tpubloom keeps on one device
    g = ShardedBloomFilter(cfg, devices=_cpu(1))
    with obs.request("InsertBatch") as ctx:
        g.insert_batch(keys)
    assert "kernel" in ctx.phases and "kernel_shard0" not in ctx.phases


def test_no_card_and_no_devices_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, _ = _cfgs("blocked")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedBloomFilter(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_slots(8)
    with pytest.raises(ValueError, match="at least one device"):
        make_slots(8, [])


def test_slot_rules_follow_make_mesh():
    assert make_slots(8, _cpu(16)) == [torch.device("cpu")] * 8
    assert len(make_slots(16, _cpu(8))) == 8
    with pytest.raises(ValueError, match="incompatible"):
        make_slots(16, _cpu(3))
    with pytest.raises(ValueError, match="shards >= 2"):
        ShardedBloomFilter(FilterConfig(**SMALL), devices=_cpu(1))
    with pytest.raises(ValueError, match="m < 2"):
        ShardedBloomFilter(FilterConfig(m=1 << 31, k=5, counting=True, block_bits=512, shards=8),
                           devices=_cpu(1))


@pytest.mark.parametrize("counting", [False, True])
def test_flat_sharded_layouts_raise(counting):
    """Where tpubloom's flat sharded layouts raise, the port's do: no Redis
    bitmap of a counting or blocked array, no delete without counters."""
    cfg = FilterConfig(m=1 << 20, k=5, key_len=L, shards=8, counting=counting)
    f = ShardedBloomFilter(cfg, devices=_cpu(8))
    assert [tuple(w.shape) for w in f.slot_words] == [(1, (1 << 20) // 8 // (8 if counting else 32))] * 8
    if counting:
        with pytest.raises(ValueError, match="not Redis-bitmap exportable"):
            f.to_redis_bitmap()
        with pytest.raises(ValueError, match="restore via from_bytes"):
            ShardedBloomFilter.from_redis_bitmap(cfg, b"", devices=_cpu(2))
    else:
        with pytest.raises(ValueError, match="delete requires a counting config"):
            f.delete_batch([b"x"])
    blocked = FilterConfig(m=1 << 20, k=5, key_len=L, shards=8, block_bits=512)
    with pytest.raises(ValueError, match="not Redis-bitmap exportable"):
        ShardedBloomFilter(blocked, devices=_cpu(2)).to_redis_bitmap()
    blob = jck._serialize(tpubloom.FilterConfig(m=1 << 20, k=5, shards=8, counting=counting), 1,
                          np.zeros((1 << 20) // (8 if counting else 32), np.uint32))
    assert checkpoint.restore_blob(blob, device="cpu").bits_set() == 0


def test_delete_needs_counting_and_clear_empties():
    cfg, _ = _cfgs("blocked")
    f = ShardedBloomFilter(cfg, devices=_cpu(2))
    with pytest.raises(ValueError, match="counting"):
        f.delete_batch([b"x"])
    f.insert_batch([b"x", b"y"])
    f.clear()
    assert f.n_inserted == 0 and f.bits_set() == 0
    assert not f.include_batch([b"x", b"y"]).any()


def test_cpu_slots_take_the_plain_versions_and_count_no_launch():
    sweep.reset_launch_counts()
    cfg, _ = _cfgs("counting")
    f = ShardedBloomFilter(cfg, devices=_cpu(2))
    f.insert_batch([b"x"])
    f.delete_batch([b"x"])
    f.include_batch([b"x"])
    assert not any(sweep.launch_counts().values())
