"""The port's sketch kinds (tpubloom_torch.ops.cuckoo / ops.cms, the
sketch classes, their registry and checkpoint blobs) against tpubloom's,
on the CPU:

* ``derive`` and ``alt_bucket`` equal ``tpubloom.ops.cuckoo``'s;
* the plain cuckoo insert, delete and query (the kernels' plain versions)
  equal the JAX functions (slots, ``ok``, ``kicks``, ``deleted``,
  verdicts) on seeded batches at 2^6 to 2^12 slots, with an overfill
  (FULL keys, unwound chains), duplicates and padded lanes;
* the plain count-min update and estimate equal the JAX functions at
  power-of-two and other widths, with increments that wrap;
* ``CuckooFilter``, ``CountMinSketch`` and ``TopKSketch`` equal their
  tpubloom classes (words, flags, estimates, ``topk_list``, ``stats``);
* the registry surface, the ``cuckoo.kick`` / ``cms.update`` fault points
  and the counters, ``sketch_*_le_words`` blobs in both directions with the
  top-k heap and the kind guard;
* the properties of tests/test_sketch.py on the port (honest FULL: the
  accepted count equals the occupied slots; multiset insert, one-copy
  delete; count-min never undercounts).

All comparisons are exact (tolerance 0)."""

import collections
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpubloom
from tpubloom import checkpoint as jck
from tpubloom import faults as jfaults
from tpubloom.obs import counters as jcounters
from tpubloom.ops import cms as jcms
from tpubloom.ops import cuckoo as jcuckoo
from tpubloom.sketch import registry as jregistry
from tpubloom.sketch.cms import CountMinSketch as JCountMinSketch
from tpubloom.sketch.cms import TopKSketch as JTopKSketch
from tpubloom.sketch.cuckoo import CuckooFilter as JCuckooFilter
from tpubloom_torch import CountMinSketch, CuckooFilter, FilterConfig, TopKSketch
from tpubloom_torch import checkpoint as ck
from tpubloom_torch import faults
from tpubloom_torch import interop
from tpubloom_torch.obs import counters
from tpubloom_torch.ops import cms as pcms
from tpubloom_torch.ops import cuckoo as pcuckoo
from tpubloom_torch.ops import sweep
from tpubloom_torch.sketch import registry


@pytest.fixture(autouse=True)
def _disarm_all():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def _batch(rng, n, L=16, pad=0, dup=0):
    """Seeded keys ``uint8[n + pad, L]`` and lengths (``dup`` copies of key
    0 at the end of the valid part, ``pad`` padding rows after it)."""
    lens = rng.integers(1, L + 1, n).astype(np.int32)
    keys = rng.integers(0, 256, (n, L), dtype=np.uint8)
    keys[np.arange(L)[None, :] >= lens[:, None]] = 0
    if dup:
        keys[-dup:] = keys[0]
        lens[-dup:] = lens[0]
    keys = np.concatenate([keys, np.zeros((pad, L), np.uint8)])
    lens = np.concatenate([lens, np.full(pad, -1, np.int32)])
    return keys, lens


def _t(keys, lens):
    return torch.from_numpy(keys), torch.from_numpy(lens)


def _u32(t):
    return t.view(torch.int32).numpy().view(np.uint32)


# -- ops: the plain versions against the JAX functions ------------------------


@pytest.mark.parametrize("L", [8, 16, 32])
@pytest.mark.parametrize("n_buckets", [16, 1024])
def test_derive_and_alt_bucket_match_tpubloom(L, n_buckets):
    rng = np.random.default_rng(L + n_buckets)
    keys, lens = _batch(rng, 500, L, pad=12)
    seed = 0x1234567
    fp, i1 = pcuckoo.derive(*_t(keys, lens), n_buckets=n_buckets, seed=seed)
    jfp, ji1 = jcuckoo.derive(jnp.asarray(keys), jnp.asarray(lens), n_buckets=n_buckets, seed=seed)
    np.testing.assert_array_equal(fp.numpy(), np.asarray(jfp))
    np.testing.assert_array_equal(i1.numpy(), np.asarray(ji1))
    assert fp.min() >= 1 and fp.max() <= 0xFFFF
    mask = n_buckets - 1
    alt = pcuckoo.alt_bucket(i1, fp, mask)
    np.testing.assert_array_equal(
        alt.numpy(), np.asarray(jcuckoo.alt_bucket(ji1, jfp, jnp.uint32(mask))))
    np.testing.assert_array_equal(pcuckoo.alt_bucket(alt, fp, mask).numpy(), i1.numpy())
    assert [pcuckoo.alt_bucket(int(b), int(f), mask) for b, f in zip(i1[:20], fp[:20])] == \
        alt[:20].tolist()


def _jax_cuckoo(slots, fp, i1, valid):
    return (jnp.asarray(slots), jnp.asarray(fp.numpy().astype(np.uint32)),
            jnp.asarray(i1.numpy().astype(np.uint32)), jnp.asarray(valid.numpy()))


# (log2 slots, keys a batch, batches): the last two overfill their tables
CUCKOO_CASES = [(6, 40, 3), (8, 200, 2), (12, 2560, 2)]


@pytest.mark.parametrize("log2m,batch,n_batches", CUCKOO_CASES)
def test_plain_cuckoo_ops_match_jax(log2m, batch, n_batches):
    rng = np.random.default_rng(log2m)
    nb = (1 << log2m) // 4
    state = torch.zeros((nb, 4), dtype=torch.int32).view(torch.uint32)
    jslots = jnp.zeros((nb, 4), jnp.uint32)
    seen_full = seen_kicks = 0
    held = []
    for b in range(n_batches):
        keys, lens = _batch(rng, batch, pad=8, dup=3)
        fp, i1 = pcuckoo.derive(*_t(keys, lens), n_buckets=nb, seed=b + 5)
        valid = torch.from_numpy(lens >= 0)
        ok, kicks = pcuckoo.cuckoo_insert(state, fp, i1, valid)
        jslots, jok, jkicks = jcuckoo.cuckoo_insert(*_jax_cuckoo(jslots, fp, i1, valid))
        np.testing.assert_array_equal(_u32(state), np.asarray(jslots))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
        np.testing.assert_array_equal(kicks.numpy(), np.asarray(jkicks))
        assert not ok[-8:].any() and not kicks[-8:].any()
        seen_full += int((valid & ~ok).sum())
        seen_kicks += int(kicks.sum())
        held.append((fp, i1, valid))
        q = pcuckoo.cuckoo_query(state, fp, i1, valid)
        np.testing.assert_array_equal(
            q.numpy(), np.asarray(jcuckoo.cuckoo_query(*_jax_cuckoo(jslots, fp, i1, valid))))
        assert q[ok].all()
    if log2m > 6:
        assert seen_full > 0 and seen_kicks > 0, "the overfill must reject and kick"
    # deletes: the first batch's keys (its duplicates each take a copy), then
    # the same again (most absent now)
    fp, i1, valid = held[0]
    for _ in range(2):
        d = pcuckoo.cuckoo_delete(state, fp, i1, valid)
        jslots, jd = jcuckoo.cuckoo_delete(*_jax_cuckoo(jslots, fp, i1, valid))
        np.testing.assert_array_equal(_u32(state), np.asarray(jslots))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    assert pcuckoo.occupancy(state) == int(np.asarray(jcuckoo.occupancy(jslots)))


@pytest.mark.parametrize("width", [64, 992, 10_000])
def test_plain_cms_ops_match_jax(width):
    depth, seed = 5, 99
    rng = np.random.default_rng(width)
    cfg = types.SimpleNamespace(m=width, k=depth, seed=seed)
    state = torch.zeros((depth * width,), dtype=torch.int32).view(torch.uint32)
    jwords = jnp.zeros((depth * width,), jnp.uint32)
    for b in range(3):
        keys, lens = _batch(rng, 300, pad=20, dup=40)
        incs = rng.integers(0, 1 << 32, lens.shape[0], dtype=np.uint64)
        incs[:50] = 0xFFFFFFFF - rng.integers(0, 3, 50)  # counters wrap
        pcms.cms_update_plain(state, *_t(keys, lens), cfg,
                              torch.from_numpy(incs.astype(np.uint32).view(np.int32)).view(torch.uint32))
        pos = jcms.cms_positions(jnp.asarray(keys), jnp.asarray(lens), width=width, depth=depth,
                                 seed=seed)
        np.testing.assert_array_equal(
            pcms.cms_positions(*_t(keys, lens), width=width, depth=depth, seed=seed).numpy(),
            np.asarray(pos))
        valid = jnp.asarray(lens >= 0)
        jwords = jcms.cms_update(jwords, pos, valid, jnp.asarray(incs.astype(np.uint32)))
        np.testing.assert_array_equal(_u32(state), np.asarray(jwords))
        est = pcms.cms_estimate_plain(state, *_t(keys, lens), cfg)
        np.testing.assert_array_equal(_u32(est), np.asarray(jcms.cms_estimate(jwords, pos, valid)))
        # unit increments
        pcms.cms_update_plain(state, *_t(keys, lens), cfg)
        jwords = jcms.cms_update(jwords, pos, valid, jnp.ones(lens.shape, jnp.uint32))
        np.testing.assert_array_equal(_u32(state), np.asarray(jwords))


def test_plain_walks_record_the_buckets_they_read():
    cfg = FilterConfig(m=1 << 12, k=2, kind="cuckoo", seed=7)
    keys, lens = _t(*_batch(np.random.default_rng(3), 60, pad=5))
    fp, i1 = pcuckoo.derive(keys, lens, n_buckets=cfg.m // 4, seed=cfg.seed)
    first = set(i1[:60].tolist())
    state = torch.zeros(cfg.m, dtype=torch.int32).view(torch.uint32)
    reads: set = set()
    ok, _ = pcuckoo.cuckoo_insert_plain(state, keys, lens, cfg, reads)
    assert ok[:60].all() and reads == first  # a near-empty table: each key's first bucket
    reads = set()
    assert pcuckoo.cuckoo_delete_plain(state, keys, lens, cfg, reads)[:60].all()
    assert reads == first
    # an overfill: the same results as without the record, and each key's
    # first bucket, its second and its kick chain's among the reads
    small = cfg.replace(m=1 << 8)
    over, olens = _t(*_batch(np.random.default_rng(4), 400))
    a = torch.zeros(small.m, dtype=torch.int32).view(torch.uint32)
    b = torch.zeros(small.m, dtype=torch.int32).view(torch.uint32)
    reads = set()
    got = pcuckoo.cuckoo_insert_plain(a, over, olens, small, reads)
    want = pcuckoo.cuckoo_insert_plain(b, over, olens, small)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]) and torch.equal(a, b)
    assert int(want[1].sum()) > 0
    fp, i1 = pcuckoo.derive(over, olens, n_buckets=small.m // 4, seed=small.seed)
    i2 = pcuckoo.alt_bucket(i1, fp, small.m // 4 - 1)
    kicked = want[1] > 0
    assert set(i1.tolist()) | set(i2[kicked].tolist()) <= reads <= set(range(small.m // 4))


def test_wrappers_take_the_plain_versions_on_the_cpu_and_check_shapes():
    sweep.reset_launch_counts()
    cfg = FilterConfig(m=256, k=2, kind="cuckoo")
    state = torch.zeros(256, dtype=torch.int32).view(torch.uint32)
    keys, lens = _t(*_batch(np.random.default_rng(0), 50, pad=14))
    ok, kicks = sweep.cuckoo_insert(state, keys, lens, cfg)
    assert ok[:50].all() and sweep.cuckoo_query(state, keys, lens, cfg)[:50].all()
    assert sweep.cuckoo_delete(state, keys, lens, cfg)[:50].all()
    c = FilterConfig(m=96, k=3, kind="cms")
    grid = torch.zeros(288, dtype=torch.int32).view(torch.uint32)
    sweep.cms_update(grid, keys, lens, c, torch.full((64,), 3, dtype=torch.int32).view(torch.uint32))
    assert (_u32(sweep.cms_estimate(grid, keys, lens, c))[:50] >= 3).all()
    assert sum(sweep.launch_counts().values()) == 0, "the plain versions are not counted"
    with pytest.raises(ValueError, match="kind='cms'"):
        sweep.cuckoo_insert(grid, keys, lens, c)
    with pytest.raises(ValueError, match="needs 512"):
        sweep.cuckoo_insert(state, keys, lens, cfg.replace(m=512))
    with pytest.raises(ValueError, match="increments"):
        sweep.cms_update(grid, keys, lens, c, torch.ones(3, dtype=torch.int32).view(torch.uint32))
    with pytest.raises(ValueError, match="increments must be uint32"):
        sweep.cms_update(grid, keys, lens, c, torch.ones(64, dtype=torch.int64))


# -- the classes against tpubloom's ---------------------------------------------


def _cfgs(kind, **kw):
    return FilterConfig(kind=kind, **kw), tpubloom.FilterConfig(kind=kind, **kw)


def _keys(rng, n):
    return [rng.bytes(int(rng.integers(1, 17))) for _ in range(n)]


def test_cuckoo_filter_matches_tpubloom():
    pc, jc = _cfgs("cuckoo", m=1 << 10, k=2, seed=7, key_name="cf")
    p, j = CuckooFilter(pc, "cpu"), JCuckooFilter(jc)
    rng = np.random.default_rng(1)
    keys = _keys(rng, 1000)
    for chunk in (keys[:500], keys[500:] + keys[:20]):  # an overfill, duplicates
        p.insert_batch(chunk)
        j.insert_batch(chunk)
        np.testing.assert_array_equal(p.take_insert_flags(), j.take_insert_flags())
        np.testing.assert_array_equal(p.words_logical, np.asarray(j.words))
    assert p.take_insert_flags() is None
    probe = keys[:300] + _keys(rng, 300)
    np.testing.assert_array_equal(p.include_batch(probe), j.include_batch(probe))
    np.testing.assert_array_equal(p.delete_batch(keys[:200] + keys[:5]),
                                  j.delete_batch(keys[:200] + keys[:5]))
    np.testing.assert_array_equal(p.words_logical, np.asarray(j.words))
    rows = np.stack([np.frombuffer(k.ljust(16, b"\0"), np.uint8) for k in keys[:64]])
    p.insert_packed(rows[:, :12])
    j.insert_packed(rows[:, :12])
    np.testing.assert_array_equal(p.take_insert_flags(), j.take_insert_flags())
    np.testing.assert_array_equal(p.words_logical, np.asarray(j.words))
    assert p.stats() == j.stats()
    p.clear()
    j.clear()
    assert p.stats() == j.stats() and p.fill_ratio() == 0.0


@pytest.mark.parametrize("width", [992])
def test_count_min_sketch_matches_tpubloom(width):
    pc, jc = _cfgs("cms", m=width, k=4, seed=3, key_name="cms")
    p, j = CountMinSketch(pc, "cpu"), JCountMinSketch(jc)
    rng = np.random.default_rng(width)
    keys = _keys(rng, 200)
    stream = [keys[int(i)] for i in rng.zipf(1.3, 3000) % 200]
    for off in range(0, 3000, 700):
        p.insert_batch(stream[off : off + 700])
        j.insert_batch(stream[off : off + 700])
    weights = [int(w) for w in rng.integers(0, 1 << 32, 50)]
    np.testing.assert_array_equal(p.increment_batch(keys[:50], weights),
                                  j.increment_batch(keys[:50], weights))
    np.testing.assert_array_equal(p.words_logical, np.asarray(j.words))
    probe = keys + _keys(rng, 100)
    np.testing.assert_array_equal(p.estimate_batch(probe), j.estimate_batch(probe))
    np.testing.assert_array_equal(p.include_batch(probe), j.include_batch(probe))
    assert p.stats() == j.stats()
    with pytest.raises(ValueError, match="increments"):
        p.increment_batch([b"a"], [1, 2])
    with pytest.raises(ValueError, match="u32"):
        p.increment_batch([b"a"], [1 << 32])


def test_topk_sketch_matches_tpubloom():
    pc, jc = _cfgs("topk", m=1 << 10, k=4, topk=5, seed=3, key_name="tk")
    p, j = TopKSketch(pc, "cpu"), JTopKSketch(jc)
    rng = np.random.default_rng(5)
    keys = _keys(rng, 300)
    stream = [keys[int(i) % 300] for i in rng.zipf(1.2, 4000)]
    for off in range(0, 4000, 1000):
        p.insert_batch(stream[off : off + 1000])
        j.insert_batch(stream[off : off + 1000])
    assert p.topk_list() == j.topk_list()
    heaviest = collections.Counter(stream).most_common(1)[0][0]
    assert p.topk_list()[0][0] == heaviest
    p.increment_batch(keys[250:260], list(range(1000, 1010)))
    j.increment_batch(keys[250:260], list(range(1000, 1010)))
    assert p.topk_list() == j.topk_list()
    assert p.sketch_extra() == j.sketch_extra()
    np.testing.assert_array_equal(p.words_logical, np.asarray(j.words))
    assert p.stats() == j.stats()
    g = TopKSketch(pc, "cpu")
    g.load_sketch_extra(j.sketch_extra())
    assert g.topk_list() == p.topk_list()


# -- registry, faults, counters, new_filter --------------------------------------


def test_registry_surface_matches_tpubloom():
    assert registry.sketch_kinds() == jregistry.sketch_kinds()
    for kind in registry.sketch_kinds():
        s, js = registry.spec(kind), jregistry.spec(kind)
        assert (s.name, s.blob_format, s.replay_unsafe_insert, s.supports_delete) == \
            (js.name, js.blob_format, js.replay_unsafe_insert, js.supports_delete)
        assert s.factory == js.factory.replace("tpubloom.", "tpubloom_torch.", 1)
        assert s.resolve().__name__ == js.resolve().__name__
    cf = FilterConfig(m=64, k=2, kind="cuckoo")
    bl = FilterConfig(m=64, k=2)
    for fn in ("kind_of", "is_sketch", "replay_unsafe_insert", "supports_delete"):
        for c in (cf, bl, FilterConfig(m=64, k=4, kind="cms"), {"kind": "topk"}, {}):
            jc = c if isinstance(c, dict) else tpubloom.FilterConfig(**c.to_dict())
            assert getattr(registry, fn)(c) == getattr(jregistry, fn)(jc), (fn, c)
    assert isinstance(registry.build(cf, "cpu"), CuckooFilter)
    with pytest.raises(ValueError, match="unknown"):
        registry.spec("hyperloglog")
    assert isinstance(interop.new_filter(FilterConfig(m=64, k=4, kind="cms"), "cpu"),
                      CountMinSketch)
    assert isinstance(interop.new_filter(FilterConfig(m=64, k=4, kind="topk", topk=2), "cpu"),
                      TopKSketch)


def test_fault_points_fire_and_counters_move():
    assert faults.KNOWN_POINTS == jfaults.KNOWN_POINTS
    cf = CuckooFilter(FilterConfig(m=64, k=2, kind="cuckoo", key_name="cf"), "cpu")
    cms = CountMinSketch(FilterConfig(m=64, k=2, kind="cms", key_name="c"), "cpu")
    before = counters.global_counters()
    faults.arm("cuckoo.kick", "once")
    with pytest.raises(faults.InjectedFault, match="cuckoo.kick"):
        cf.insert_batch([b"x"])
    assert cf.fill_ratio() == 0.0, "the point fires before the kernel"
    cf.insert_batch([b"k%d" % i for i in range(150)])  # disarmed after once: 2x overfill
    flags = cf.take_insert_flags()
    faults.arm("cms.update", "always", pred={"filter": "c"})
    for call in (lambda: cms.insert_batch([b"x"]), lambda: cms.increment_batch([b"x"], [2]),
                 lambda: cms.insert_arrays(*_t(*_batch(np.random.default_rng(0), 4)))):
        with pytest.raises(faults.InjectedFault, match="cms.update"):
            call()
    assert cms.fill_ratio() == 0.0
    faults.disarm("cms.update")
    cms.insert_batch([b"x", b"y"])
    after = counters.global_counters()
    moved = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    assert moved["faults_injected"] == 4 and moved["fault_cuckoo_kick"] == 1
    assert moved["fault_cms_update"] == 3
    assert moved["cuckoo_full_rejections"] == 150 - int(flags.sum()) > 0
    assert moved["cuckoo_kicks_total"] > 0 and moved["cms_keys_incremented"] == 2
    # the same run in tpubloom moves its own counters alike
    jcf = JCuckooFilter(tpubloom.FilterConfig(m=64, k=2, kind="cuckoo", key_name="cf"))
    jbefore = jcounters.global_counters()
    jcf.insert_batch([b"k%d" % i for i in range(150)])
    np.testing.assert_array_equal(jcf.take_insert_flags(), flags)
    jafter = jcounters.global_counters()
    for name in ("cuckoo_full_rejections", "cuckoo_kicks_total"):
        assert jafter[name] - jbefore.get(name, 0) == moved[name], name


# -- checkpoint blobs ----------------------------------------------------------------


def _filled(kind, pkg):
    kw = {"cuckoo": dict(m=1 << 9, k=2), "cms": dict(m=992, k=4),
          "topk": dict(m=992, k=4, topk=4)}[kind]
    if pkg == "port":
        cls = {"cuckoo": CuckooFilter, "cms": CountMinSketch, "topk": TopKSketch}[kind]
        f = cls(FilterConfig(kind=kind, key_name=kind, **kw), "cpu")
    else:
        cls = {"cuckoo": JCuckooFilter, "cms": JCountMinSketch, "topk": JTopKSketch}[kind]
        f = cls(tpubloom.FilterConfig(kind=kind, key_name=kind, **kw))
    keys = [b"key-%d" % (i % 37) for i in range(400)]
    f.insert_batch(keys)
    f.include_batch(keys[:10])
    return f


def _heap(f):
    return f.topk_list() if hasattr(f, "topk_list") else None


@pytest.mark.parametrize("direction", ["port_to_tpubloom", "tpubloom_to_port"])
@pytest.mark.parametrize("kind", ["cuckoo", "cms", "topk"])
def test_sketch_blobs_cross_both_ways(kind, direction):
    port, ref = _filled(kind, "port"), _filled(kind, "tpubloom")
    pblob, jblob = bytes(ck.snapshot_blob(port, seq=9)[2]), jck.snapshot_blob(ref, seq=9)[2]
    (ph, pp), (jh, jp) = jck._deserialize(pblob), jck._deserialize(jblob)
    assert pp == jp, "the same payload bytes from both packages"
    assert {**ph, "time": 0} == {**jh, "time": 0}
    if direction == "port_to_tpubloom":
        src, dst = port, jck.restore_blob(pblob)
        words = np.asarray(dst.words)
    else:
        src, dst = ref, ck.restore_blob(jblob, device="cpu")
        words = dst.words_logical
    np.testing.assert_array_equal(words, np.asarray(src.words_logical))
    assert (dst.n_inserted, dst.n_queried) == (400, 10) == (src.n_inserted, src.n_queried)
    assert _heap(dst) == _heap(src)
    assert dst._restored_seq == 9


def test_sketch_blob_kind_guard():
    src = _filled("cms", "port")
    _, _, blob = ck.snapshot_blob(src, seq=1)
    header, payload = ck._deserialize(bytes(blob))
    wrong = ck._frame({**header, "format": "sketch_cuckoo_le_words"}, payload,
                      header["payload_crc32c"])
    for restore in (lambda b: ck.restore_blob(b, device="cpu"), jck.restore_blob):
        with pytest.raises(ValueError, match="does not match kind"):
            restore(bytes(wrong))
    with pytest.raises(ValueError, match="mismatch on kind"):
        ck.restore_blob(blob, FilterConfig(m=992, k=4, key_name="cms"), device="cpu")


# -- the properties of tests/test_sketch.py, on the port --------------------------


def _cuckoo(m=64, seed=3):
    return CuckooFilter(FilterConfig(m=m, k=2, seed=seed, kind="cuckoo"), "cpu")


@pytest.mark.parametrize("n,salt", [(1, 0), (17, 1), (63, 2), (64, 3), (100, 4), (120, 5)])
def test_cuckoo_full_is_honest(n, salt):
    """Every reported ok is a stored fingerprint: the accepted count equals
    the occupied slots exactly (a FULL chain that left moved copies behind
    would break it), accepted keys stay queryable, kicks stay bounded."""
    f = _cuckoo()
    keys = [b"p-%d-%d" % (salt, i) for i in range(n)]
    before = counters.get("cuckoo_kicks_total")
    f.insert_batch(keys)
    flags = f.take_insert_flags()
    assert int(flags.sum()) == f.stats()["occupied_slots"]
    accepted = [k for k, ok in zip(keys, flags) if ok]
    assert accepted and f.include_batch(accepted).all()
    assert 0 <= counters.get("cuckoo_kicks_total") - before <= n * pcuckoo.MAX_KICKS
    if n > 64:
        assert not flags.all()


def test_cuckoo_multiset_insert_and_one_copy_delete():
    f = _cuckoo(m=256)
    f.insert_batch([b"dup", b"dup", b"other"])
    assert f.take_insert_flags().all()
    assert f.delete_batch([b"dup"])[0] and f.include_batch([b"dup"])[0]
    assert f.delete_batch([b"dup"])[0] and not f.include_batch([b"dup"])[0]
    assert f.include_batch([b"other"])[0]
    assert not f.delete_batch([b"never-stored"])[0]


def test_cms_never_undercounts():
    width, depth = 64, 4
    f = CountMinSketch(FilterConfig(m=width, k=depth, seed=7, kind="cms"), "cpu")
    rng = np.random.default_rng(11)
    stream = [b"k-%02d" % rng.integers(0, 30) for _ in range(600)]
    for off in range(0, 600, 100):
        f.insert_batch(stream[off : off + 100])
    truth = collections.Counter(stream)
    keys = sorted(truth)
    est = f.estimate_batch(keys)
    for k, e in zip(keys, est):
        assert truth[k] <= e <= truth[k] + 2 * 600 / width + 1, k
    f.insert_batch([b"x", b"x", b"x", b"y"])
    assert (f.estimate_batch([b"x", b"y"]) >= [3, 1]).all()
