"""The port's flat layout against tpubloom's, on the CPU, exact (tolerance
0 everywhere):

* ``positions``, ``split_word_bit`` and ``split_counter`` against
  ``tpubloom.ops.hashing`` and the numpy oracle ``cpu_ref.positions_np``,
  at power-of-two m up to 2^36 (the 64-bit walk with its u32 carry), at
  m=10,000,000 and at a prime m (the mod walk) — positions only, no state;
* the plain insert and query (``flat_insert_plain``, ``flat_query_plain``)
  and the plain counting pair against ``make_insert_fn``/``make_query_fn``
  and ``make_counter_fn``/``make_counting_query_fn``, and against
  ``cpu_ref.CPUBloomFilter``;
* ``BloomFilter`` and ``CountingBloomFilter`` words and verdicts against
  ``tpubloom``'s after inserts, deletes, saturation and flooring (verdicts
  on the valid prefix: tpubloom's unsharded flat query answers padding
  with the empty key's membership, the port with False);
* the Redis bitmap: bytes equal to tpubloom's and to ``cpu_ref``'s, at m
  that are not multiples of 8 or 32 too, and ``from_redis_bitmap`` both
  ways;
* ``redis_bitmap`` and flat ``counting_le_words`` checkpoint blobs and
  ``FileSink`` directories crossing both ways; ``stats`` and
  ``predicted_fpr``; ``migrate_checkpoint`` against ``tpubloom.migrate``;
* the fill gauges at m=2^26 with about half the bits set: the port counts
  exactly; tpubloom's float32 ``popcount_fill`` is held to float32
  rounding of the same count.

Sizes stay small (m <= 2^22, a few hundred keys) but for the
positions-only checks and the fill gauge."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpubloom
from tpubloom import checkpoint as jck
from tpubloom import migrate as jmigrate
from tpubloom.cpu_ref import CPUBloomFilter, positions_np
from tpubloom.filter import (
    make_counter_fn, make_counting_query_fn, make_insert_fn, make_query_fn,
)
from tpubloom.ops import bitops as jbitops
from tpubloom.ops import hashing as jhashing
from tpubloom.utils import packing as jpacking
from tpubloom_torch import BloomFilter, CountingBloomFilter, FilterConfig, checkpoint, interop
from tpubloom_torch import migrate
from tpubloom_torch.ops import bitops, counting, hashing, sweep
from tpubloom_torch.utils import packing
from tpubloom_torch.utils.packing import pack_keys, pack_keys_dense

L = 16
SEED = 0x9747B28C
PRIME = 1_000_003  # a prime m: the mod walk
M_SMALL = [1 << 20, 10_000_000]  # power of two, and config 1's m (the mod walk)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _packed(n, seed, key_len=L):
    """Keys of every length 0..key_len, numpy-seeded."""
    rng = np.random.default_rng(seed)
    lengths = (np.arange(n) % (key_len + 1)).astype(np.int32)
    return pack_keys_dense(rng.integers(0, 256, (n, key_len), dtype=np.uint8), lengths)


def _keys(rng, n):
    return [rng.bytes(int(rng.integers(0, L + 1))) for _ in range(n)]


def _padded(n, seed, n_pad=40):
    ks, ls = _packed(n, seed)
    ls[-n_pad:] = -1
    ks[-n_pad:] = 0
    return ks, ls


# -- positions ---------------------------------------------------------------------


@pytest.mark.parametrize("m", [1 << 20, 1 << 33, 1 << 36, 10_000_000, PRIME])
@pytest.mark.parametrize("key_len", [16, 28])
def test_positions_match_tpubloom(m, key_len):
    ks, ls = _packed(400, m % 1000 + key_len, key_len)
    k = 10
    hi, lo = hashing.positions(_t(ks), _t(ls), m=m, k=k, seed=SEED)
    jhi, jlo = jhashing.positions(jnp.asarray(ks), jnp.asarray(ls), m=m, k=k, seed=SEED)
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    exact = positions_np(ks, ls, m=m, k=k, seed=SEED)
    pos = (hi.numpy().astype(np.uint64) << np.uint64(32)) | lo.numpy().astype(np.uint64)
    np.testing.assert_array_equal(pos, exact)
    assert int(pos.max()) < m
    if m > 1 << 32:  # the high word carries
        assert hi.numpy().max() > 0
    word, bit = hashing.split_word_bit(hi, lo)
    jword, jbit = jhashing.split_word_bit(jhi, jlo)
    np.testing.assert_array_equal(word.numpy(), np.asarray(jword))
    np.testing.assert_array_equal(bit.numpy(), np.asarray(jbit))
    np.testing.assert_array_equal(word.numpy(), (exact >> np.uint64(5)).astype(np.int64))
    cword, nib = hashing.split_counter(hi, lo)
    jcword, jnib = jhashing.split_counter(jhi, jlo)
    np.testing.assert_array_equal(cword.numpy(), (exact >> np.uint64(3)).astype(np.int64))
    # tpubloom's counter word is int32 (counting m < 2^31); beyond, its low 32 bits
    np.testing.assert_array_equal((cword.numpy() & 0xFFFFFFFF).astype(np.uint32).view(np.int32),
                                  np.asarray(jcword))
    np.testing.assert_array_equal(nib.numpy(), np.asarray(jnib))


def test_positions_refuse_what_tpubloom_refuses():
    ks, ls = _packed(4, 0)
    for m in (1 << 37, (1 << 31) + 32):
        with pytest.raises(ValueError):
            jhashing.positions(jnp.asarray(ks), jnp.asarray(ls), m=m, k=3, seed=0)
        with pytest.raises(ValueError):
            hashing.positions(_t(ks), _t(ls), m=m, k=3, seed=0)


# -- the plain versions against tpubloom's pure functions ----------------------------


@pytest.mark.parametrize("m", M_SMALL)
def test_plain_insert_and_query_match_tpubloom(m):
    cfg = FilterConfig(m=m, k=7, key_len=L, seed=SEED)
    jcfg = tpubloom.FilterConfig(m=m, k=7, key_len=L, seed=SEED)
    jbits = jnp.zeros((cfg.n_words,), jnp.uint32)
    state = torch.zeros(cfg.n_words, dtype=torch.int32).view(torch.uint32)
    oracle = CPUBloomFilter(jcfg, use_native=False)
    ins, qry = make_insert_fn(jcfg), make_query_fn(jcfg)
    for step in range(3):
        ks, ls = _padded(300, 10 * step + m % 7)
        jbits = ins(jbits, jnp.asarray(ks), jnp.asarray(ls))
        bitops.flat_insert_plain(state, _t(ks), _t(ls), cfg)
        oracle.insert_batch([bytes(r[:n]) for r, n in zip(ks, ls) if n >= 0])
        words = state.view(torch.int32).numpy().view(np.uint32)
        np.testing.assert_array_equal(words, np.asarray(jbits))
        np.testing.assert_array_equal(words, oracle.words)
        probe, plen = _padded(300, 10 * step + 5)
        probe[:100], plen[:100] = ks[:100], ls[:100]
        got = bitops.flat_query_plain(state, _t(probe), _t(plen), cfg).numpy()
        want = np.asarray(qry(jbits, jnp.asarray(probe), jnp.asarray(plen)))
        np.testing.assert_array_equal(got[:-40], want[:-40])  # the valid prefix
        assert not got[-40:].any()  # padding answers False
        assert got[:100][plen[:100] >= 0].all()


@pytest.mark.parametrize("m", M_SMALL)
def test_plain_counting_matches_tpubloom(m):
    cfg = FilterConfig(m=m, k=7, key_len=L, counting=True)
    jcfg = tpubloom.FilterConfig(m=m, k=7, key_len=L, counting=True)
    jw = jnp.zeros((cfg.n_counter_words,), jnp.uint32)
    state = torch.zeros(cfg.n_counter_words, dtype=torch.int32).view(torch.uint32)
    inc, dec = make_counter_fn(jcfg, increment=True), make_counter_fn(jcfg, increment=False)
    qry = make_counting_query_fn(jcfg)
    ks, ls = _padded(300, m % 11)
    ks[100:130], ls[100:130] = ks[0], ls[0]  # one key 31 times: saturates at 15
    for fn, increment, batch in ((inc, True, (ks, ls)), (dec, False, (ks[:120], ls[:120])),
                                 (dec, False, _padded(200, 3)), (dec, False, (ks[:120], ls[:120]))):
        jw = fn(jw, jnp.asarray(batch[0]), jnp.asarray(batch[1]))
        counting.flat_counting_update_plain(state, _t(batch[0]), _t(batch[1]), cfg,
                                            increment=increment)
        np.testing.assert_array_equal(state.view(torch.int32).numpy().view(np.uint32),
                                      np.asarray(jw))
        got = counting.flat_counting_query_plain(state, _t(ks), _t(ls), cfg).numpy()
        want = np.asarray(qry(jw, jnp.asarray(ks), jnp.asarray(ls)))
        np.testing.assert_array_equal(got[:-40], want[:-40])
        assert not got[-40:].any()


# -- the filters -----------------------------------------------------------------------


@pytest.mark.parametrize("m", M_SMALL)
def test_bloom_filter_matches_tpubloom_and_oracle(m):
    kw = dict(m=m, k=7, key_len=L)
    port = BloomFilter(FilterConfig(**kw), device="cpu")
    ref = tpubloom.BloomFilter(tpubloom.FilterConfig(**kw))
    oracle = CPUBloomFilter(tpubloom.FilterConfig(**kw), use_native=False)
    rng = np.random.default_rng(m % 97)
    for _ in range(2):
        keys = _keys(rng, 400) + [b"", b"a"]
        for f in (port, ref, oracle):
            f.insert_batch(keys)
        rows = rng.integers(0, 256, (300, 12), dtype=np.uint8)
        assert port.insert_packed(rows) == ref.insert_packed(rows) == 300
        oracle.insert_batch([bytes(r) for r in rows])
        np.testing.assert_array_equal(port.words_logical, np.asarray(ref.words_logical))
        np.testing.assert_array_equal(port.words_logical, oracle.words)
        probe = keys[:150] + _keys(rng, 300)
        hits = port.include_batch(probe)
        np.testing.assert_array_equal(hits, ref.include_batch(probe))
        np.testing.assert_array_equal(hits, oracle.include_batch(probe))
        np.testing.assert_array_equal(port.include_packed(rows), ref.include_packed(rows))
    assert port.include(keys[0]) and b"a" in port
    assert port.n_inserted == ref.n_inserted
    bitmap = port.to_redis_bitmap()
    assert bitmap == ref.to_redis_bitmap() == oracle.to_redis_bitmap()
    assert len(bitmap) == (m + 7) // 8
    back = tpubloom.BloomFilter.from_redis_bitmap(ref.config, bitmap)
    np.testing.assert_array_equal(np.asarray(back.words), port.words_logical)
    again = BloomFilter.from_redis_bitmap(port.config, ref.to_redis_bitmap(), device="cpu")
    np.testing.assert_array_equal(again.words_logical, port.words_logical)
    assert again.include_batch(keys).all()


@pytest.mark.parametrize("m", M_SMALL)
def test_counting_filter_matches_tpubloom(m):
    kw = dict(m=m, k=7, key_len=L)
    port = CountingBloomFilter(FilterConfig(**kw), device="cpu")
    ref = tpubloom.CountingBloomFilter(tpubloom.FilterConfig(**kw))
    assert port.config.counting
    rng = np.random.default_rng(m % 89)
    keys = [rng.bytes(L) for _ in range(400)]  # distinct: no key shares a saturated counter
    hot = [b"hot-key"] * 20  # more than 15 copies: its counters saturate
    absent = [b"absent-%d" % i for i in range(50)]  # deletes floor at 0
    for f in (port, ref):
        f.delete_batch(absent)  # an empty filter stays empty
    assert not port.words_logical.any()
    for f in (port, ref):
        f.insert_batch(keys + hot)
        f.insert_batch(keys[:100])
        f.delete_batch(keys[:150])
        f.delete_batch(hot[:10])
    np.testing.assert_array_equal(port.words_logical, np.asarray(ref.words))
    assert port.n_inserted == ref.n_inserted
    probe = keys + hot[:1] + absent + _keys(rng, 200)
    hits = port.include_batch(probe)
    np.testing.assert_array_equal(hits, ref.include_batch(probe))
    # keys 0-99 went in twice, 150-399 once; the hot key survives 10 deletes
    assert hits[:100].all() and hits[150:400].all() and hits[400]
    port.delete(keys[399])
    ref.delete(keys[399])
    np.testing.assert_array_equal(port.words_logical, np.asarray(ref.words))
    for f in (port, ref):
        f.delete_batch(hot)  # 20 more copies than its counters hold: they floor at 0
    np.testing.assert_array_equal(port.words_logical, np.asarray(ref.words))
    assert not port.include(b"hot-key")
    assert port.to_bytes() == ref.to_bytes()
    back = CountingBloomFilter.from_bytes(port.config, ref.to_bytes(), device="cpu")
    np.testing.assert_array_equal(back.words_logical, port.words_logical)
    assert port.stats() == {"m": m, "k": 7, "n_inserted": port.n_inserted,
                            "n_queried": port.n_queried}


def test_flat_classes_refuse_other_layouts():
    with pytest.raises(ValueError, match="CountingBloomFilter"):
        BloomFilter(FilterConfig(m=1 << 20, k=7, counting=True), device="cpu")
    with pytest.raises(ValueError, match="BlockedBloomFilter"):
        BloomFilter(FilterConfig(m=1 << 20, k=7, block_bits=512), device="cpu")
    with pytest.raises(ValueError, match="m < 2"):
        CountingBloomFilter(FilterConfig(m=1 << 31, k=7, counting=True), device="cpu")
    with pytest.raises(ValueError, match="flat config given to a blocked"):
        sweep.blocked_query(torch.zeros(1 << 15, dtype=torch.int32).view(torch.uint32),
                            torch.zeros((4, L), dtype=torch.uint8),
                            torch.zeros(4, dtype=torch.int32), FilterConfig(m=1 << 20, k=7))
    with pytest.raises(ValueError, match="needs 32768"):
        sweep.flat_insert(torch.zeros(100, dtype=torch.int32).view(torch.uint32),
                          torch.zeros((4, L), dtype=torch.uint8),
                          torch.zeros(4, dtype=torch.int32), FilterConfig(m=1 << 20, k=7))


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    sweep.reset_launch_counts()
    f = BloomFilter(FilterConfig(m=1 << 20, k=7), device="cpu")
    c = CountingBloomFilter(FilterConfig(m=1 << 20, k=7), device="cpu")
    for x in (f, c):
        x.insert_batch([b"x"])
        assert x.include_batch([b"x"]).all()
    c.delete_batch([b"x"])
    assert not any(sweep.launch_counts().values())
    assert {n for n in sweep.LAUNCHES if "flat" in n} == {
        f"{p}flat_{op}" for p in ("", "sharded_")
        for op in ("insert", "query", "counting_update", "counting_query",
                   "counting_update_tiled", "counting_query_tiled", "insert_tiled")
    }


# -- the Redis bitmap -------------------------------------------------------------------


@pytest.mark.parametrize("m", [32, 1000, 1001, 1003, 4096 + 5, 1 << 16])
def test_redis_bitmap_codec_matches_tpubloom(m):
    rng = np.random.default_rng(m)
    words = rng.integers(0, 1 << 32, (m + 31) // 32, dtype=np.uint64).astype(np.uint32)
    data = packing.words_to_redis_bitmap(words, m)
    assert data == jpacking.words_to_redis_bitmap(words, m)
    assert len(data) == (m + 7) // 8
    np.testing.assert_array_equal(packing.redis_bitmap_to_words(data, m),
                                  jpacking.redis_bitmap_to_words(data, m))
    # SETBIT order: bit pos is bit 7 - (pos & 7) of byte pos >> 3
    pos = int(rng.integers(0, m))
    one = np.zeros_like(words)
    one[pos >> 5] = 1 << (pos & 31)
    got = packing.words_to_redis_bitmap(one, m)
    assert got[pos >> 3] == 1 << (7 - (pos & 7)) and sum(got) == got[pos >> 3]
    # a short or long string: missing bytes are zero, extra ones ignored
    for blob in (data[: len(data) // 2], data + b"\xff" * 9):
        np.testing.assert_array_equal(packing.redis_bitmap_to_words(blob, m),
                                      jpacking.redis_bitmap_to_words(blob, m))


# -- checkpoints, stats, interop and migration ------------------------------------------


FLAT_KINDS = {
    "flat": dict(m=10_000_000, k=7, key_len=L, key_name="flat-bits"),
    "flat_counting": dict(m=1 << 20, k=5, key_len=L, counting=True, key_name="flat-counts"),
}


def _state_bytes(f):
    return np.asarray(f.words_logical).astype("<u4").tobytes()


def _filled_pair(kind, seed):
    kw = FLAT_KINDS[kind]
    port = interop.new_filter(FilterConfig(**kw), "cpu")
    ref = (tpubloom.CountingBloomFilter if kind == "flat_counting" else tpubloom.BloomFilter)(
        tpubloom.FilterConfig(**kw))
    rng = np.random.default_rng(seed)
    keys = _keys(rng, 500)
    for f in (port, ref):
        f.insert_batch(keys + keys[:50])
        f.include_batch(keys[:10])
        if kind == "flat_counting":
            f.delete_batch(keys[:200])
    return port, ref, keys, rng


@pytest.mark.parametrize("kind", list(FLAT_KINDS))
def test_checkpoint_blobs_cross_both_ways(kind):
    port, ref, keys, rng = _filled_pair(kind, 51)
    _, _, jblob = jck.snapshot_blob(ref, seq=7)
    _, _, pblob = checkpoint.snapshot_blob(port, seq=7)
    jh, jp = checkpoint._deserialize(jblob)
    ph, pp = checkpoint._deserialize(pblob)
    assert ph["format"] == jh["format"] == ("counting_le_words" if kind == "flat_counting"
                                             else "redis_bitmap")
    assert pp == jp and ph["config"] == jh["config"] and ph["extra"] == jh["extra"]
    if kind == "flat":
        assert pp == port.to_redis_bitmap()
    # tpubloom -> port
    got = checkpoint.restore_blob(jblob, device="cpu")
    assert type(got) is type(port) and _state_bytes(got) == _state_bytes(ref)
    assert (got.n_inserted, got.n_queried) == (ref.n_inserted, ref.n_queried)
    probe = keys + _keys(rng, 300)
    np.testing.assert_array_equal(got.include_batch(probe), ref.include_batch(probe))
    # port -> tpubloom, after the port moves on
    got.insert_batch(_keys(rng, 200))
    _, _, blob = checkpoint.snapshot_blob(got, extra={"note": "x"})
    back = jck.restore_blob(blob)
    assert type(back) is type(ref) and _state_bytes(back) == _state_bytes(got)
    assert back.n_inserted == got.n_inserted and back._restored_meta["note"] == "x"


@pytest.mark.parametrize("kind", list(FLAT_KINDS))
def test_file_sink_directories_cross(kind, tmp_path):
    port, ref, keys, rng = _filled_pair(kind, 52)
    cfg = port.config
    jck.save(ref, jck.FileSink(str(tmp_path / "j")), seq=3)
    got = checkpoint.restore(cfg, checkpoint.FileSink(str(tmp_path / "j")), device="cpu")
    assert got._restored_seq == 3 and _state_bytes(got) == _state_bytes(ref)
    got.insert_batch(_keys(rng, 100))
    checkpoint.save(got, checkpoint.FileSink(str(tmp_path / "p")), seq=4)
    back = jck.restore(ref.config, jck.FileSink(str(tmp_path / "p")))
    assert back._restored_seq == 4 and _state_bytes(back) == _state_bytes(got)
    assert back.n_inserted == got.n_inserted


@pytest.mark.parametrize("m", [1 << 20, 10_000_000])
def test_stats_and_predicted_fpr_match_tpubloom(m):
    kw = dict(m=m, k=7, key_len=L)
    port = BloomFilter(FilterConfig(**kw), device="cpu")
    ref = tpubloom.BloomFilter(tpubloom.FilterConfig(**kw))
    keys = _keys(np.random.default_rng(8), 3000)
    for f in (port, ref):
        f.insert_batch(keys)
    got, want = port.stats(), ref.stats()
    assert got.keys() == want.keys()
    for key in ("m", "k", "n_inserted", "n_queried", "bits_set", "predicted_fpr"):
        assert got[key] == want[key], key
    assert got["fill_ratio"] == got["bits_set"] / m  # exact, in float64
    # tpubloom divides by m in float32: at a power-of-two m that is exact,
    # else it is float32 rounding of the same fill (ROADMAP queue 3)
    rel = 1e-12 if m & (m - 1) == 0 else 2 * float(np.finfo(np.float32).eps)
    for key in ("fill_ratio", "estimated_fpr", "fpr_drift"):
        assert got[key] == pytest.approx(want[key], rel=rel * 7, abs=1e-18), key
    assert port.predicted_fpr() == (1.0 - math.exp(-7 * 3000 / m)) ** 7 == ref.predicted_fpr()


def test_interop_carries_flat_filters_both_ways():
    for kind in FLAT_KINDS:
        port, ref, keys, _ = _filled_pair(kind, 53)
        cfg = interop.config_from_dict(ref.config.to_dict())
        got = interop.filter_from_words(np.asarray(ref.words_logical), cfg, "cpu",
                                        n_inserted=ref.n_inserted)
        assert type(got) is type(port)
        probe = keys + [b"absent-%d" % i for i in range(100)]
        np.testing.assert_array_equal(got.include_batch(probe), ref.include_batch(probe))
        np.testing.assert_array_equal(interop.words_to_numpy(got), np.asarray(ref.words_logical))


@pytest.mark.parametrize("lenient", [False, True])
def test_migrate_matches_tpubloom(lenient, tmp_path):
    kw = dict(m=1 << 20, k=7, key_len=L, key_name="urls")
    keys = _keys(np.random.default_rng(61), 700)
    ref = tpubloom.BloomFilter(tpubloom.FilterConfig(**kw))
    ref.insert_batch(keys)
    jck.save(ref, jck.FileSink(str(tmp_path / "src")), seq=1)
    stream = keys + ([b"never-inserted"] if lenient else [])
    out = {}
    for name, mod, sink_cls, extra in (("j", jmigrate, jck.FileSink, {}),
                                       ("p", migrate, checkpoint.FileSink, {"device": "cpu"})):
        cfg = (tpubloom.FilterConfig if name == "j" else FilterConfig)(**kw)
        out[name] = mod.migrate_checkpoint(
            sink_cls(str(tmp_path / "src")), iter(stream), dst_sink=sink_cls(str(tmp_path / name)),
            src_config=cfg, batch_size=256, strict=not lenient, **extra)
    for key in ("migrated", "missing", "dst_config"):
        assert out["p"][key] == out["j"][key], key
    assert out["p"]["missing"] == int(lenient)
    dst_cfg = tpubloom.FilterConfig.from_dict(out["j"]["dst_config"])
    jdst = jck.restore(dst_cfg, jck.FileSink(str(tmp_path / "j")))
    pdst = checkpoint.restore(FilterConfig.from_dict(out["p"]["dst_config"]),
                              checkpoint.FileSink(str(tmp_path / "p")), device="cpu")
    np.testing.assert_array_equal(pdst.words_logical, jdst.words_logical)
    assert pdst.include_batch(keys).all()
    with pytest.raises(ValueError, match="not this filter's source"):
        migrate.migrate_checkpoint(checkpoint.FileSink(str(tmp_path / "src")), [b"stranger"],
                                   src_config=FilterConfig(**kw), device="cpu")
    with pytest.raises(ValueError, match="flat single-device"):
        migrate.migrate_checkpoint(checkpoint.FileSink(str(tmp_path / "src")), [],
                                   src_config=FilterConfig(**kw, block_bits=512), device="cpu")


def test_migrate_cli_runs_without_jax(tmp_path):
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    kw = dict(m=1 << 16, k=5, key_len=L, key_name="cli")
    keys = [b"k%d" % i for i in range(300)]
    f = BloomFilter(FilterConfig(**kw), device="cpu")
    f.insert_batch(keys)
    checkpoint.save(f, checkpoint.FileSink(str(tmp_path)), seq=1)
    (tmp_path / "keys.txt").write_bytes(b"\n".join(keys) + b"\n")
    code = (
        "import sys, runpy\n"
        "sys.argv = ['migrate'] + sys.argv[1:]\n"
        "try:\n"
        "    runpy.run_module('tpubloom_torch.migrate', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "import tpubloom_torch.parallel.pipeline, tpubloom_torch.checkpoint\n"
        "import tpubloom_torch.server.resp, tpubloom_torch.utils.locks\n"
        "import tpubloom_torch.utils.tracing, tpubloom_torch.ops.checksum\n"
        "import tpubloom_torch.scalable, tpubloom_torch.faults, tpubloom_torch.obs.counters\n"
        "import tpubloom_torch.ops.cuckoo, tpubloom_torch.ops.cms, tpubloom_torch.sketch\n"
        "import tpubloom_torch.sketch.registry, tpubloom_torch.sketch.cuckoo\n"
        "import tpubloom_torch.sketch.cms, tpubloom_torch.interop\n"
        "import tpubloom_torch.parallel.distributed, tpubloom_torch.version\n"
        "import tpubloom_torch.analysis.lint, tpubloom_torch.analysis.lock_order\n"
        "import tpubloom_torch.analysis.__main__\n"
        "import tpubloom_torch.cpu_ref, tpubloom_torch.native\n"
        "for k in tpubloom_torch.sketch.registry.sketch_kinds():\n"
        "    tpubloom_torch.sketch.registry.spec(k).resolve()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'tpubloom')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code, "--src", str(tmp_path), "--key-name", "cli", "--m",
         str(1 << 16), "--k", "5", "--keys", str(tmp_path / "keys.txt"), "--device", "cpu",
         "--batch-size", "128"],
        cwd=root, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(root)},
    )
    assert out.returncode == 0, out.stderr
    assert '"migrated": 300' in out.stdout and '"missing": 0' in out.stdout


# -- the fill gauges at a state of 2^26 bits ---------------------------------------------


def test_fill_gauges_count_exactly_at_2_26_bits():
    m = 1 << 26
    rng = np.random.default_rng(26)
    words = rng.integers(0, 1 << 32, m // 32, dtype=np.uint64).astype(np.uint32)
    exact = int(np.unpackbits(words.view(np.uint8)).sum())
    assert exact > 1 << 24  # beyond float32's run of exact integers
    port = BloomFilter(FilterConfig(m=m, k=7), device="cpu")
    port._set_words(words)
    assert port.bits_set() == exact
    assert port.fill_ratio() == exact / m
    assert port.stats()["bits_set"] == exact
    # tpubloom sums the popcounts in float32 and divides in float32: held
    # to float32 rounding of the exact count (its difference from the exact
    # fill is recorded in ROADMAP queue 3)
    ref_fill = float(jbitops.popcount_fill(jnp.asarray(words), m))
    assert abs(ref_fill - exact / m) <= 4 * np.finfo(np.float32).eps * (exact / m)
