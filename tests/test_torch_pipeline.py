"""The port's streaming pipeline, async checkpointer and sinks
(``tpubloom_torch.parallel.pipeline``, ``tpubloom_torch.checkpoint``)
against tpubloom's, on the CPU, exact (tolerance 0):

* every test of tests/test_pipeline.py, run through both packages'
  ``StreamInserter`` on the same keys: the final words, the
  ``stream_offset`` of every retained checkpoint header, ``resume_offset``,
  crash recovery with bounded tail loss, sharded streams on 1, 2 and 8
  slots, prefetch giving identical state, and a pack error passed through
  the prefetch thread;
* the ``AsyncCheckpointer``: skip-when-busy, retention, ``last_landed_meta``
  and ``obs_stats``, a snapshot taken in stream order, failures raised from
  ``trigger`` (tests/test_checkpoint.py's cases);
* a stream's checkpoints restore in the other package, both ways, with
  equal words and ``resume_offset``; FileSink retention and the quarantine
  cap; ``inspect_quarantine`` agrees with tpubloom's;
* ``RedisSink`` against tests/fake_redis.py: the raw ``<key_name>`` bitmap
  equals tpubloom's, and each package restores the other's generations;
* ``utils.tracing`` writes a trace with the annotated spans; ``utils.locks``
  records lock order as tpubloom's does.

Streams are driven in ``checkpoint_every``-sized chunks with a ``flush``
between them where offsets are compared, so that no trigger is deferred
by a busy writer (as tests/test_pipeline.py does)."""

import glob
import json
import os
import time

import numpy as np
import pytest

import tpubloom
from tpubloom import checkpoint as jck
from tpubloom.parallel import pipeline as jpipe
from tpubloom.parallel.sharded import ShardedBloomFilter as JSharded
from tpubloom_torch import BloomFilter, FilterConfig, ShardedBloomFilter, StreamInserter
from tpubloom_torch import checkpoint as ck
from tpubloom_torch import resume_offset
from tpubloom_torch.utils import locks, tracing

from tests.fake_redis import FakeRedis

KW = dict(m=1 << 22, k=5, key_len=24, key_name="stream")


def _key_stream(start, stop):
    for i in range(start, stop):
        yield b"stream-key-%012d" % i


def _pair(**kw):
    d = {**KW, **kw}
    return (BloomFilter(FilterConfig(**d), device="cpu"),
            tpubloom.BloomFilter(tpubloom.FilterConfig(**d)))


def _words(j):
    return np.asarray(j.words).reshape(-1)


def _offsets(sink, key_name, deserialize):
    """``stream_offset`` of each retained generation, oldest first."""
    return [deserialize(sink.get(key_name, s))[0]["extra"]["stream_offset"]
            for s in sorted(sink.list_seqs(key_name))]


# -- the streams of tests/test_pipeline.py, through both packages ----------------


def test_stream_insert_all_present():
    f, j = _pair()
    stats = StreamInserter(f, batch_size=1024).run(_key_stream(0, 10_000))
    jstats = jpipe.StreamInserter(j, batch_size=1024).run(_key_stream(0, 10_000))
    assert stats == jstats and stats["inserted"] == 10_000
    np.testing.assert_array_equal(f.words_logical, _words(j))
    assert f.n_inserted == j.n_inserted == 10_000
    assert f.include_batch(list(_key_stream(0, 10_000))).all()
    assert not f.include_batch([b"absent-%d" % i for i in range(1000)]).any()


def test_stream_partial_batches_and_limit():
    f, j = _pair()
    ins, jins = StreamInserter(f, batch_size=1000), jpipe.StreamInserter(j, batch_size=1000)
    stats = ins.run(_key_stream(0, 2500), limit=2300)  # ragged batches, padded with -1
    assert stats == jins.run(_key_stream(0, 2500), limit=2300)
    assert stats["inserted"] == 2300 and f.n_inserted == j.n_inserted == 2300
    np.testing.assert_array_equal(f.words_logical, _words(j))
    assert f.include_batch(list(_key_stream(0, 2300))).all()
    assert not f.include_batch(list(_key_stream(2300, 2500))).any()
    # reentrant continuation of the same stream
    stats2 = ins.run(_key_stream(2300, 3000))
    assert stats2 == jins.run(_key_stream(2300, 3000))
    assert stats2["stream_offset"] == 3000
    np.testing.assert_array_equal(f.words_logical, _words(j))


def test_periodic_checkpoints_with_offsets(tmp_path):
    f, j = _pair()
    sink, jsink = ck.FileSink(str(tmp_path / "port")), jck.FileSink(str(tmp_path / "jax"))
    ins = StreamInserter(f, batch_size=500, sink=sink, checkpoint_every=2000)
    jins = jpipe.StreamInserter(j, batch_size=500, sink=jsink, checkpoint_every=2000)
    for lo in range(0, 10_000, 2000):
        ins.run(_key_stream(lo, lo + 2000))
        jins.run(_key_stream(lo, lo + 2000))
        assert ins.checkpointer.flush(timeout=120) and jins.checkpointer.flush(timeout=120)
    assert ins.checkpointer.checkpoints_written == jins.checkpointer.checkpoints_written == 5
    assert ins.close(final_checkpoint=True) and jins.close(final_checkpoint=True)
    assert ins.checkpointer.last_error is None
    # retention keeps the newest DEFAULT_RETAIN generations in both
    offsets = _offsets(sink, "stream", ck._deserialize)
    assert offsets == _offsets(jsink, "stream", jck._deserialize) == [6000, 8000, 10_000, 10_000]
    assert ck.DEFAULT_RETAIN == jck.DEFAULT_RETAIN == len(offsets)
    cfg, jcfg = f.config, j.config
    g, jg = ck.restore(cfg, sink, device="cpu"), jck.restore(jcfg, jsink)
    assert resume_offset(g) == jpipe.resume_offset(jg) == 10_000
    np.testing.assert_array_equal(g.words_logical, f.words_logical)
    np.testing.assert_array_equal(_words(jg), f.words_logical)
    assert g.include_batch(list(_key_stream(0, 10_000))).all()


def test_crash_recovery_bounded_tail_loss(tmp_path):
    """The process dies mid-stream (we stop feeding and drop the objects
    without a final checkpoint): the newest checkpoint covers its recorded
    offset, and a replay from there reconverges to the same words in both
    packages."""
    f, j = _pair()
    sink, jsink = ck.FileSink(str(tmp_path / "port")), jck.FileSink(str(tmp_path / "jax"))
    ins = StreamInserter(f, batch_size=500, sink=sink, checkpoint_every=3000)
    jins = jpipe.StreamInserter(j, batch_size=500, sink=jsink, checkpoint_every=3000)
    for lo, hi in ((0, 3000), (3000, 6000), (6000, 8000)):
        ins.run(_key_stream(lo, hi))
        jins.run(_key_stream(lo, hi))
        assert ins.checkpointer.flush(timeout=120) and jins.checkpointer.flush(timeout=120)
    del f, ins, j, jins

    g = ck.restore(FilterConfig(**KW), sink, device="cpu")
    jg = jck.restore(tpubloom.FilterConfig(**KW), jsink)
    off = resume_offset(g)
    assert off == jpipe.resume_offset(jg) == 6000
    assert 8000 - off <= 3000 + 500, "tail loss bounded by checkpoint_every + a batch"
    np.testing.assert_array_equal(g.words_logical, _words(jg))
    assert g.include_batch(list(_key_stream(0, off))).all()

    # resume: replay from the offset (idempotent), continue to 12000
    ins2 = StreamInserter(g, batch_size=500, sink=sink, checkpoint_every=3000, start_offset=off)
    jins2 = jpipe.StreamInserter(jg, batch_size=500, sink=jsink, checkpoint_every=3000,
                                 start_offset=off)
    stats, jstats = ins2.run(_key_stream(off, 12_000)), jins2.run(_key_stream(off, 12_000))
    assert stats["inserted"] == jstats["inserted"] == 12_000 - off
    assert stats["stream_offset"] == jstats["stream_offset"] == 12_000
    assert ins2.close() and jins2.close()
    np.testing.assert_array_equal(g.words_logical, _words(jg))
    assert g.include_batch(list(_key_stream(0, 12_000))).all()
    assert not g.include_batch([b"no-%d" % i for i in range(500)]).any()
    h = ck.restore(FilterConfig(**KW), sink, device="cpu")
    assert resume_offset(h) == 12_000


@pytest.mark.parametrize("n_slots", [1, 2, 8])
def test_stream_into_sharded(n_slots):
    kw = {**KW, "shards": 8, "key_name": "stream-sharded"}
    f = ShardedBloomFilter(FilterConfig(**kw), devices=["cpu"] * n_slots)
    j = JSharded(tpubloom.FilterConfig(**kw))
    assert StreamInserter(f, batch_size=512).run(_key_stream(0, 4000)) == \
        jpipe.StreamInserter(j, batch_size=512).run(_key_stream(0, 4000))
    np.testing.assert_array_equal(f.words_logical, j.words_logical)
    assert f.n_inserted == j.n_inserted == 4000
    assert f.include_batch(list(_key_stream(0, 4000))).all()


@pytest.mark.parametrize("prefetch", [1, 3])
def test_prefetch_overlap_identical_state(prefetch):
    """prefetch (a packing thread and a ring of staged slots) must not
    change results: the same stream gives the words of the synchronous
    path, and tpubloom's."""
    kw = dict(m=1 << 18, k=5, key_len=16)
    rng = np.random.default_rng(42)
    keys = [rng.bytes(16) for _ in range(20_000)]
    a, b = BloomFilter(FilterConfig(**kw), device="cpu"), BloomFilter(FilterConfig(**kw), device="cpu")
    j = tpubloom.BloomFilter(tpubloom.FilterConfig(**kw))
    sa = StreamInserter(a, batch_size=1 << 12).run(iter(keys))
    sb = StreamInserter(b, batch_size=1 << 12, prefetch=prefetch).run(iter(keys))
    sj = jpipe.StreamInserter(j, batch_size=1 << 12, prefetch=prefetch).run(iter(keys))
    assert sa == sb == sj and sa["inserted"] == len(keys)
    np.testing.assert_array_equal(a.words_logical, b.words_logical)
    np.testing.assert_array_equal(b.words_logical, _words(j))
    assert a.n_inserted == b.n_inserted == len(keys)


def test_prefetch_ring_under_a_short_switch_interval():
    """The ring's slots pass between the packing thread and the consumer:
    with a two-slot ring, tiny batches and a thread switch every
    microsecond, a slot refilled before its insert read it would change
    the words."""
    import sys

    kw = dict(m=1 << 16, k=5, key_len=16)
    keys = [b"ring-%08d" % i for i in range(6000)]
    a, b = BloomFilter(FilterConfig(**kw), device="cpu"), BloomFilter(FilterConfig(**kw), device="cpu")
    StreamInserter(a, batch_size=64).run(iter(keys))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        stats = StreamInserter(b, batch_size=64, prefetch=1).run(iter(keys))
    finally:
        sys.setswitchinterval(old)
    assert stats["inserted"] == len(keys)
    np.testing.assert_array_equal(a.words_logical, b.words_logical)


def test_prefetch_propagates_pack_errors():
    f = BloomFilter(FilterConfig(m=1 << 16, k=4, key_len=16), device="cpu")  # key_policy=error
    bad = [b"ok"] * 20 + [b"x" * 64]  # longer than key_len: pack_keys raises in the worker
    with pytest.raises(ValueError, match="key_len"):
        StreamInserter(f, batch_size=8, prefetch=2).run(iter(bad))
    j = tpubloom.BloomFilter(tpubloom.FilterConfig(m=1 << 16, k=4, key_len=16))
    with pytest.raises(ValueError, match="key_len"):
        jpipe.StreamInserter(j, batch_size=8, prefetch=2).run(iter(bad))


def test_prefetch_consumer_exit_stops_the_worker():
    """A consumer that stops early (a failing insert) ends the prefetch
    thread; the stream can run again afterwards."""
    f = BloomFilter(FilterConfig(**KW), device="cpu")
    ins = StreamInserter(f, batch_size=100, prefetch=2)
    real = f.insert_arrays
    calls = []

    def failing(*a, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("insert failed")
        return real(*a, **kw)

    f.insert_arrays = failing
    with pytest.raises(RuntimeError, match="insert failed"):
        ins.run(_key_stream(0, 5000))
    f.insert_arrays = real
    assert ins.run(_key_stream(0, 1000))["inserted"] == 1000


# -- the async checkpointer ------------------------------------------------------


def _rand_keys(n, rng):
    return [rng.bytes(16) for _ in range(n)]


def test_async_checkpointer(tmp_path):
    sink = ck.FileSink(str(tmp_path))
    f, j = _pair()
    cp = ck.AsyncCheckpointer(f, sink, every_n_inserts=1000)
    rng = np.random.default_rng(3)
    for _ in range(5):
        f.insert_batch(_rand_keys(500, rng))
        cp.notify_inserts(500)
    assert cp.close(final_checkpoint=True)
    assert cp.checkpoints_written >= 2
    assert cp.last_error is None
    g = ck.restore(f.config, sink, device="cpu")
    np.testing.assert_array_equal(f.words_logical, g.words_logical)  # the final one holds all
    jg = jck.restore(j.config, jck.FileSink(str(tmp_path)))  # and tpubloom reads it
    np.testing.assert_array_equal(_words(jg), f.words_logical)
    assert jg.n_inserted == g.n_inserted == 2500


def test_async_checkpointer_skips_when_busy(tmp_path):
    class SlowSink(ck.FileSink):
        def put(self, *a):
            time.sleep(0.2)
            super().put(*a)

    sink = SlowSink(str(tmp_path))
    f, _ = _pair()
    cp = ck.AsyncCheckpointer(f, sink)
    assert cp.trigger()
    assert not cp.trigger(), "second trigger while busy must be refused"
    assert cp.obs_stats()["in_flight"]
    cp.flush()
    cp.close(final_checkpoint=False)
    assert cp.checkpoints_written == 1


def test_async_checkpointer_retention_and_landed_meta(tmp_path):
    sink = ck.FileSink(str(tmp_path))
    f, j = _pair()
    jcp = jck.AsyncCheckpointer(j, jck.FileSink(str(tmp_path / "jax")))
    n = [0]
    cp = ck.AsyncCheckpointer(f, sink, retain=2, meta_fn=lambda: {"stream_offset": n[0]})
    assert cp.obs_stats().keys() == jcp.obs_stats().keys()
    jcp.close(final_checkpoint=False)
    assert cp.last_landed_meta is None and cp.obs_stats()["age_seconds"] is None
    for i in range(4):
        n[0] = 100 * (i + 1)
        f.insert_batch([b"k%d" % i])
        assert cp.trigger()
        n[0] = -1  # sampled at trigger time: a later change is not recorded
        assert cp.flush(timeout=60)
        assert cp.last_landed_meta["stream_offset"] == 100 * (i + 1)
        assert len(sink.list_seqs("stream")) == min(i + 1, 2)
    stats = cp.obs_stats()
    assert stats["checkpoints_written"] == 4 and stats["last_error"] is None
    assert stats["seq"] == cp.seq == sink.latest_seq("stream")
    assert stats["lag_inserts"] == 0 and not stats["in_flight"]
    assert stats["last_duration_seconds"] >= 0 and stats["age_seconds"] >= 0
    assert cp.last_landed_meta["n_inserted"] == 4
    cp.notify_inserts(7)
    assert cp.obs_stats()["lag_inserts"] == 7
    assert cp.close(final_checkpoint=False)


def test_async_checkpointer_sink_error_goes_to_last_error(tmp_path):
    class BrokenSink(ck.FileSink):
        def put(self, *a):
            raise OSError("disk full")

    f, _ = _pair()
    cp = ck.AsyncCheckpointer(f, BrokenSink(str(tmp_path)))
    assert cp.trigger()
    assert cp.flush(timeout=60)
    assert isinstance(cp.last_error, OSError) and "disk full" in cp.obs_stats()["last_error"]
    assert not cp.close(final_checkpoint=True), "a final write that failed must not report durable"


def test_async_checkpointer_snapshot_is_taken_at_trigger(tmp_path):
    """Inserts after trigger() are not in its checkpoint: the snapshot is
    queued in stream order, before the next launch."""
    class SlowSink(ck.FileSink):
        def put(self, *a):
            time.sleep(0.3)
            super().put(*a)

    sink = SlowSink(str(tmp_path))
    f, _ = _pair()
    f.insert_batch(list(_key_stream(0, 100)))
    before = f.words_logical.copy()
    cp = ck.AsyncCheckpointer(f, sink)
    assert cp.trigger()
    f.insert_batch(list(_key_stream(100, 5000)))  # while the write is in flight
    assert cp.flush(timeout=60)
    cp.close(final_checkpoint=False)
    g = ck.restore(f.config, sink, device="cpu")
    np.testing.assert_array_equal(g.words_logical, before)
    assert not np.array_equal(before, f.words_logical)


def test_async_checkpointer_failures_raise_from_trigger(tmp_path):
    f, _ = _pair()
    cp = ck.AsyncCheckpointer(f, ck.FileSink(str(tmp_path)))

    def boom():
        raise RuntimeError("payload kernel failed")

    f._state_tensors = boom  # the snapshot cannot be taken
    with pytest.raises(RuntimeError, match="payload kernel failed"):
        cp.trigger()
    assert not cp.obs_stats()["in_flight"], "a failed trigger leaves no write in flight"
    del f._state_tensors
    assert cp.trigger() and cp.flush(timeout=60)
    assert cp.close(final_checkpoint=False) and cp.checkpoints_written == 1

    # a scalable layer stack: a layer whose snapshot fails fails the trigger
    from tpubloom_torch import ScalableBloomFilter

    sf = ScalableBloomFilter(1000, 0.01, config=FilterConfig(m=64, k=1, key_len=24,
                                                             key_name="stack"), device="cpu")
    sf.insert_batch(list(_key_stream(0, 3000)))
    assert sf.n_layers == 2
    scp = ck.AsyncCheckpointer(sf, ck.FileSink(str(tmp_path / "s")))
    sf.layers[1]._state_tensors = boom
    with pytest.raises(RuntimeError, match="payload kernel failed"):
        scp.trigger()
    assert not scp.obs_stats()["in_flight"], "a failed trigger leaves no write in flight"
    del sf.layers[1]._state_tensors
    assert scp.trigger() and scp.flush(timeout=60)
    assert scp.close(final_checkpoint=False) and scp.checkpoints_written == 1
    g = ck.restore(sf.config, ck.FileSink(str(tmp_path / "s")), device="cpu")
    for a, b in zip(g.layers, sf.layers, strict=True):
        np.testing.assert_array_equal(a.words_logical, b.words_logical)


# -- blobs and sinks across the packages -------------------------------------------


@pytest.mark.parametrize("direction", ["port_to_tpubloom", "tpubloom_to_port"])
def test_stream_checkpoints_cross_both_ways(direction, tmp_path):
    f, j = _pair()
    if direction == "port_to_tpubloom":
        ins = StreamInserter(f, batch_size=700, sink=ck.FileSink(str(tmp_path)), checkpoint_every=3000)
        ins.run(_key_stream(0, 7777))
        assert ins.close()
        jpipe.StreamInserter(j, batch_size=700).run(_key_stream(0, 7777))
        got = jck.restore(j.config, jck.FileSink(str(tmp_path)))
        np.testing.assert_array_equal(_words(got), f.words_logical)
        assert jpipe.resume_offset(got) == 7777 and got.n_inserted == 7777
    else:
        jins = jpipe.StreamInserter(j, batch_size=700, sink=jck.FileSink(str(tmp_path)),
                                    checkpoint_every=3000)
        jins.run(_key_stream(0, 7777))
        assert jins.close()
        StreamInserter(f, batch_size=700).run(_key_stream(0, 7777))
        got = ck.restore(f.config, ck.FileSink(str(tmp_path)), device="cpu")
        np.testing.assert_array_equal(got.words_logical, _words(j))
        assert resume_offset(got) == 7777 and got.n_inserted == 7777
    np.testing.assert_array_equal(f.words_logical, _words(j))


@pytest.mark.parametrize("m", [1 << 22, 1_000_032])
def test_payload_and_crc_equal_tpubloom(m):
    """The port's blob of a stream's state carries tpubloom's payload
    bytes and CRC32C (at m = 1,000,032 a ragged last chunk of 2,124 bytes)."""
    f, j = _pair(m=m)
    keys = list(_key_stream(0, 3000))
    f.insert_batch(keys)
    j.insert_batch(keys)
    ph, pp = ck._deserialize(ck.snapshot_blob(f, seq=5)[2])
    jh, jp = jck._deserialize(jck.snapshot_blob(j, seq=5)[2])
    assert pp == jp and len(pp) == (m + 7) // 8
    assert ph["payload_crc32c"] == jh["payload_crc32c"]
    assert {k: v for k, v in ph.items() if k != "time"} == {k: v for k, v in jh.items() if k != "time"}


def test_file_sink_prune_and_quarantine_cap(tmp_path):
    f, _ = _pair(m=1 << 16)
    sink = ck.FileSink(str(tmp_path), quarantine_max_bytes=1)
    for s in range(1, 6):
        ck.save(f, sink, seq=s)
    assert sink.prune("stream", keep=3) == 2
    assert sink.list_seqs("stream") == [5, 4, 3]
    assert sink.prune("stream", keep=3) == 0
    # two corrupt generations: the cap keeps only the newest quarantined one
    for s in (5, 4):
        path = sink._path("stream", s)
        blob = bytearray(open(path, "rb").read())
        blob[-3] ^= 0xFF
        open(path, "wb").write(bytes(blob))
        time.sleep(0.01)  # distinct mtimes: the older corpse goes first
    g = ck.restore(f.config, sink, device="cpu")
    assert g._restored_seq == 3
    qdir = tmp_path / "corrupt"
    assert sorted(os.listdir(qdir)) == ["stream.000000000004.ckpt"]
    # inspect_quarantine agrees with tpubloom's on the same directory
    got, want = ck.inspect_quarantine(str(tmp_path)), jck.inspect_quarantine(str(tmp_path))
    assert got == want
    assert got["entries"][0]["diagnosis"] == "checkpoint payload CRC32C mismatch"
    assert got["entries"][0]["header"]["seq"] == 4
    assert ck.inspect_quarantine(str(tmp_path), purge=True)["purged"] == 1
    assert os.listdir(qdir) == []
    assert sink.prune("stream", keep=0) == 1 and sink.list_seqs("stream") == []


def test_redis_sink_against_tpubloom():
    srv = FakeRedis()
    try:
        f, j = _pair(key_name="redis-stream")
        keys = list(_key_stream(0, 4000))
        f.insert_batch(keys)
        j.insert_batch(keys)
        port_sink = ck.RedisSink("127.0.0.1", srv.port)
        ins = StreamInserter(f, batch_size=500, sink=port_sink, checkpoint_every=1000,
                             start_offset=4000)
        ins.run(_key_stream(4000, 5000))
        assert ins.checkpointer.flush(timeout=60)
        ins.run(_key_stream(5000, 6000))
        assert ins.close()
        jpipe.StreamInserter(j, batch_size=500).run(_key_stream(4000, 6000))
        # the raw bitmap under <key_name>: what the reference's driver reads
        raw = bytes(srv.data[b"redis-stream"])
        assert raw == j.to_redis_bitmap() == f.to_redis_bitmap()
        # tpubloom restores the port's generations, newest and older
        jsink = jck.RedisSink("127.0.0.1", srv.port)
        seqs = jsink.list_seqs("redis-stream")
        assert seqs == port_sink.list_seqs("redis-stream") and len(seqs) >= 2
        got = jck.restore(j.config, jsink)
        np.testing.assert_array_equal(_words(got), f.words_logical)
        assert jpipe.resume_offset(got) == 6000
        oldest = jck.restore(j.config, jsink, seq=seqs[-1])
        assert jpipe.resume_offset(oldest) == 5000
        # and the port restores tpubloom's
        j2 = tpubloom.BloomFilter(tpubloom.FilterConfig(**{**KW, "key_name": "redis-j"}))
        j2.insert_batch(keys)
        jck.save(j2, jsink, seq=11, extra={"stream_offset": 4000})
        jck.save(j2, jsink, seq=12, extra={"stream_offset": 4000})
        assert port_sink.list_seqs("redis-j") == [12, 11]
        g = ck.restore(FilterConfig(**{**KW, "key_name": "redis-j"}), port_sink, device="cpu")
        np.testing.assert_array_equal(g.words_logical, _words(j2))
        assert resume_offset(g) == 4000
        assert bytes(srv.data[b"redis-j"]) == j2.to_redis_bitmap()
        assert port_sink.prune("redis-j", keep=1) == 1 and jsink.list_seqs("redis-j") == [12]
        # a corrupt newest generation is quarantined and the previous one restores
        jck.save(j2, jsink, seq=13)
        srv.data[b"redis-j:tpubloom.ckpt:%012d" % 13][-1] ^= 0xFF
        g = ck.restore(FilterConfig(**{**KW, "key_name": "redis-j"}), port_sink, device="cpu")
        assert g._restored_seq == 12
        assert port_sink.list_seqs("redis-j") == jsink.list_seqs("redis-j") == [12]
        assert b"redis-j:tpubloom.ckpt.corrupt:%012d" % 13 in srv.data
        port_sink.close()
        jsink.close()
    finally:
        srv.close()


# -- tracing and locks -------------------------------------------------------------


def test_tracing_writes_a_trace_with_spans(tmp_path):
    f, _ = _pair(m=1 << 16)
    with tracing.trace(str(tmp_path / "t")) as d:
        with tracing.annotate("stream_batch", batch=64):
            f.insert_batch(list(_key_stream(0, 64)))
        with tracing.request_span("rpc", batch=8, rid="abc"):
            f.include_batch(list(_key_stream(0, 8)))
    files = glob.glob(os.path.join(d, "*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.load(open(files[0]))["traceEvents"]}
    assert "stream_batch[batch=64]" in names and "rpc[batch=8,rid=abc]" in names
    out, d2 = tracing.profile_call(lambda a, b=0: a + b, 2, b=3, log_dir=str(tmp_path / "p"))
    assert out == 5 and glob.glob(os.path.join(d2, "*.pt.trace.json"))


def test_locks_record_order_as_tpubloom():
    from tpubloom.utils import locks as jlocks

    for mod in (locks, jlocks):
        mod.reset()
        mod.set_enabled(True)
        try:
            a, b = mod.named_lock("t.a"), mod.named_lock("t.b")
            with a:
                with b:
                    pass
            with b:
                with a:  # closes a cycle: a lock-order violation
                    pass
            rep = mod.report()
        finally:
            mod.set_enabled(None)
            mod.reset()
        assert [v["kind"] for v in rep["violations"]] == ["lock-order-cycle"], rep
