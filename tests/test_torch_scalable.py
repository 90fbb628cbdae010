"""The port's scalable bloom filter (tpubloom_torch.scalable) against
tpubloom's (tpubloom.scalable), on the CPU:

* ``layer_config`` equals tpubloom's over a grid of parameters;
* ``ScalableBloomFilter(device="cpu")`` against tpubloom's on the JAX CPU
  backend, flat and blocked bases, the same seeded keys: each layer's
  words, the verdicts, ``snapshot_meta`` and ``stats`` (the FPR gauges to
  float32 rounding: tpubloom sums a layer's fill in float32, the port
  counts it exactly), through several growth boundaries;
* a batch split at a growth boundary, ``clear``, and the same invalid
  parameters refused;
* ``scalable_stack`` blobs in both directions, and the ``expect_scalable``
  / ``scalable_expect`` refusals; an ``AsyncCheckpointer`` + ``FileSink``
  directory of a scalable filter restores in both packages."""

import numpy as np
import pytest

import tpubloom
from tpubloom import checkpoint as jck
from tpubloom import scalable as jscalable
from tpubloom_torch import FilterConfig, ScalableBloomFilter
from tpubloom_torch import checkpoint as ck
from tpubloom_torch import scalable

L = 16
BASES = {
    "flat": dict(m=64, k=1, key_len=L, key_name="sf"),
    "blocked": dict(m=512, k=1, key_len=L, key_name="sb", block_bits=512),
}


def _keys(rng, n):
    return [rng.bytes(int(rng.integers(1, L + 1))) for _ in range(n)]


def _pair(base, capacity=500, error_rate=0.01, **kw):
    port = ScalableBloomFilter(capacity, error_rate, config=FilterConfig(**BASES[base]),
                               device="cpu", **kw)
    ref = jscalable.ScalableBloomFilter(capacity, error_rate,
                                        config=tpubloom.FilterConfig(**BASES[base]), **kw)
    return port, ref


def _layer_words(ref_layer):
    return np.asarray(ref_layer.words_logical)


def _assert_same(port, ref):
    assert port.n_layers == ref.n_layers
    for p, j in zip(port.layers, ref.layers, strict=True):
        assert p.config.to_dict() == j.config.to_dict()
        np.testing.assert_array_equal(p.words_logical, _layer_words(j))
    assert port.snapshot_meta() == ref.snapshot_meta()


def _assert_same_stats(port, ref):
    ps, js = port.stats(), ref.stats()
    assert ps.keys() == js.keys()
    for key in ps:
        if key in ("estimated_fpr", "fpr_drift"):
            # tpubloom's layer fill is a float32 popcount ratio
            assert ps[key] == pytest.approx(js[key], rel=1e-5, abs=1e-7), key
        else:
            assert ps[key] == js[key], key


def _outcome(fn, *args, **kw):
    """``(config dict, capacity)``, or the error a config too small raises."""
    try:
        cfg, cap = fn(*args, **kw)
    except ValueError as e:
        return str(e)
    return cfg.to_dict(), cap


@pytest.mark.parametrize("base", ["flat", "blocked", "blocked_256"])
def test_layer_config_matches_tpubloom(base):
    kw = dict(BASES["blocked"], block_bits=256) if base == "blocked_256" else BASES[base]
    pbase, jbase = FilterConfig(**kw), tpubloom.FilterConfig(**kw)
    for capacity in (1, 100, 4_194_304):
        for error_rate in (0.2, 0.01, 1e-6):
            for growth, tightening in ((2, 0.5), (3, 0.8), (4, 0.9)):
                for layer in range(6):
                    got = _outcome(scalable.layer_config, pbase, capacity, error_rate, layer,
                                   growth=growth, tightening=tightening)
                    want = _outcome(jscalable.layer_config, jbase, capacity, error_rate, layer,
                                    growth=growth, tightening=tightening)
                    assert got == want
    assert scalable.LAYER_SEED_STRIDE == jscalable.LAYER_SEED_STRIDE


@pytest.mark.parametrize("base", ["flat", "blocked"])
def test_scalable_matches_tpubloom(base):
    port, ref = _pair(base, capacity=256)
    rng = np.random.default_rng(len(base))
    keys = _keys(rng, 2048)
    # layers of 256, 512, 1024, ...: calls of 512 straddle each growth boundary
    for off in range(0, 2048, 512):
        port.insert_batch(keys[off : off + 512])
        ref.insert_batch(keys[off : off + 512])
        _assert_same(port, ref)
    assert port.snapshot_meta()["layer_counts"] == [256, 512, 1024, 256]
    probe = keys[::4] + _keys(rng, 512)
    got = port.include_batch(probe)
    np.testing.assert_array_equal(got, ref.include_batch(probe))
    assert got[:512].all(), "no false negatives"
    assert port.include(keys[17]) and keys[17] in port
    _assert_same_stats(port, ref)
    assert port.stats()["compound_fpr_bound"] == ref.compound_fpr_bound()
    assert port.config == FilterConfig(**BASES[base])


@pytest.mark.parametrize("base", ["flat", "blocked"])
def test_split_at_a_growth_boundary_and_clear(base):
    port, ref = _pair(base, capacity=100, growth=3, tightening=0.8)
    keys = [b"split-%d" % i for i in range(1000)]  # 100 + 300 + 600: three layers, one call
    port.insert_batch(keys)
    ref.insert_batch(keys)
    _assert_same(port, ref)
    assert port.snapshot_meta()["layer_counts"] == [100, 300, 600]
    assert port.stats()["capacity_current_layer"] == 900
    port.insert(b"one more")
    ref.insert(b"one more")
    _assert_same(port, ref)
    port.clear()
    ref.clear()
    _assert_same(port, ref)
    assert port.n_inserted == 0 and port.n_layers == 1
    assert not port.include_batch(keys[:50]).any()


@pytest.mark.parametrize("kwargs,match", [
    (dict(config=FilterConfig(m=64, k=1, counting=True)), "counting"),
    (dict(capacity=0), "capacity"),
    (dict(error_rate=1.0), "error_rate"),
    (dict(error_rate=0.0), "error_rate"),
    (dict(growth=1), "growth"),
    (dict(tightening=1.0), "tightening"),
    (dict(tightening=0.0), "tightening"),
])
def test_invalid_parameters_refused_as_in_tpubloom(kwargs, match):
    args = {"capacity": 100, "error_rate": 0.01, **kwargs}
    jargs = dict(args)
    if "config" in jargs:
        jargs["config"] = tpubloom.FilterConfig(**jargs["config"].to_dict())
    with pytest.raises(ValueError, match=match) as got:
        ScalableBloomFilter(device="cpu", **args)
    with pytest.raises(ValueError, match=match) as want:
        jscalable.ScalableBloomFilter(**jargs)
    assert str(got.value) == str(want.value)


def _filled(base, pkg):
    cfg = BASES[base]
    if pkg == "port":
        f = ScalableBloomFilter(300, 0.02, config=FilterConfig(**cfg), device="cpu")
    else:
        f = jscalable.ScalableBloomFilter(300, 0.02, config=tpubloom.FilterConfig(**cfg))
    f.insert_batch([b"blob-%d" % i for i in range(1500)])
    return f


@pytest.fixture(scope="module")
def stacks():
    """Per base: the same stack filled in each package, and each one's blob."""
    out = {}
    for base in BASES:
        port, ref = _filled(base, "port"), _filled(base, "tpubloom")
        out[base] = (port, ref, bytes(ck.snapshot_blob(port, seq=4)[2]),
                     jck.snapshot_blob(ref, seq=4)[2])
    return out


@pytest.mark.parametrize("direction", ["port_to_tpubloom", "tpubloom_to_port"])
@pytest.mark.parametrize("base", ["flat", "blocked"])
def test_scalable_blobs_cross_both_ways(stacks, base, direction):
    port, ref, pblob, jblob = stacks[base]
    (ph, pp), (jh, jp) = jck._deserialize(pblob), jck._deserialize(jblob)
    assert pp == jp, "the same payload: the layers' LE words one after the other"
    assert {**ph, "time": 0} == {**jh, "time": 0}
    assert ph["format"] == "scalable_stack" and len(ph["scalable"]["layer_nbytes"]) == 3
    cfg = FilterConfig(**BASES[base])
    if direction == "port_to_tpubloom":
        dst = jck.restore_blob(pblob, tpubloom.FilterConfig(**BASES[base]), expect_scalable=True,
                               scalable_expect={"capacity": 300, "growth": 2})
        _assert_same(port, dst)
    else:
        dst = ck.restore_blob(jblob, cfg, device="cpu", expect_scalable=True,
                              scalable_expect={"capacity": 300, "error_rate": 0.02})
        _assert_same(dst, ref)
        assert dst._restored_seq == 4 and dst.n_inserted == 1500
        assert dst.include_batch([b"blob-%d" % i for i in range(1500)]).all()
    with pytest.raises(ValueError, match="holds a scalable layer stack"):
        ck.restore_blob(jblob, cfg, device="cpu", expect_scalable=False)
    with pytest.raises(ValueError, match="policy mismatch on capacity"):
        ck.restore_blob(jblob, cfg, device="cpu", scalable_expect={"capacity": 301})
    with pytest.raises(ValueError, match="mismatch on base seed"):
        ck.restore_blob(jblob, cfg.replace(seed=1), device="cpu")
    fixed = ck.snapshot_blob(port.layers[0], seq=5)[2]
    with pytest.raises(ValueError, match="holds a fixed-size filter"):
        ck.restore_blob(fixed, port.layers[0].config, device="cpu", expect_scalable=True)


def test_restore_refuses_a_stack_of_another_policy(stacks):
    header, payload = ck._deserialize(stacks["flat"][2])
    meta = dict(header["scalable"])
    meta["layer_configs"] = [dict(c) for c in meta["layer_configs"]]
    meta["layer_configs"][1]["k"] += 1
    blob = jck._frame({**header, "scalable": meta}, payload)
    with pytest.raises(ValueError, match="layer 1 config mismatch"):
        ck.restore_blob(blob, device="cpu")


def test_async_checkpointer_file_sink(tmp_path):
    port = _filled("blocked", "port")
    sink = ck.FileSink(str(tmp_path))
    cp = ck.AsyncCheckpointer(port, sink, every_n_inserts=1000)
    cp.notify_inserts(1500)  # triggers
    assert cp.flush(timeout=60) and cp.checkpoints_written == 1
    before = [layer.words_logical for layer in port.layers]
    port.insert_batch([b"late-%d" % i for i in range(2000)])  # after the snapshot: a new layer
    assert cp.close(final_checkpoint=False) and cp.last_error is None
    g = ck.restore(port.config, sink, device="cpu", expect_scalable=True)
    assert g.n_layers == len(before) < port.n_layers
    for layer, words in zip(g.layers, before, strict=True):
        np.testing.assert_array_equal(layer.words_logical, words)
    j = jck.restore(tpubloom.FilterConfig(**BASES["blocked"]), jck.FileSink(str(tmp_path)))
    _assert_same(g, j)
    assert j.include_batch([b"blob-%d" % i for i in range(1500)]).all()
