"""The port's CPU driver (``tpubloom_torch.cpu_ref``, ``CPUScalableBloomFilter``)
and ``pack_keys`` against ``tpubloom``'s, on the CPU, exact (tolerance 0):

* ``CPUBloomFilter`` (plain, and counting with saturation at 15 and the
  floor at 0) and ``CPUBlockedBloomFilter`` (both in-block hashes) against
  ``tpubloom.cpu_ref``'s classes: words, verdicts, ``fill_ratio``,
  ``estimated_fpr``, ``to_bytes`` and the Redis bitmap; the C++ path and
  the numpy path bit for bit;
* the CPU classes against the port's own ``device="cpu"`` filters
  (``BlockedBloomFilter``, ``BloomFilter``, ``CountingBloomFilter``):
  ``to_bytes`` equal, and ``from_bytes`` across the two both ways;
* ``CPUScalableBloomFilter`` against ``tpubloom``'s as the stack grows
  past two layers: layers, each layer's words, verdicts, stats;
* ``pack_keys``: its C++ scatter, its numpy scatter and
  ``tpubloom.utils.packing.pack_keys`` give the same bytes and lengths;
* import hygiene: ``tpubloom_torch.cpu_ref`` loads neither torch nor JAX.

Sizes stay small: m <= 2^20, a few thousand keys."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import tpubloom
from tpubloom import cpu_ref as jcpu
from tpubloom import scalable as jscalable
from tpubloom.utils import packing as jpacking
from tpubloom_torch import (
    BlockedBloomFilter, BloomFilter, CountingBloomFilter, CPUBlockedBloomFilter, CPUBloomFilter,
    CPUScalableBloomFilter, FilterConfig, ScalableBloomFilter,
)
from tpubloom_torch import native
from tpubloom_torch.utils import packing

L = 16
ROOT = Path(__file__).resolve().parent.parent
FLAT = {
    "pow2": dict(m=1 << 16, k=7),
    "config1_m": dict(m=10_000_000, k=7),  # BASELINE config 1's m: the mod walk
    "k3": dict(m=99_968, k=3),
}
COUNTING = {"pow2": dict(m=1 << 14, k=7), "mod": dict(m=99_968, k=5)}
BLOCKED = {
    "chunk": dict(m=1 << 16, k=7, block_bits=512),
    "ap": dict(m=1 << 16, k=7, block_bits=512, block_hash="ap"),
    "chunk_256": dict(m=1 << 15, k=6, block_bits=256),
    "ap_1024": dict(m=1 << 20, k=11, block_bits=1024, block_hash="ap"),
}


def _keys(seed: int, n: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(x)) for x in rng.integers(0, L + 1, n)]


def _pair(cls_port, cls_ref, kw, **opts):
    return (cls_port(FilterConfig(**kw, key_len=L), **opts),
            cls_ref(tpubloom.FilterConfig(**kw, key_len=L), **opts))


@pytest.mark.parametrize("use_native", [True, False, None])
@pytest.mark.parametrize("name", list(FLAT))
def test_cpu_bloom_matches_tpubloom(name, use_native):
    port, ref = _pair(CPUBloomFilter, jcpu.CPUBloomFilter, FLAT[name], use_native=use_native)
    assert port.use_native == ref.use_native == (use_native is not False)
    held, fresh = _keys(1, 1500), _keys(2, 1500)
    for f in (port, ref):
        f.insert_batch(held[:1000])
        f.insert_batch(held[1000:])
        f.insert(b"")  # a key of length 0
    assert np.array_equal(port.words, ref.words)
    for keys in (held, fresh, [b"", b"x"]):
        got = port.include_batch(keys)
        assert got.dtype == bool and np.array_equal(got, ref.include_batch(keys))
    assert port.include_batch(held).all() and port.include(b"")
    assert port.fill_ratio() == ref.fill_ratio()
    assert port.estimated_fpr() == ref.estimated_fpr()
    assert port.to_bytes() == ref.words.astype("<u4").tobytes()
    assert port.to_redis_bitmap() == ref.to_redis_bitmap()
    back = CPUBloomFilter.from_redis_bitmap(port.config, port.to_redis_bitmap())
    assert np.array_equal(back.words, port.words)
    assert port.n_inserted == ref.n_inserted
    port.clear()
    assert not port.words.any() and port.n_inserted == 0


def test_native_and_numpy_paths_are_bit_identical():
    keys, probe = _keys(3, 4000), _keys(4, 4000)
    for kw, cls in ((FLAT["config1_m"], CPUBloomFilter), (BLOCKED["chunk"], CPUBlockedBloomFilter),
                    (BLOCKED["ap"], CPUBlockedBloomFilter)):
        a, b = cls(FilterConfig(**kw), use_native=True), cls(FilterConfig(**kw), use_native=False)
        a.insert_batch(keys)
        b.insert_batch(keys)
        assert a.to_bytes() == b.to_bytes()
        assert np.array_equal(a.include_batch(probe), b.include_batch(probe))


@pytest.mark.parametrize("name", list(COUNTING))
def test_cpu_counting_matches_tpubloom(name):
    """Repeats past 15 saturate; deletes past 0 floor; tpubloom's counter
    loop is the reference of the port's vectorized update."""
    port, ref = _pair(CPUBloomFilter, jcpu.CPUBloomFilter, dict(COUNTING[name], counting=True))
    assert not port.use_native and not ref.use_native
    held, hot, absent = _keys(5, 600), _keys(6, 4), _keys(7, 300)
    steps = [
        ("insert_batch", held + hot * 20),        # hot keys' counters saturate at 15
        ("delete_batch", held[:200] + hot * 9),   # 15 - 9: a saturated counter lost its count
        ("insert_batch", hot * 3),
        ("delete_batch", absent + hot * 30),      # absent keys and hot keys floor at 0
        ("delete", held[300]),
        ("insert", held[300]),
    ]
    peaks = []
    for op, arg in steps:
        getattr(port, op)(arg)
        getattr(ref, op)(arg)
        assert np.array_equal(port.words, ref.words), op
        for keys in (held, hot, absent):
            assert np.array_equal(port.include_batch(keys), ref.include_batch(keys))
        assert port.n_inserted == ref.n_inserted
        peaks.append(int(((port.words[:, None] >> (4 * np.arange(8, dtype=np.uint32))) & 15).max()))
    assert peaks[0] == 15  # saturation showed
    assert not port.include_batch(hot).any()  # the hot keys floored at 0
    with pytest.raises(ValueError, match="native path covers plain filters only"):
        CPUBloomFilter(FilterConfig(**COUNTING[name], counting=True), use_native=True)
    for fn in (port.fill_ratio, port.to_redis_bitmap):
        with pytest.raises(ValueError):
            fn()
    with pytest.raises(ValueError, match="delete requires a counting filter"):
        CPUBloomFilter(FilterConfig(m=1 << 10, k=3)).delete_batch([b"a"])


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("name", list(BLOCKED))
def test_cpu_blocked_matches_tpubloom(name, use_native):
    port, ref = _pair(CPUBlockedBloomFilter, jcpu.CPUBlockedBloomFilter, BLOCKED[name],
                      use_native=use_native)
    assert port.config.block_hash == ref.config.block_hash
    held, fresh = _keys(8, 2000), _keys(9, 2000)
    for f in (port, ref):
        f.insert_batch(held)
        f.insert(held[0])
    assert port.words.shape == ref.words.shape
    assert port.to_bytes() == ref.to_bytes()
    for keys in (held, fresh):
        assert np.array_equal(port.include_batch(keys), ref.include_batch(keys))
    assert port.include(held[1]) and port.fill_ratio() == ref.fill_ratio()
    back = CPUBlockedBloomFilter.from_bytes(port.config, port.to_bytes())
    assert np.array_equal(back.words, port.words)
    jback = jcpu.CPUBlockedBloomFilter.from_bytes(ref.config, port.to_bytes())
    assert np.array_equal(jback.words, port.words)


def test_blocked_defaults_and_restore_as_tpubloom():
    """A flat config gets block_bits 512 as in tpubloom; ``_set_words``
    takes a flat array."""
    kw = dict(m=1 << 14, k=7, key_len=L)
    port = CPUBlockedBloomFilter(FilterConfig(**kw))
    ref = jcpu.CPUBlockedBloomFilter(tpubloom.FilterConfig(**kw))
    assert port.config.to_dict() == ref.config.to_dict() and port.use_native
    keys = _keys(10, 500)
    ref.insert_batch(keys)
    port._set_words(ref.words.reshape(-1))
    assert port.to_bytes() == ref.to_bytes() and port.include_batch(keys).all()


# -- the CPU driver against the port's own device="cpu" filters ---------------------------


def _port_pairs():
    return {
        "blocked": (CPUBlockedBloomFilter, BlockedBloomFilter, BLOCKED["chunk"]),
        "blocked_ap": (CPUBlockedBloomFilter, BlockedBloomFilter, BLOCKED["ap"]),
        "flat": (CPUBloomFilter, BloomFilter, FLAT["pow2"]),
        "flat_config1_m": (CPUBloomFilter, BloomFilter, FLAT["config1_m"]),
        "counting": (CPUBloomFilter, CountingBloomFilter, dict(COUNTING["pow2"], counting=True)),
    }


@pytest.mark.parametrize("name", list(_port_pairs()))
def test_cpu_driver_matches_the_port_filters(name):
    cpu_cls, dev_cls, kw = _port_pairs()[name]
    cfg = FilterConfig(**kw, key_len=L)
    cpu, dev = cpu_cls(cfg), dev_cls(cfg, device="cpu")
    held, fresh = _keys(11, 1500), _keys(12, 1500)
    batch = held + held[:3] * 20 if cfg.counting else held
    cpu.insert_batch(batch)
    dev.insert_batch(batch)
    if cfg.counting:
        cpu.delete_batch(held[:400] + held[:3] * 10)
        dev.delete_batch(held[:400] + held[:3] * 10)
    assert cpu.to_bytes() == dev.to_bytes()
    for keys in (held, fresh):
        assert np.array_equal(cpu.include_batch(keys), dev.include_batch(keys))
    if not cfg.counting:
        assert cpu.fill_ratio() == dev.fill_ratio()
    # blobs cross both ways
    back_dev = dev_cls.from_bytes(cfg, cpu.to_bytes(), device="cpu")
    assert back_dev.to_bytes() == cpu.to_bytes()
    assert np.array_equal(back_dev.include_batch(held), cpu.include_batch(held))
    back_cpu = cpu_cls.from_bytes(cfg, dev.to_bytes())
    assert back_cpu.to_bytes() == dev.to_bytes()
    assert np.array_equal(back_cpu.include_batch(fresh), dev.include_batch(fresh))


# -- the scalable stack over the CPU driver -----------------------------------------------

SCALABLE_BASES = {
    "flat": dict(m=64, k=1, key_len=L, key_name="sf"),
    "blocked": dict(m=512, k=1, key_len=L, key_name="sb", block_bits=512),
}


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("base", list(SCALABLE_BASES))
def test_cpu_scalable_matches_tpubloom(base, use_native):
    kw = dict(config=None, growth=2, tightening=0.5, use_native=use_native)
    port = CPUScalableBloomFilter(300, 0.01, **{**kw, "config": FilterConfig(**SCALABLE_BASES[base])})
    ref = jscalable.CPUScalableBloomFilter(
        300, 0.01, **{**kw, "config": tpubloom.FilterConfig(**SCALABLE_BASES[base])})
    held, fresh = _keys(13, 2500), _keys(14, 2000)
    for start in range(0, len(held), 700):  # calls that straddle the growth boundaries
        port.insert_batch(held[start : start + 700])
        ref.insert_batch(held[start : start + 700])
    assert port.n_layers == ref.n_layers >= 3
    for p, j in zip(port.layers, ref.layers, strict=True):
        assert type(p).__name__ == type(j).__name__ and p.use_native == j.use_native == use_native
        assert p.config.to_dict() == j.config.to_dict()
        assert np.array_equal(p.words, j.words)
    assert port.snapshot_meta() == ref.snapshot_meta()
    for keys in (held, fresh):
        assert np.array_equal(port.include_batch(keys), ref.include_batch(keys))
    assert port.include_batch(held).all() and held[5] in port
    assert port.stats() == ref.stats()
    port.clear()
    assert port.n_layers == 1 and port.n_inserted == 0


@pytest.mark.parametrize("base", list(SCALABLE_BASES))
def test_cpu_scalable_matches_the_port_stack(base):
    cfg = FilterConfig(**SCALABLE_BASES[base])
    cpu = CPUScalableBloomFilter(300, 0.01, config=cfg)
    dev = ScalableBloomFilter(300, 0.01, config=cfg, device="cpu")
    held, fresh = _keys(15, 1500), _keys(16, 1500)
    cpu.insert_batch(held)
    dev.insert_batch(held)
    assert cpu.n_layers == dev.n_layers >= 3
    for c, d in zip(cpu.layers, dev.layers, strict=True):
        assert c.to_bytes() == d.to_bytes()
    assert np.array_equal(cpu.include_batch(fresh), dev.include_batch(fresh))
    with pytest.raises(ValueError, match="counting"):
        CPUScalableBloomFilter(300, 0.01, config=FilterConfig(m=64, k=1, counting=True))


# -- pack_keys ----------------------------------------------------------------------------


def _both_scatters(keys, key_len):
    lens = np.fromiter((len(k) for k in keys), dtype=np.int32, count=len(keys))
    joined = b"".join(keys)
    return native.pack_joined(joined, lens, key_len), packing.scatter_joined(joined, lens, key_len)


@pytest.mark.parametrize("key_len", [4, 16, 28])
def test_pack_keys_native_numpy_and_tpubloom_agree(key_len):
    rng = np.random.default_rng(key_len)
    keys = [rng.bytes(int(n)) for n in rng.integers(0, key_len + 1, 3000)] + [b"", b"\0" * key_len]
    got, lens = packing.pack_keys(keys, key_len)
    want, wlens = jpacking.pack_keys(keys, key_len)
    assert got.dtype == want.dtype == np.uint8 and lens.dtype == wlens.dtype == np.int32
    assert np.array_equal(got, want) and np.array_equal(lens, wlens)
    cpp, plain = _both_scatters(keys, key_len)
    assert np.array_equal(cpp, plain) and np.array_equal(cpp, got)


@pytest.mark.parametrize("case", ["str", "digest", "mixed", "bytearray", "empty"])
def test_pack_keys_slow_paths_agree_with_tpubloom(case):
    rng = np.random.default_rng(1)
    keys = {
        "str": ["alpha", "βeta", "", "x" * L],
        "digest": [rng.bytes(40), b"short", rng.bytes(L + 1), b""],
        "mixed": [b"a", "b", rng.bytes(L)],
        "bytearray": [bytearray(b"abc"), memoryview(b"de"), b"f"],
        "empty": [],
    }[case]
    policy = "digest" if case == "digest" else "error"
    got, lens = packing.pack_keys(keys, L, key_policy=policy)
    want, wlens = jpacking.pack_keys(keys, L, key_policy=policy)
    assert got.shape == want.shape == (len(keys), L)
    assert np.array_equal(got, want) and np.array_equal(lens, wlens)


def test_pack_keys_refuses_as_tpubloom():
    for pkg in (packing, jpacking):
        with pytest.raises(ValueError, match="key 1 is 17 bytes > key_len=16"):
            pkg.pack_keys([b"a", b"b" * 17], L)
        with pytest.raises(ValueError, match="requires key_len >= 16"):
            pkg.pack_keys([b"a"], 8, key_policy="digest")
        with pytest.raises(TypeError, match="key 0 must be bytes or str"):
            pkg.pack_keys([3], L)


# -- public names and import hygiene ------------------------------------------------------


def test_public_names_match_tpubloom():
    import tpubloom_torch

    for name in ("CPUBloomFilter", "CPUBlockedBloomFilter", "CPUScalableBloomFilter",
                 "optimal_m_k", "theoretical_fpr"):
        assert name in tpubloom_torch.__all__ and name in tpubloom.__all__
        assert getattr(tpubloom_torch, name).__name__ == getattr(tpubloom, name).__name__
    assert tpubloom_torch.optimal_m_k(10**6, 0.01) == tpubloom.optimal_m_k(10**6, 0.01)
    assert tpubloom_torch.theoretical_fpr(1 << 20, 7, 10**5) == tpubloom.theoretical_fpr(1 << 20, 7, 10**5)


def test_cpu_driver_imports_neither_torch_nor_jax():
    code = (
        "import sys\n"
        "import tpubloom_torch.cpu_ref\n"
        "from tpubloom_torch import CPUBloomFilter, CPUBlockedBloomFilter, FilterConfig\n"
        "from tpubloom_torch import optimal_m_k, theoretical_fpr\n"
        "f = CPUBlockedBloomFilter(FilterConfig(m=1 << 16, k=7, block_bits=512))\n"
        "f.insert_batch([b'alpha', 'beta'])\n"
        "assert f.include_batch([b'alpha', b'beta']).all() and f.use_native\n"
        "g = CPUBloomFilter(FilterConfig(m=1 << 10, k=3, counting=True))\n"
        "g.insert_batch([b'a']); g.delete_batch([b'a']); assert not g.words.any()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'jaxlib', 'tpubloom')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
