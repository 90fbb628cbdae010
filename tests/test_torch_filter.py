"""The slice as a whole: tpubloom_torch.BlockedBloomFilter on the CPU
against tpubloom.BlockedBloomFilter (JAX, CPU backend) and the numpy
oracle tpubloom.cpu_ref.CPUBlockedBloomFilter, over several batches of
every entry point — exact (tolerance 0): words, verdicts, to_bytes().
Also the interop round trip in both directions, the import isolation of
the port, and that the port never runs on the CPU unasked."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tpubloom
from tpubloom.cpu_ref import CPUBlockedBloomFilter
from tpubloom_torch import BlockedBloomFilter, FilterConfig
from tpubloom_torch import interop
from tpubloom_torch.ops import sweep

ROOT = Path(__file__).resolve().parent.parent
M, K, L = 1 << 20, 7, 16


def _keys(rng, n, fixed=False):
    if fixed:
        return rng.integers(0, 256, (n, L), dtype=np.uint8)
    return [rng.bytes(int(rng.integers(0, L + 1))) for _ in range(n)]


@pytest.mark.parametrize(
    "block_bits,block_hash", [(512, "chunk"), (512, "ap"), (256, "chunk")]
)
def test_filter_matches_jax_and_oracle(block_bits, block_hash):
    kw = dict(m=M, k=K, key_len=L, block_bits=block_bits, block_hash=block_hash)
    port = BlockedBloomFilter(FilterConfig(**kw), device="cpu")
    ref = tpubloom.BlockedBloomFilter(tpubloom.FilterConfig(**kw))
    oracle = CPUBlockedBloomFilter(tpubloom.FilterConfig(**kw), use_native=False)
    rng = np.random.default_rng(block_bits + len(block_hash))
    old = []
    for step in range(3):
        keys = _keys(rng, 700) + old[:200]
        np.testing.assert_array_equal(
            port.insert_batch(keys, return_presence=True),
            ref.insert_batch(keys, return_presence=True),
        )
        oracle.insert_batch(keys)
        more = _keys(rng, 300)
        port.insert_batch(more)
        ref.insert_batch(more)
        oracle.insert_batch(more)
        rows = _keys(rng, 500, fixed=True)
        assert port.insert_packed(rows) == ref.insert_packed(rows) == 500
        oracle.insert_batch([bytes(r) for r in rows])
        probe = keys + _keys(rng, 400)
        np.testing.assert_array_equal(port.include_batch(probe), ref.include_batch(probe))
        np.testing.assert_array_equal(port.include_batch(probe), oracle.include_batch(probe))
        probe_rows = np.concatenate([rows[:100], _keys(rng, 100, fixed=True)])
        np.testing.assert_array_equal(
            port.include_packed(probe_rows), ref.include_packed(probe_rows)
        )
        np.testing.assert_array_equal(port.words_logical, ref.words_logical)
        np.testing.assert_array_equal(port.words_logical, oracle.words)
        old = keys
    assert port.to_bytes() == ref.to_bytes()
    assert port.n_inserted == ref.n_inserted
    assert port.fill_ratio() == ref.fill_ratio()
    assert port.stats()["bits_set"] == ref.stats()["bits_set"]
    assert port.stats()["predicted_fpr"] == ref.stats()["predicted_fpr"]


def test_staged_api_with_inflight_matches_jax():
    cfg = dict(m=M, k=K, key_len=L, block_bits=512)
    port = BlockedBloomFilter(FilterConfig(**cfg), device="cpu")
    ref = tpubloom.BlockedBloomFilter(tpubloom.FilterConfig(**cfg))
    rng = np.random.default_rng(21)
    batches = [_keys(rng, 1000, fixed=True) for _ in range(4)]
    inflight = sweep.InFlight()
    done = []
    for i, rows in enumerate(batches):
        handle = port.launch_insert(port.stage_batch(rows=rows))
        payload, err = inflight.put(handle, i)
        assert err is None
        if payload is not None:
            done.append(payload)
        ref.insert_packed(rows)
    payload, err = inflight.take()
    assert err is None and done + [payload] == [0, 1, 2, 3]
    assert not inflight.pending
    np.testing.assert_array_equal(port.words_logical, ref.words_logical)
    keys = [bytes(r) for r in batches[2][:300]] + _keys(rng, 300)
    hits, n = port.launch_query(port.stage_batch(keys))
    hits = hits.numpy()
    assert n == 600 and hits.shape == (1024,) and not hits[n:].any()
    np.testing.assert_array_equal(hits[:n], ref.include_batch(keys))
    assert hits[:300].all()


def test_device_arrays_api_and_clear():
    cfg = FilterConfig(m=M, k=K, key_len=L, block_bits=512)
    port = BlockedBloomFilter(cfg, device="cpu")
    rng = np.random.default_rng(22)
    rows = torch.from_numpy(_keys(rng, 256, fixed=True))
    lengths = torch.full((256,), L, dtype=torch.int32)
    lengths[200:] = -1
    port.insert_arrays(rows, lengths, n_valid=200)
    assert port.n_inserted == 200
    hits = port.include_arrays(rows, lengths)
    assert hits[:200].all() and not hits[200:].any()
    assert port.include(bytes(rows[0].numpy())) and bytes(rows[0].numpy()) in port
    port.clear()
    assert port.bits_set() == 0 and port.n_inserted == 0
    assert not port.include_batch([bytes(r) for r in rows[:200].numpy()]).any()


def test_interop_round_trip_both_ways():
    jcfg = tpubloom.FilterConfig(m=M, k=K, key_len=L, block_bits=512)
    cfg = interop.config_from_dict(jcfg.to_dict())
    assert cfg.to_dict() == jcfg.to_dict()
    rng = np.random.default_rng(23)
    keys_a = _keys(rng, 800)
    ref = tpubloom.BlockedBloomFilter(jcfg)
    ref.insert_batch(keys_a)
    # tpubloom -> port
    port = interop.filter_from_words(ref.words_logical, cfg, "cpu", n_inserted=ref.n_inserted)
    assert port.to_bytes() == ref.to_bytes()
    probe = keys_a + _keys(rng, 400)
    np.testing.assert_array_equal(port.include_batch(probe), ref.include_batch(probe))
    # port -> tpubloom, after the port moves on
    keys_b = _keys(rng, 800)
    port.insert_batch(keys_b)
    back = tpubloom.BlockedBloomFilter.from_bytes(jcfg, interop.words_to_numpy(port).tobytes())
    np.testing.assert_array_equal(back.words_logical, port.words_logical)
    probe = keys_b + probe
    np.testing.assert_array_equal(back.include_batch(probe), port.include_batch(probe))
    blob = port.to_bytes()
    again = BlockedBloomFilter.from_bytes(cfg, blob, device="cpu")
    assert again.to_bytes() == blob
    # a header without block_hash restores as "ap", as in tpubloom
    legacy = {k: v for k, v in jcfg.to_dict().items() if k != "block_hash"}
    assert interop.config_from_dict(legacy).block_hash == "ap"


@pytest.mark.parametrize(
    "kw",
    [
        dict(m=M, k=K, block_bits=512),                  # auto -> chunk
        dict(m=M, k=20, block_bits=512),                 # auto -> ap (k*9 > 96)
        dict(m=M, k=K, block_bits=4096, block_hash="ap"),
        dict(m=M, k=K, block_bits=256, counting=True),   # counting: 64-counter domain
        dict(m=M, k=K),                                  # flat carries ""
        dict(m=M, k=K, block_bits=100),                  # errors: not a power of two
        dict(m=M, k=K, block_bits=512, block_hash="chunk", key_len=6),
        dict(m=M, k=20, block_bits=512, block_hash="chunk"),
        dict(m=3 << 31, k=K),
        dict(m=M, k=K, insert_path="gather"),
    ],
)
def test_config_matches_tpubloom(kw):
    """The port's FilterConfig copy resolves, serialises and rejects
    exactly as tpubloom's."""
    from tpubloom.config import identity_mismatch as jmismatch
    from tpubloom_torch.config import IDENTITY_FIELDS, identity_mismatch

    try:
        want = tpubloom.FilterConfig(**kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            FilterConfig(**kw)
        assert str(got.value) == str(e)
        return
    cfg = FilterConfig(**kw)
    assert cfg.to_dict() == want.to_dict()
    assert FilterConfig.from_dict(want.to_dict()) == cfg
    assert IDENTITY_FIELDS == tpubloom.config.IDENTITY_FIELDS
    other = dict(want.to_dict(), seed=1)
    assert identity_mismatch(cfg, other) == jmismatch(want, other) == "seed"
    legacy = {f: v for f, v in want.to_dict().items() if f != "block_hash"}
    assert identity_mismatch(cfg, legacy) == jmismatch(want, legacy)


def test_port_imports_neither_jax_nor_tpubloom():
    code = (
        "import sys, importlib, pkgutil, tpubloom_torch\n"
        "import tpubloom_torch.migrate, tpubloom_torch.ops.bitops\n"
        "for m in pkgutil.walk_packages(tpubloom_torch.__path__, 'tpubloom_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'tpubloom' or m.startswith('tpubloom.')]\n"
        "assert not bad, bad\n"
        "print('isolated')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert out.returncode == 0 and "isolated" in out.stdout, out.stderr


def test_chip_smoke_imports_neither_jax_nor_tpubloom():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "tpubloom_torch" in {n.split(".")[0] for n in names}
    assert not [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "tpubloom")]


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without CUDA the smoke exits non-zero and prints no result line —
    in the repo, and alone in an empty directory."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, alone)):
        out = subprocess.run(
            [sys.executable, str(script)], cwd=cwd, capture_output=True, text=True,
            timeout=120, env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
        )
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


def test_no_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BlockedBloomFilter(FilterConfig(m=M, k=K, block_bits=512))


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    cfg = FilterConfig(m=M, k=K, key_len=L, block_bits=512)
    sweep.reset_launch_counts()
    f = BlockedBloomFilter(cfg, device="cpu")
    f.insert_batch([b"a", b"b"], return_presence=True)
    f.include_batch([b"a"])
    assert sweep.launch_counts() == dict.fromkeys(
        ("blocked_query", "blocked_insert", "blocked_counting_update", "blocked_counting_query",
         "sharded_blocked_query", "sharded_blocked_insert", "sharded_blocked_counting_update",
         "sharded_blocked_counting_query",
         "flat_insert", "flat_query", "flat_counting_update", "flat_counting_query",
         "sharded_flat_insert", "sharded_flat_query", "sharded_flat_counting_update",
         "sharded_flat_counting_query", "flat_counting_update_tiled", "flat_counting_query_tiled",
         "sharded_flat_counting_update_tiled", "sharded_flat_counting_query_tiled",
         "flat_insert_tiled", "sharded_flat_insert_tiled",
         "cuckoo_insert", "cuckoo_delete", "cuckoo_query", "cms_update", "cms_estimate",
         "cms_update_tiled"), 0
    )
    with pytest.raises(ValueError, match="share a device"):
        sweep.blocked_query(f.words, torch.zeros((4, L), dtype=torch.uint8, device="meta"),
                            torch.zeros(4, dtype=torch.int32), cfg)
