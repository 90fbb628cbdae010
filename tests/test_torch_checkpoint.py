"""The port's checkpoint codec (tpubloom_torch.checkpoint) against
tpubloom's (tpubloom.checkpoint), on the CPU:

* CRC32C equals tpubloom's on random byte strings and the published
  vector;
* blobs of both blocked kinds cross between the packages in both
  directions, with identical decoded headers (all but the wall-clock
  ``time``) and payload bytes, and identical verdicts and ``n_inserted``
  (the flat kinds' crossings are in tests/test_torch_flat.py);
* a FileSink directory written by one package restores in the other;
* a corrupt newest generation is quarantined and the previous one
  restores; v1 blobs still restore; mismatched configs raise;
* the kinds the port once lacked restore; a payload format it does not
  know raises NotImplementedError, naming it."""

import json
import os

import numpy as np
import pytest

import tpubloom
from tpubloom import checkpoint as jck
from tpubloom.utils.crc32c import crc32c as jcrc32c
from tpubloom_torch import BlockedBloomFilter, BlockedCountingBloomFilter, FilterConfig
from tpubloom_torch import checkpoint as ck
from tpubloom_torch.utils.crc32c import _crc32c_numpy, crc32c

M, K, L = 1 << 20, 7, 16
KINDS = {
    "blocked": (dict(m=M, k=K, key_len=L, block_bits=512, key_name="bits"),
                tpubloom.BlockedBloomFilter, BlockedBloomFilter),
    "counting": (dict(m=M, k=K, key_len=L, counting=True, block_bits=512, key_name="counts"),
                 tpubloom.BlockedCountingBloomFilter, BlockedCountingBloomFilter),
}


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 63, 64, 65, 1000, 4099])
def test_crc32c_matches_tpubloom(n):
    data = np.random.default_rng(n).bytes(n)
    assert crc32c(data) == _crc32c_numpy(data) == jcrc32c(data)
    assert crc32c(data[n // 2 :], crc32c(data[: n // 2])) == jcrc32c(data)


def test_crc32c_published_vector():
    assert crc32c(b"123456789") == 0xE3069283


def _keys(rng, n):
    return [rng.bytes(int(rng.integers(1, L + 1))) for _ in range(n)]


def _filled_ref(kind, rng):
    kw, jcls, _ = KINDS[kind]
    ref = jcls(tpubloom.FilterConfig(**kw))
    keys = _keys(rng, 900)
    ref.insert_batch(keys + keys[:100])
    ref.include_batch(keys[:10])
    if kind == "counting":
        ref.delete_batch(keys[:300])
    return ref, keys


def _decoded(blob):
    header, payload = jck._deserialize(blob)
    return {k: v for k, v in header.items() if k != "time"}, payload


@pytest.mark.parametrize("kind", list(KINDS))
def test_blobs_cross_both_ways(kind):
    kw, jcls, pcls = KINDS[kind]
    rng = np.random.default_rng(41)
    ref, keys = _filled_ref(kind, rng)
    probe = keys + _keys(rng, 400)
    # tpubloom -> port
    _, _, jblob = jck.snapshot_blob(ref, seq=7)
    port = ck.restore_blob(jblob, device="cpu")
    assert isinstance(port, pcls)
    assert port.to_bytes() == ref.to_bytes()
    assert (port.n_inserted, port.n_queried) == (ref.n_inserted, ref.n_queried)
    np.testing.assert_array_equal(port.include_batch(probe), ref.include_batch(probe))
    # the port's blob of the same state decodes to the same header and payload
    _, _, pblob = ck.snapshot_blob(port, seq=7)
    ref.n_queried = port.n_queried
    _, _, jblob = jck.snapshot_blob(ref, seq=7)
    assert _decoded(pblob) == _decoded(jblob)
    assert ck._deserialize(pblob)[1] == ck._deserialize(jblob)[1]
    # port -> tpubloom, after the port moves on
    more = _keys(rng, 500)
    port.insert_batch(more)
    if kind == "counting":
        port.delete_batch(keys[300:400])
    key_name, seq, pblob = ck.snapshot_blob(port, extra={"note": "x"})
    assert key_name == kw["key_name"] and seq > 0
    back = jck.restore_blob(pblob)
    assert isinstance(back, jcls)
    assert back.to_bytes() == port.to_bytes()
    assert back.n_inserted == port.n_inserted
    assert back._restored_meta["note"] == "x"
    probe = probe + more
    np.testing.assert_array_equal(back.include_batch(probe), port.include_batch(probe))


@pytest.mark.parametrize("kind", list(KINDS))
def test_file_sink_directories_cross(kind, tmp_path):
    kw, jcls, pcls = KINDS[kind]
    rng = np.random.default_rng(42)
    ref, keys = _filled_ref(kind, rng)
    cfg, jcfg = FilterConfig(**kw), tpubloom.FilterConfig(**kw)
    # tpubloom writes, the port restores the newest generation
    jsink = jck.FileSink(str(tmp_path / "j"))
    jck.save(ref, jsink, seq=1)
    ref.insert_batch(keys[:50])
    jck.save(ref, jsink, seq=2)
    port = ck.restore(cfg, ck.FileSink(str(tmp_path / "j")), device="cpu")
    assert isinstance(port, pcls) and port._restored_seq == 2
    assert port.to_bytes() == ref.to_bytes() and port.n_inserted == ref.n_inserted
    # the port writes, tpubloom restores
    psink = ck.FileSink(str(tmp_path / "p"))
    port.insert_batch(_keys(rng, 300))
    assert ck.save(port, psink, seq=5) == 5
    assert psink.list_seqs(kw["key_name"]) == [5] == jck.FileSink(str(tmp_path / "p")).list_seqs(kw["key_name"])
    back = jck.restore(jcfg, jck.FileSink(str(tmp_path / "p")))
    assert isinstance(back, jcls) and back._restored_seq == 5
    assert back.to_bytes() == port.to_bytes() and back.n_inserted == port.n_inserted
    assert os.listdir(tmp_path / "p") == [f"{kw['key_name']}.{5:012d}.ckpt"]


@pytest.mark.parametrize("damage", ["payload_bit", "header_bit", "truncated"])
def test_corrupt_newest_is_quarantined_and_previous_restores(damage, tmp_path):
    kw, _, pcls = KINDS["counting"]
    cfg = FilterConfig(**kw)
    rng = np.random.default_rng(43)
    f = pcls(cfg, device="cpu")
    f.insert_batch(_keys(rng, 500))
    sink = ck.FileSink(str(tmp_path))
    ck.save(f, sink, seq=10)
    good = f.to_bytes()
    f.insert_batch(_keys(rng, 500))
    ck.save(f, sink, seq=11)
    path = tmp_path / f"{kw['key_name']}.{11:012d}.ckpt"
    blob = bytearray(path.read_bytes())
    if damage == "payload_bit":
        blob[-5] ^= 0x10
    elif damage == "header_bit":
        blob[len(ck.MAGIC_V2) + 20] ^= 0x01
    else:
        blob = blob[: len(blob) // 2]
    path.write_bytes(bytes(blob))
    with pytest.raises(ck.CheckpointCorruptError):
        ck.restore_blob(bytes(blob), device="cpu")
    g = ck.restore(cfg, sink, device="cpu")
    assert g._restored_seq == 10 and g.to_bytes() == good
    assert sink.list_seqs(kw["key_name"]) == [10]
    assert (tmp_path / "corrupt" / path.name).exists()
    # tpubloom agrees the damaged blob is corrupt
    with pytest.raises(jck.CheckpointCorruptError):
        jck._deserialize(bytes(blob))


def test_v1_blob_restores_and_mismatch_raises():
    kw, _, _ = KINDS["blocked"]
    cfg = FilterConfig(**kw)
    f = BlockedBloomFilter(cfg, device="cpu")
    f.insert_batch([b"alpha", b"beta"])
    header = {"config": cfg.to_dict(), "seq": 3, "format": "blocked_le_words",
              "extra": {"n_inserted": 2}}
    hdr = json.dumps(header).encode()
    v1 = ck.MAGIC + len(hdr).to_bytes(8, "little") + hdr + f.to_bytes()
    g = ck.restore_blob(v1, device="cpu")
    assert g.to_bytes() == f.to_bytes() and g.n_inserted == 2
    assert g.include_batch([b"alpha", b"beta"]).all()
    with pytest.raises(ValueError, match="mismatch on seed"):
        ck.restore_blob(v1, cfg.replace(seed=1), device="cpu")
    with pytest.raises(ck.CheckpointCorruptError, match="bad magic"):
        ck.restore_blob(b"not a checkpoint", device="cpu")


def _foreign_blob(kind):
    """A tpubloom blob of a kind the port once lacked, and its filter."""
    if kind == "scalable":
        from tpubloom.scalable import ScalableBloomFilter

        ref = ScalableBloomFilter(100, 0.01, config=tpubloom.FilterConfig(m=1 << 12, k=3))
    else:
        from tpubloom.sketch.cuckoo import CuckooFilter

        ref = CuckooFilter(tpubloom.FilterConfig(m=1 << 10, k=2, kind="cuckoo"))
    ref.insert_batch([b"key-%d" % i for i in range(300)])
    return jck.snapshot_blob(ref, seq=1)[2], ref


@pytest.mark.parametrize("kind", ["kind='cuckoo'", "scalable"])
def test_unsupported_kinds_raise(kind):
    """The kinds the port once lacked (a sketch, a scalable stack) restore;
    a payload format the port does not know still raises
    NotImplementedError naming it."""
    blob, ref = _foreign_blob(kind)
    f = ck.restore_blob(blob, device="cpu")
    if kind == "scalable":
        assert f.n_layers == ref.n_layers == 2
        for a, b in zip(f.layers, ref.layers, strict=True):
            np.testing.assert_array_equal(a.words_logical, np.asarray(b.words))
    else:
        np.testing.assert_array_equal(f.words_logical, np.asarray(ref.words))
    assert f.include_batch([b"key-%d" % i for i in range(300)]).all()
    src = BlockedBloomFilter(FilterConfig(**KINDS["blocked"][0]), "cpu")
    header, payload = ck._deserialize(bytes(ck.snapshot_blob(src, seq=2)[2]))
    odd = jck._frame({**header, "format": "hll_registers"}, payload)
    with pytest.raises(NotImplementedError, match="hll_registers"):
        ck.restore_blob(odd, device="cpu")
