"""The checkpoint payload kernels (``tpubloom_torch/csrc/checksum.cu``) and
the streaming path's card work, on the card, at a small size. Marked
``gpu``; each test skips (inside the ``cuda`` fixture, never at import or
collection) where no CUDA device is present. On the card:

    python -m pytest tests/test_torch_gpu_stream.py -m gpu -q --noconftest

All comparisons are exact (tolerance 0):

* the kernel pair against its plain version on the same CUDA words and
  against the host CRC32C, at ragged lengths (0 to 3 chunks and a byte,
  config 1's 1,250,000 bytes, 2^27 bytes), with and without the bit
  reversal, and one launch pair counted a call;
* an async checkpoint of a filter on the card: the same payload and CRC
  as the synchronous snapshot, taken in stream order (inserts launched
  after ``trigger`` are not in it), restored on the card with its payload
  checked there, a corrupt payload refused;
* a stream with ``prefetch`` (the page-locked ring and the copy stream)
  leaves the words of a stream without it, plain and sharded (4 slots on
  one card)."""

import numpy as np
import pytest
import torch

from tpubloom_torch import BloomFilter, FilterConfig, ShardedBloomFilter, StreamInserter
from tpubloom_torch import checkpoint as ck
from tpubloom_torch import resume_offset
from tpubloom_torch.ops import checksum
from tpubloom_torch.utils.crc32c import crc32c

pytestmark = pytest.mark.gpu
C = checksum.CHUNK


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _words(n_bytes, spare, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    n = (n_bytes + 3) // 4 + spare
    return torch.randint(-(1 << 31), 1 << 31, (n,), dtype=torch.int32, device=dev, generator=g)


@pytest.mark.parametrize("bit_reverse", [False, True])
@pytest.mark.parametrize("nbytes", [1, 7, 8, C - 1, C, C + 1, 3 * C + 5, 1_250_000, 1 << 27])
def test_checksum_kernel_equals_plain(cuda, nbytes, bit_reverse):
    words = _words(nbytes, 3, nbytes, cuda)
    checksum.reset_launch_counts()
    payload, crc = checksum.payload_crc32c(words, nbytes, bit_reverse)
    torch.cuda.synchronize()
    assert checksum.launch_counts() == {"payload_crc32c": 1}
    want_payload, want_crc = checksum.payload_crc32c_plain(words, nbytes, bit_reverse)
    assert torch.equal(payload, want_payload)
    assert crc == want_crc
    if nbytes <= 1_250_000:
        assert crc == crc32c(payload.cpu().numpy().tobytes())


def test_checksum_kernel_refuses_what_it_cannot_take(cuda):
    words = _words(4096, 4, 1, cuda)
    with pytest.raises(ValueError, match="16-byte"):
        checksum.launch_payload_crc32c(words[1:], 4096, False)
    with pytest.raises(ValueError, match="nbytes"):
        checksum.launch_payload_crc32c(words, 4 * words.numel() + 1, False)
    assert checksum.payload_crc32c(words, 0, False)[1] == 0


def _keys(i0, n):
    return [b"warc-record-%014d" % i for i in range(i0, i0 + n)]


def test_async_checkpoint_on_card(cuda, tmp_path):
    cfg = FilterConfig(m=1 << 26, k=7, key_len=28, key_name="card")
    f = BloomFilter(cfg)
    f.insert_batch(_keys(0, 50_000))
    before = f.words.view(torch.int32).clone()
    sink = ck.FileSink(str(tmp_path))
    checksum.reset_launch_counts()
    cp = ck.AsyncCheckpointer(f, sink, meta_fn=lambda: {"stream_offset": 50_000})
    assert cp.trigger()
    f.insert_batch(_keys(50_000, 50_000))  # launched after the snapshot, on the same stream
    assert cp.flush(timeout=120) and cp.last_error is None
    assert cp.close(final_checkpoint=False)
    assert checksum.launch_counts() == {"payload_crc32c": 1}
    blob = sink.get("card")
    header, payload = ck._deserialize(blob)  # the host CRC agrees with the card's
    # the snapshot holds the words at trigger time, not the later inserts
    g = BloomFilter(cfg)
    g._set_words(ck.payload_to_words(cfg, header, payload))
    assert torch.equal(g.words.view(torch.int32), before)
    assert not torch.equal(before, f.words.view(torch.int32))
    # a restore on the card checks the payload there
    r = ck.restore(cfg, sink)
    assert r.words.is_cuda and torch.equal(r.words.view(torch.int32), before)
    assert resume_offset(r) == 50_000
    # the synchronous snapshot makes the same payload and CRC
    _, _, sblob = ck.snapshot_blob(g, seq=1)
    sh, sp = ck._deserialize(sblob)
    assert sp == payload and sh["payload_crc32c"] == header["payload_crc32c"]
    # a flipped payload byte is refused by the card's check
    bad = bytearray(blob)
    bad[-100] ^= 0x10
    with pytest.raises(ck.CheckpointCorruptError, match="payload CRC32C"):
        ck._deserialize(bytes(bad), cuda)


@pytest.mark.parametrize("sharded", [False, True])
def test_stream_prefetch_on_card(cuda, sharded):
    kw = dict(m=1 << 24, k=7, key_len=28)
    if sharded:
        cfg = FilterConfig(**kw, shards=8)
        a, b = (ShardedBloomFilter(cfg, devices=["cuda"] * 4) for _ in range(2))
    else:
        cfg = FilterConfig(**kw)
        a, b = BloomFilter(cfg), BloomFilter(cfg)
    keys = _keys(0, 100_003)
    sa = StreamInserter(a, batch_size=1 << 12).run(iter(keys))
    sb = StreamInserter(b, batch_size=1 << 12, prefetch=3, max_in_flight=2).run(iter(keys))
    assert sa == sb and sa["inserted"] == len(keys)
    assert np.array_equal(a.words_logical, b.words_logical)
    assert b.include_batch(keys[::97]).all()
    assert a.n_inserted == b.n_inserted == len(keys)


def test_stream_checkpoints_on_card(cuda, tmp_path):
    cfg = FilterConfig(m=1 << 26, k=7, key_len=28, key_name="stream-card")
    f = BloomFilter(cfg)
    ins = StreamInserter(f, batch_size=1 << 12, sink=ck.FileSink(str(tmp_path)),
                         checkpoint_every=20_000)
    ins.run(iter(_keys(0, 100_000)))
    assert ins.close() and ins.checkpointer.last_error is None
    assert ins.checkpointer.checkpoints_written >= 2
    g = ck.restore(cfg, ck.FileSink(str(tmp_path)))
    assert resume_offset(g) == 100_000
    assert torch.equal(g.words.view(torch.int32), f.words.view(torch.int32))
