"""The checkpoint payload's bytes and CRC32C (``tpubloom_torch.ops.checksum``)
against tpubloom's host path, on the CPU, exact (tolerance 0):

* ``payload_crc32c``'s plain version (the CPU path of the wrapper) against
  ``tpubloom.utils.crc32c.crc32c`` over the little-endian words, and over
  ``tpubloom.utils.packing.words_to_redis_bitmap`` when bits are reversed,
  at nbytes 0, 1, 7, 8, C - 1, C, C + 1, 3C + 5 (C = 4096, the chunk) and
  config 1's 1,250,000, from words with a spare tail;
* the GF(2) helpers the combine uses: a shift is a run of zero bytes, and
  the combine of chunk CRCs equals the CRC of their concatenation;
* the CPU path counts no launch, a CUDA-only entry refuses a CPU tensor,
  and a restore checks payloads with the same CRC.

The kernel itself (``tpubloom_torch/csrc/checksum.cu``) runs only on the
card: tests/test_torch_gpu_stream.py holds it against this plain version."""

import numpy as np
import pytest
import torch

from tpubloom.utils.crc32c import crc32c as jcrc32c
from tpubloom.utils.packing import words_to_redis_bitmap as jbitmap
from tpubloom_torch.ops import checksum
from tpubloom_torch.utils.crc32c import crc32c

C = checksum.CHUNK
LENGTHS = [0, 1, 7, 8, C - 1, C, C + 1, 3 * C + 5, 1_250_000]


def _words(n_bytes, spare, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, (n_bytes + 3) // 4 + spare, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("bit_reverse", [False, True])
@pytest.mark.parametrize("nbytes", LENGTHS)
def test_plain_payload_and_crc_equal_tpubloom(nbytes, bit_reverse):
    w = _words(nbytes, 2, nbytes)
    words = torch.from_numpy(w.view(np.int32)).view(torch.uint32)
    checksum.reset_launch_counts()
    payload, crc = checksum.payload_crc32c(words, nbytes, bit_reverse)
    assert checksum.launch_counts() == {"payload_crc32c": 0}
    want = jbitmap(w, 8 * nbytes) if bit_reverse else w.astype("<u4").tobytes()[:nbytes]
    assert payload.dtype == torch.uint8 and payload.numel() == nbytes
    assert payload.numpy().tobytes() == want
    assert crc == jcrc32c(want) == crc32c(want)


def test_published_vector_and_crossing_chunks():
    assert checksum.bytes_crc32c(b"123456789", "cpu") == 0xE3069283
    data = np.random.default_rng(1).bytes(5 * C + 77)
    assert checksum.bytes_crc32c(data, "cpu") == jcrc32c(data)


def test_shift_is_a_run_of_zero_bytes():
    """``shift_bytes(raw, n)`` advances a zero-init register through n zero
    bytes, and the combine of chunk CRCs equals the CRC of their join."""
    rng = np.random.default_rng(5)
    for n in (1, 3, 64, C, 3 * C + 1):
        data = rng.bytes(int(rng.integers(1, 200)))
        raw = jcrc32c(data) ^ 0xFFFFFFFF ^ checksum.shift_bytes(0xFFFFFFFF, len(data))
        # the raw CRC of data then n zeros
        want = jcrc32c(data + bytes(n)) ^ 0xFFFFFFFF ^ checksum.shift_bytes(0xFFFFFFFF, len(data) + n)
        assert checksum.shift_bytes(raw, n) == want
    chunks = [rng.bytes(C) for _ in range(3)] + [rng.bytes(123)]
    raws = [jcrc32c(c) ^ 0xFFFFFFFF ^ checksum.shift_bytes(0xFFFFFFFF, len(c)) for c in chunks]
    assert checksum.combine(raws, 3 * C + 123) == jcrc32c(b"".join(chunks))


def test_reverse_bits_in_bytes_matches_the_table():
    w = _words(4096, 0, 9)
    got = checksum.reverse_bits_in_bytes(torch.from_numpy(w.view(np.int32))).numpy().view(np.uint8)
    assert got.tobytes() == jbitmap(w, 8 * 4 * w.size)


def test_wrappers_check_their_inputs():
    words = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="nbytes"):
        checksum.payload_crc32c(words, 17, False)
    with pytest.raises(TypeError, match="uint32"):
        checksum.payload_crc32c(torch.zeros(4, dtype=torch.int64), 8, False)
    with pytest.raises(ValueError, match="CUDA"):
        checksum.launch_payload_crc32c(words, 16, False)  # the kernel takes the card's tensors
    assert checksum.payload_crc32c(words, 0, True)[1] == 0
