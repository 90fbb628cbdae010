"""The yardstick's own pieces: the frozen hash spec, the plain reference
and the byte arithmetic, each against a case counted by hand or the
published vectors; and the spec against the port's plain versions."""

import torch

from perfbench.reference import blocked, bounds, family, flat, hashspec


def keys_of(*raw: bytes, L: int = 16):
    keys = torch.zeros((len(raw), L), dtype=torch.uint8)
    for i, r in enumerate(raw):
        keys[i, : len(r)] = torch.tensor(list(r), dtype=torch.uint8)
    return keys, torch.tensor([len(r) for r in raw], dtype=torch.int32)


def test_murmur3_and_fnv1a_published_vectors():
    keys, lengths = keys_of(b"", b"", b"hello", b"The quick brown fox jumps over the lazy dog", L=44)
    seeds = [0, 1, 0, 0x9747B28C]
    got = [int(hashspec.murmur3_32(keys[i : i + 1], lengths[i : i + 1], s)[0]) for i, s in enumerate(seeds)]
    assert got == [0, 0x514E28B7, 0x248BFA47, 0x2FA826CD]
    keys, lengths = keys_of(b"", b"a", b"foobar", L=8)
    assert hashspec.fnv1a_32(keys, lengths).tolist() == [0x811C9DC5, 0xE40C292C, 0xBF9CF968]


def test_padding_hashes_as_the_empty_key():
    keys, lengths = keys_of(b"", b"")
    lengths[1] = -1
    h = hashspec.murmur3_32(keys, lengths, 7)
    assert h[0] == h[1]


def test_spec_agrees_with_the_port_plain_versions():
    from tpubloom_torch.ops import blocked, hashing

    g = torch.Generator().manual_seed(5)
    keys = torch.randint(0, 256, (300, 16), dtype=torch.uint8, generator=g)
    lengths = torch.randint(0, 17, (300,), dtype=torch.int32, generator=g)
    for i in range(300):
        keys[i, lengths[i]:] = 0
    for block_hash in ("chunk", "ap"):
        mine = hashspec.blocked_bits(keys, lengths, m=1 << 20, k=7, seed=0x9747B28C, block_bits=512,
                                     block_hash=block_hash)
        blk, bit = blocked.block_positions(keys, lengths, n_blocks=(1 << 20) // 512, block_bits=512,
                                           k=7, seed=0x9747B28C, block_hash=block_hash)
        assert torch.equal(mine, blk[:, None] * 512 + bit)
    for m in (1 << 30, 1 << 34, 10_000_000):
        hi, lo = hashing.positions(keys, lengths, m=m, k=10, seed=0x9747B28C)
        assert torch.equal(hashspec.flat_bits(keys, lengths, m=m, k=10, seed=0x9747B28C), (hi << 32) | lo)


def test_reference_against_a_hand_built_filter():
    params = {"m": 4096, "k": 3, "seed": 11}
    keys, lengths = keys_of(b"alpha", b"beta", b"gamma", b"alpha", b"")
    lengths[4] = -1  # padding
    ref = flat.Reference(params, "cpu")
    assert ref.test_insert(keys[:2], lengths[:2]).tolist() == [False, False]
    # within a batch every key answers by the state before it: "alpha"
    # again beside "gamma" is held, "gamma" is not, padding never
    assert ref.test_insert(keys[2:], lengths[2:]).tolist() == [False, True, False]
    bitmap = 0
    for key in (b"alpha", b"beta", b"gamma"):
        k, n = keys_of(key)
        for p in hashspec.flat_bits(k, n, m=4096, k=3, seed=11)[0].tolist():
            bitmap |= 1 << p
    assert ref.packed().numpy().tobytes() == bitmap.to_bytes(512, "little")
    assert ref.query(keys, lengths).tolist() == [True, True, True, True, False]
    ref.clear()
    assert int(ref.packed().sum()) == 0


def test_byte_arithmetic_on_hand_counted_cases():
    # a blocked test-and-insert of 4 keys over 3 distinct 64-byte rows: 20
    # bytes a key in, a verdict out, each row read and written; three
    # murmurs (54 each), FNV-1a (64), 7 slices, 7 tests and 7 sets a key
    assert bounds.blocked(keys=4, L=16, k=7, row_bytes=64, distinct_rows=3, answers=True,
                          sets=True) == (4 * 20 + 4 + 3 * 64 * 2, 4 * (162 + 64 + 28 + 28 + 21))
    # a flat query of 4 rows (3 keys) reading 7 positions over 5 sectors
    assert bounds.flat(keys=4, valid=3, L=16, distinct_sectors=5, positions=7, answers=True,
                       sets=False) == (4 * 20 + 4 + 5 * 32, 3 * 226 + 7 * 8)
    peak = {"hbm_bytes_per_s": 1e9, "int32_ops_per_s": 1e9}
    assert bounds.least_seconds(2000, 1000, peak) == 2e-6
    assert bounds.peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == 3.35e12


def test_work_counts_rows_and_first_zero_reads():
    keys, lengths = keys_of(b"one", b"two", b"three", b"one")
    ref = blocked.Reference({"m": 1 << 12, "k": 7, "seed": 3, "block_bits": 512, "block_hash": "chunk"}, "cpu")
    rows = {int(r) for r in hashspec.blocked_bits(keys, lengths, **ref.params)[:, 0] // 512}

    class Op:
        ANSWERS, SETS = True, True

    b, _ = blocked.work(ref, Op, keys, lengths)
    assert b == 4 * 20 + 4 + len(rows) * 64 * 2

    class Query:
        ANSWERS, SETS = True, False

    ref = flat.Reference({"m": 1 << 14, "k": 4, "seed": 3}, "cpu")
    ref.insert(keys[:1], lengths[:1])
    pos = hashspec.flat_bits(keys, lengths, m=1 << 14, k=4, seed=3)
    # a held key reads all k positions; another stops at its first zero bit
    read = [4 if i in (0, 3) else next(j for j in range(4) if not ref.bits[pos[i, j]]) + 1
            for i in range(4)]
    sectors = {int(pos[i, j]) >> 8 for i in range(4) for j in range(read[i])}
    assert flat.work(ref, Query, keys, lengths) == bounds.flat(
        keys=4, valid=4, L=16, distinct_sectors=len(sectors), positions=sum(read),
        answers=True, sets=False)


def test_each_reference_module_gives_state_work_and_control():
    """What the harness looks up by a configuration's ``reference``."""
    for name in ("blocked", "flat"):
        mod = family(name)
        assert callable(mod.work) and callable(mod.Reference)
        params = {"m": 1 << 12, "k": 7, "seed": 3, "block_bits": 512, "block_hash": "chunk"}
        assert mod.control(params)["k"] == 6 and params["k"] == 7
