"""The plain model of the cuckoo round walk (``tpubloom_torch.ops.cuckoo.
cuckoo_walk_rounds``: speculate a window of keys against the table as the
round found it, claim each key's write set, commit the keys before the
first one that read a bucket an earlier key claimed) against the scans of
``tpubloom.ops.cuckoo`` (``cuckoo_insert``, ``cuckoo_delete``) on the JAX
CPU backend and against the port's sequential plain walk.

Each geometry runs batches that overfill the table (FULL keys and unwound
chains), with duplicate keys side by side (inside one window), keys whose
two buckets coincide, chains that come back to a bucket, and padding; then
two rounds of deletes of the first batch. Windows 1, 2, 7, 32 and 512; a
window of 1 takes one round a key. All comparisons are exact (tolerance 0)
on the slots, ``ok``, ``kicks`` and ``deleted``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpubloom.ops import cuckoo as jcuckoo
from tpubloom_torch.ops import cuckoo as pcuckoo

# name -> (log2 slots, keys a batch, batches)
GEOMETRIES = {"2^6": (6, 40, 3), "2^9": (9, 200, 3), "2^12": (12, 1400, 3)}
WINDOWS = [1, 2, 7, 32, 512]
PAD, DUP, SAME_BUCKET = 6, 4, 3


def _u32(t):
    return t.view(torch.int32).numpy().view(np.uint32)


def _batches(log2m, batch, n_batches):
    """Seeded ``(fp, i1, valid)`` batches: the last DUP keys repeat the one
    before them, SAME_BUCKET keys have ``i2 == i1`` (a fingerprint that is a
    multiple of the bucket count: the odd mix keeps its low bits zero), and
    PAD padding lanes end each batch."""
    rng = np.random.default_rng(log2m)
    nb = (1 << log2m) // 4
    out = []
    for _ in range(n_batches):
        fp = rng.integers(1, 0x10000, batch + PAD)
        i1 = rng.integers(0, nb, batch + PAD)
        fp[-PAD - DUP : -PAD] = fp[-PAD - DUP - 1]
        i1[-PAD - DUP : -PAD] = i1[-PAD - DUP - 1]
        fp[1 : 1 + SAME_BUCKET] = nb * rng.integers(1, 0x10000 // nb, SAME_BUCKET)
        valid = np.arange(batch + PAD) < batch
        out.append(tuple(torch.from_numpy(a) for a in (fp, i1, valid)))
    return out


def _jax(slots, fp, i1, valid):
    return (slots, jnp.asarray(fp.numpy().astype(np.uint32)),
            jnp.asarray(i1.numpy().astype(np.uint32)), jnp.asarray(valid.numpy()))


def _revisits(slots, batches):
    """Keys, over the inserts in order, whose kick chain reads a bucket
    twice (a sequential replay by the model's own speculative step)."""
    tbl = _u32(slots).reshape(-1, 4).copy()
    mask, n = tbl.shape[0] - 1, 0
    for fp, i1, valid in batches:
        for f, b, v in zip(fp.tolist(), i1.tolist(), valid.tolist()):
            if v:
                _, _, reads, log = pcuckoo._speculate(tbl, f, b, mask, True)
                n += len(reads) > len(set(reads))
                for bb, s, x in log:
                    tbl[bb, s] = x
    return n


_REFERENCE: dict = {}


def _reference(name):
    """The JAX scans' trajectory of a geometry: each insert's (slots, ok,
    kicks), then each delete's (slots, deleted); checked once against the
    port's sequential plain walk."""
    if name not in _REFERENCE:
        log2m, batch, n_batches = GEOMETRIES[name]
        nb = (1 << log2m) // 4
        batches = _batches(log2m, batch, n_batches)
        jslots = jnp.zeros((nb, 4), jnp.uint32)
        state = torch.zeros((nb, 4), dtype=torch.int32).view(torch.uint32)
        inserts, deletes = [], []
        for fp, i1, valid in batches:
            jslots, jok, jkicks = jcuckoo.cuckoo_insert(*_jax(jslots, fp, i1, valid))
            ok, kicks = pcuckoo.cuckoo_insert(state, fp, i1, valid)
            inserts.append((np.asarray(jslots), np.asarray(jok), np.asarray(jkicks)))
            np.testing.assert_array_equal(_u32(state), inserts[-1][0])
            np.testing.assert_array_equal(ok.numpy(), inserts[-1][1])
            np.testing.assert_array_equal(kicks.numpy(), inserts[-1][2])
        for _ in range(2):
            jslots, jd = jcuckoo.cuckoo_delete(*_jax(jslots, *batches[0]))
            d = pcuckoo.cuckoo_delete(state, *batches[0])
            deletes.append((np.asarray(jslots), np.asarray(jd)))
            np.testing.assert_array_equal(_u32(state), deletes[-1][0])
            np.testing.assert_array_equal(d.numpy(), deletes[-1][1])
        _REFERENCE[name] = batches, inserts, deletes
    return _REFERENCE[name]


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_batches_hold_the_hard_cases(name):
    """The inserts reject FULL keys and kick, keys with one bucket and
    duplicates are placed, some chain comes back to a bucket, padding
    stays untouched, and the deletes find some copies and miss others."""
    batches, inserts, deletes = _reference(name)
    log2m = GEOMETRIES[name][0]
    nb = (1 << log2m) // 4
    fp, i1, _ = batches[0]
    same = pcuckoo.alt_bucket(i1[1 : 1 + SAME_BUCKET], fp[1 : 1 + SAME_BUCKET], nb - 1)
    assert torch.equal(same, i1[1 : 1 + SAME_BUCKET])
    full = sum(int((v.numpy() & ~ok).sum()) for (_, _, v), (_, ok, _) in zip(batches, inserts))
    assert full > 0 and sum(int(k.sum()) for _, _, k in inserts) > 0
    assert inserts[0][1][1 : 1 + SAME_BUCKET].all() and inserts[0][1][-PAD - DUP : -PAD].all()
    assert not any(ok[-PAD:].any() or k[-PAD:].any() for _, ok, k in inserts)
    assert deletes[0][1].any() and not deletes[1][1].all()
    empty = torch.zeros((nb, 4), dtype=torch.int32).view(torch.uint32)
    assert _revisits(empty, batches) > 0


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_rounds_equal_the_scans(name, window):
    batches, inserts, deletes = _reference(name)
    nb = (1 << GEOMETRIES[name][0]) // 4
    state = torch.zeros((nb, 4), dtype=torch.int32).view(torch.uint32)
    rewalked = 0
    for (fp, i1, valid), (jslots, jok, jkicks) in zip(batches, inserts, strict=True):
        ok, kicks, rounds, rw = pcuckoo.cuckoo_walk_rounds(state, fp, i1, valid, window=window,
                                                           insert=True)
        np.testing.assert_array_equal(_u32(state), jslots)
        np.testing.assert_array_equal(ok.numpy(), jok)
        np.testing.assert_array_equal(kicks.numpy(), jkicks)
        B = fp.shape[0]
        assert -(-B // window) <= rounds <= B and rw <= rounds * window - B
        if window == 1:
            assert (rounds, rw) == (B, 0)
        rewalked += rw
    for jslots, jd in deletes:
        d, none, rounds, rw = pcuckoo.cuckoo_walk_rounds(state, *batches[0], window=window,
                                                         insert=False)
        assert none is None
        np.testing.assert_array_equal(_u32(state), jslots)
        np.testing.assert_array_equal(d.numpy(), jd)
        if window == 1:
            assert (rounds, rw) == (batches[0][0].shape[0], 0)
    if window >= 32:
        assert rewalked > 0, "a wide window must meet conflicts and re-walk"


def test_window_must_be_positive():
    state = torch.zeros((4, 4), dtype=torch.int32).view(torch.uint32)
    one = torch.ones(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="window"):
        pcuckoo.cuckoo_walk_rounds(state, one, one - 1, one > 0, window=0, insert=True)
