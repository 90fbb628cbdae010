"""Cuckoo filter in plain PyTorch: the plain versions of the cuckoo kernels
(``tpubloom_torch/csrc/cuckoo.cu``), held bit for bit against
``tpubloom/ops/cuckoo.py``.

Layout and spec (``tpubloom``'s): the state is ``uint32[n_buckets,
BUCKET_SIZE]`` (``n_buckets`` a power of two), one 16-bit fingerprint a
``uint32`` slot, 0 an empty slot. A key's fingerprint and primary bucket
come from the shared base hashes (:func:`tpubloom_torch.ops.hashing.
base_hashes`)::

    fp = (h_a mod 0xFFFF) + 1          (in [1, 0xFFFF]; mod, not a mask)
    i1 = h_b & (n_buckets - 1)
    i2 = (i1 XOR fp * 0x5BD1E995) & (n_buckets - 1)     (u32 wrap)

An insert walks the batch in order, since each key sees the table the keys
before it left: the fingerprint goes to the FIRST empty slot of ``i1``,
else of ``i2``; else the kick chain starts at ``i2``: at step ``t`` (of
at most ``MAX_KICKS``) the carried fingerprint ``f`` evicts slot ``(f +
t) mod 4`` of its bucket and the victim tries the first empty slot of its
own alternate bucket. A chain that ends without a place (FULL) is unwound
backwards, so the table is exactly as before the key. ``kicks`` counts the
steps taken (``MAX_KICKS`` for a FULL key). A delete removes the FIRST
matching slot of ``i1``, else of ``i2``, one copy a key, in batch order. A
query is a fingerprint match in either bucket. Padding (``lengths < 0``)
changes nothing and answers False, with 0 kicks.

The sequential walks run on a numpy view of the CPU state (they are
loops over the batch in order, one key at a time, as ``tpubloom``'s
``lax.scan``); the hashing and the query are torch. Values are int64
tensors holding u32s; the state is read and written through its ``int32``
view (torch's ``uint32`` has no adds, shifts or indexed writes on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from tpubloom_torch.ops import hashing
from tpubloom_torch.ops.hashing import M32, mul32

#: Fingerprints a bucket, as ``tpubloom``: ~95 % load with 2 buckets a key.
BUCKET_SIZE = 4

#: Kick-chain bound, as ``tpubloom``: a longer chain means the table is
#: effectively full, reported as FULL.
MAX_KICKS = 32

ALT_MIX = 0x5BD1E995  # MurmurHash2's multiplicative constant


def derive(keys: torch.Tensor, lengths: torch.Tensor, *, n_buckets: int, seed: int):
    """``(fp, i1)``: int64 ``[B]`` fingerprints in [1, 0xFFFF] and primary
    buckets (``tpubloom.ops.cuckoo.derive``; padding lanes hash whatever
    they hold and are no-ops)."""
    h_a, h_b, _, _ = hashing.base_hashes(keys, lengths, seed)
    return h_a % 0xFFFF + 1, h_b & (n_buckets - 1)


def alt_bucket(bucket, fp, mask: int):
    """The alternate bucket ``(bucket ^ fp * 0x5BD1E995) & mask`` (u32
    wrap): an involution, so it maps i1 to i2 and back from the stored
    fingerprint alone. Tensors (int64 u32 values) or Python ints."""
    if isinstance(fp, torch.Tensor):
        return (bucket ^ mul32(fp, ALT_MIX)) & mask
    return (bucket ^ (fp * ALT_MIX & M32)) & mask


def _table(slots: torch.Tensor) -> np.ndarray:
    """``uint32[n_buckets, BUCKET_SIZE]`` numpy view of a CPU state (the
    same memory: writes land in the tensor)."""
    if slots.device.type != "cpu":
        raise ValueError("the plain cuckoo walks run on a CPU state")
    return slots.view(torch.int32).numpy().view(np.uint32).reshape(-1, BUCKET_SIZE)


def _first(row, value: int) -> int:
    """Index of the first slot of ``row`` equal to ``value``, -1 if none."""
    for s in range(BUCKET_SIZE):
        if row[s] == value:
            return s
    return -1


def cuckoo_insert(slots: torch.Tensor, fp: torch.Tensor, i1: torch.Tensor,
                  valid: torch.Tensor, reads: set | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Insert a batch of fingerprints in batch order, in place
    (``tpubloom.ops.cuckoo.cuckoo_insert``); returns ``(ok bool[B], kicks
    int32[B])``: False for a FULL key (its chain unwound) and for padding.
    Each bucket the walk reads is added to ``reads`` when one is given."""
    tbl = _table(slots)
    mask = tbl.shape[0] - 1
    B = fp.shape[0]
    ok = np.zeros(B, dtype=bool)
    kicks = np.zeros(B, dtype=np.int32)
    for i, (f, b1, v) in enumerate(zip(fp.tolist(), i1.tolist(), valid.tolist())):
        if not v:
            continue
        placed = False
        for b in (b1, alt_bucket(b1, f, mask)):
            if reads is not None:
                reads.add(b)
            s = _first(tbl[b], 0)
            if s >= 0:
                tbl[b, s] = f
                placed = True
                break
        if placed:
            ok[i] = True
            continue
        b = alt_bucket(b1, f, mask)
        path = []  # (bucket, slot, victim) of each step
        for t in range(MAX_KICKS):
            s = (f + t) % BUCKET_SIZE
            victim = int(tbl[b, s])
            tbl[b, s] = f
            path.append((b, s, victim))
            nb = alt_bucket(b, victim, mask)
            if reads is not None:
                reads.add(nb)
            e = _first(tbl[nb], 0)
            if e >= 0:
                tbl[nb, e] = victim
                placed = True
                break
            f, b = victim, nb
        kicks[i] = len(path)
        if placed:
            ok[i] = True
            continue
        # FULL: the only writes were the swaps, so restoring each slot's
        # victim from the last step back leaves the table as it was
        for b, s, victim in reversed(path):
            tbl[b, s] = victim
    return torch.from_numpy(ok), torch.from_numpy(kicks)


def cuckoo_delete(slots: torch.Tensor, fp: torch.Tensor, i1: torch.Tensor,
                  valid: torch.Tensor, reads: set | None = None) -> torch.Tensor:
    """Remove one stored copy of each key's fingerprint, in batch order, in
    place (``tpubloom.ops.cuckoo.cuckoo_delete``); returns ``bool[B]``,
    whether a copy was there. Each bucket read is added to ``reads`` when
    one is given."""
    tbl = _table(slots)
    mask = tbl.shape[0] - 1
    deleted = np.zeros(fp.shape[0], dtype=bool)
    for i, (f, b1, v) in enumerate(zip(fp.tolist(), i1.tolist(), valid.tolist())):
        if not v:
            continue
        for b in (b1, alt_bucket(b1, f, mask)):
            if reads is not None:
                reads.add(b)
            s = _first(tbl[b], f)
            if s >= 0:
                tbl[b, s] = 0
                deleted[i] = True
                break
    return torch.from_numpy(deleted)


def cuckoo_query(slots: torch.Tensor, fp: torch.Tensor, i1: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Membership: the fingerprint in either bucket (``tpubloom.ops.
    cuckoo.cuckoo_query``); ``bool[B]``, False for padding."""
    tbl = slots.view(torch.int32).reshape(-1, BUCKET_SIZE).to(torch.int64) & M32
    mask = tbl.shape[0] - 1
    b2 = alt_bucket(i1, fp, mask)
    f = fp[:, None]
    return ((tbl[i1] == f).any(-1) | (tbl[b2] == f).any(-1)) & valid


def occupancy(slots: torch.Tensor) -> int:
    """Occupied slots (``tpubloom.ops.cuckoo.occupancy``)."""
    return int((slots.view(torch.int32) != 0).sum())


def _derived(keys, lengths, config):
    fp, i1 = derive(keys, lengths, n_buckets=config.m // BUCKET_SIZE, seed=config.seed)
    return fp, i1, lengths >= 0


def cuckoo_insert_plain(state, keys, lengths, config,
                        reads: set | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the ``cuckoo_insert`` kernel: the keys' inserts in
    batch order on ``state`` (``uint32[config.m]``, any shape), in place;
    ``(ok bool[B], kicks int32[B])``. ``reads`` as :func:`cuckoo_insert`."""
    return cuckoo_insert(state, *_derived(keys, lengths, config), reads)


def cuckoo_delete_plain(state, keys, lengths, config, reads: set | None = None) -> torch.Tensor:
    """Plain version of the ``cuckoo_delete`` kernel; ``deleted bool[B]``.
    ``reads`` as :func:`cuckoo_delete`."""
    return cuckoo_delete(state, *_derived(keys, lengths, config), reads)


def cuckoo_query_plain(state, keys, lengths, config) -> torch.Tensor:
    """Plain version of the ``cuckoo_query`` kernel; ``bool[B]``."""
    return cuckoo_query(state, *_derived(keys, lengths, config))
