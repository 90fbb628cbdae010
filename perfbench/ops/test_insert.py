"""Test-and-insert of a batch on a blocked filter: each key's verdict by
the state before the batch, and the batch's bits set. The program's call
is the fused wrapper on the filter's state, as ``insert_batch(...,
return_presence=True)`` makes it after staging (``filter.py`` has no
public device-array test-and-insert)."""

from tpubloom_torch.ops import sweep

ANSWERS, SETS = True, True


def program(f, keys, lengths, n_valid):
    out = sweep.blocked_test_insert(f.words, keys, lengths, f.config)
    f.n_inserted += n_valid
    return out


def reference(ref, keys, lengths):
    return ref.test_insert(keys, lengths)
