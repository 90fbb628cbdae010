"""Membership of a batch through the device-array entry ``include_arrays``;
the state is only read."""

ANSWERS, SETS = True, False


def program(f, keys, lengths, n_valid):
    return f.include_arrays(keys, lengths)


def reference(ref, keys, lengths):
    return ref.query(keys, lengths)
