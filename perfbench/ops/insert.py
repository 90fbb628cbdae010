"""Insert of a batch through the device-array entry ``insert_arrays``."""

ANSWERS, SETS = False, True


def program(f, keys, lengths, n_valid):
    f.insert_arrays(keys, lengths, n_valid=n_valid)


def reference(ref, keys, lengths):
    ref.insert(keys, lengths)
