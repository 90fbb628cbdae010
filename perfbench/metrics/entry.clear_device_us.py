"""The device time of an epoch's ``clear()`` (the operations it launched
in the traced stretch, over the clears there), in us: the rotation's cost,
apart from the batches it delays."""


def read(view):
    t = view.trace
    if t is None:
        return None
    clears = t.spans.get("perfbench.clear", 0)
    spent = t.op_device_s.get("perfbench.clear", 0.0)
    if not clears or spent <= 0:
        return None
    return spent / clears * 1e6
