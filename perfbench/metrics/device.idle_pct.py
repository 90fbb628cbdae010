"""The share of the traced window in which no kernel, copy or memset ran
on the card (``torch.profiler``)."""


def read(view):
    if view.trace is None:
        return None
    return 100.0 * (1.0 - view.trace.busy_s / view.trace.window_s)
