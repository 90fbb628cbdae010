"""The 95th percentile, over every batch completed in the window, of the
time from just before its call to when the host saw it complete (host
clock), in ms."""

import numpy as np


def read(view):
    if not view.window.latencies.size:
        return None
    return float(np.percentile(view.window.latencies, 95)) * 1e3
