"""The host's mean time a batch to hand its work to the program (the call
into the port, and the epoch's clear where one precedes it), with no
wait, in the window's stretch before the profiler's: where it nears the batch's device
time, the host sets the pace."""


def read(view):
    if not view.window.batches:
        return None
    return view.window.issue_s / view.window.batches * 1e6
