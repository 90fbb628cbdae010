"""Device operations (kernels, copies, memsets) that the cell's calls into
the port launched in the traced stretch, a call: what fusing or splitting
a wrapper's kernels moves (``torch.profiler``; an operation belongs to the
call whose span holds its launch)."""


def read(view):
    t = view.trace
    if t is None:
        return None
    calls = sum(t.spans.get(name, 0) for name in view.calls)
    launched = sum(t.op_count.get(name, 0) for name in view.calls)
    if not calls or not launched:
        return None
    return launched / calls
