"""Kernel tracing/profiling helpers on ``torch.profiler``: the port of
``tpubloom/utils/tracing.py``, under the same names.

A trace records the host's calls and, where a CUDA card is present, the
card's kernels and copies (CUPTI), into ``log_dir`` as a Chrome trace
(``*.pt.trace.json``: open it in Perfetto, ui.perfetto.dev, or
TensorBoard's profile plugin). Named annotations make individual batches
show up in the timeline.

Usage::

    from tpubloom_torch.utils import tracing

    with tracing.trace("traces/stream"):               # a whole window
        with tracing.annotate("insert_batch", batch=len(keys)):
            f.insert_batch(keys)

    # or one-shot around a callable:
    result, trace_dir = tracing.profile_call(fn, *args)

``request_span`` folds a batch size and a request id into the span name,
so that a slowlog entry's id can be searched for in a trace.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Any, Callable, Iterator

import torch

from tpubloom_torch.obs.context import Range


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str, *, create: bool = True) -> Iterator[str]:
    """Capture a ``torch.profiler`` host (+ card) trace into ``log_dir``:
    one ``<worker>.<time>.pt.trace.json`` a window."""
    if create:
        os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(
        activities=_activities(),
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    )
    prof.start()
    try:
        yield log_dir
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the window's device work lands in it
        prof.stop()


def annotate(name: str, **attrs: Any) -> Range:
    """Named span in the profiler timeline: the port's
    :class:`~tpubloom_torch.obs.context.Range` (a ``RecordFunction``
    range while the profiler records, nothing otherwise).

    ``attrs`` are folded into the span name (the span carries no
    structured payload) — keep them short, e.g. ``batch=4096``.
    """
    if attrs:
        name = name + "[" + ",".join(f"{k}={v}" for k, v in attrs.items()) + "]"
    return Range(name)


def request_span(
    name: str, *, batch: int | None = None, rid: str | None = None
) -> Range:
    """Request-correlated :func:`annotate` span: folds the batch size and
    request id into the span name, silently dropping absent attrs (a
    library call without an active request has no rid)."""
    attrs: dict[str, Any] = {}
    if batch is not None:
        attrs["batch"] = batch
    if rid:
        attrs["rid"] = rid
    return annotate(name, **attrs)


def profile_call(
    fn: Callable[..., Any], *args: Any, log_dir: str | None = None, **kwargs: Any
) -> tuple[Any, str]:
    """Run ``fn(*args, **kwargs)`` under a one-shot trace.

    Returns ``(result, trace_dir)``. The trace waits for the card (a
    synchronise) before it closes, so the call's device work lands inside
    the captured window.
    """
    if log_dir is None:
        log_dir = tempfile.mkdtemp(prefix="tpubloom-torch-trace-")
    with trace(log_dir):
        result = fn(*args, **kwargs)
    return result, log_dir
