"""The closed loop that drives the program: one caller keeps ``inflight``
batches queued on the device, issuing the epoch's steps in order and
waiting for the oldest batch before it issues one more.

A batch's latency runs from just before its call (and the epoch's
``clear`` that precedes its first batch) to when the host sees its
completion: a CUDA event recorded after the call, waited on. On the CPU
(the tests) a call is complete when it returns.

Python's collector stays on in the window, as in a user's process. The
loop itself makes no object the collector tracks a batch: the batches'
times and places go into preallocated arrays, the ``inflight`` slots and
their CUDA events are reused, and a call's span is made only in a traced
stretch. What the collector finds to do there is the program's.

A reservoir drawn from the seed keeps the verdicts of a uniform sample of
the window's batches that answer, for the comparison with the reference
once the window has closed.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

#: Batches whose verdicts a window keeps for the comparison.
SAMPLE_BATCHES = 24
#: Batches a stretch's arrays hold before they grow (doubling).
CAPACITY = 1 << 17


@dataclasses.dataclass
class Window:
    """What a stretch of the loop did."""

    seconds: float = 0.0
    batches: int = 0
    keys: int = 0
    issue_s: float = 0.0
    latencies: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))  # s, a batch
    issued: np.ndarray = dataclasses.field(  # position in the epoch of each call
        default_factory=lambda: np.zeros(0, dtype=np.int64))

    def add(self, other: "Window") -> None:
        self.seconds += other.seconds
        self.batches += other.batches
        self.keys += other.keys
        self.issue_s += other.issue_s
        self.latencies = np.concatenate([self.latencies, other.latencies])
        self.issued = np.concatenate([self.issued, other.issued])


class Loop:
    """The epoch's steps over a target (the program, or the control in its
    place), from where the last stretch left off."""

    def __init__(self, target, steps, ops: dict, *, inflight: int, clear_each_epoch: bool,
                 spans: dict, device, sample_seed: int):
        self.target, self.steps, self.ops = target, steps, ops
        self.inflight, self.clear_each_epoch = inflight, clear_each_epoch
        # op -> the name its calls go under in a trace
        self.labels = {op: f"perfbench.{name}" for op, name in spans.items()}
        self.device = device
        self.schedule = [(s, j) for s, st in enumerate(steps) for j in range(st.n_batches)]
        self.position = 0  # next step of the epoch
        self.epochs = 0
        self.rng = np.random.default_rng(sample_seed)
        self.sample: list = []  # (position, verdicts)
        self.answered = 0
        cuda = device.type == "cuda"
        self.events = [torch.cuda.Event() if cuda else None for _ in range(inflight)]
        self.capacity = CAPACITY

    @property
    def done_in_epoch(self) -> int:
        """Steps of the current epoch whose calls have been issued."""
        return self.position if self.position else len(self.schedule)

    def _keep(self, position: int, out) -> None:
        if len(self.sample) < SAMPLE_BATCHES:
            self.sample.append((position, out))
        else:
            j = int(self.rng.integers(0, self.answered + 1))
            if j < SAMPLE_BATCHES:
                self.sample[j] = (position, out)
        self.answered += 1

    def reset_sample(self) -> None:
        self.sample, self.answered = [], 0

    def run(self, seconds: float, *, annotate: bool = False) -> Window:
        """Issue batches for ``seconds``, then wait for every one issued.
        ``annotate``: mark each call, wait and ``clear`` with a profiler
        span."""
        record = torch.profiler.record_function
        cap = self.capacity
        t_issue = np.empty(cap)
        t_done = np.empty(cap)
        issued = np.empty(cap, dtype=np.int64)
        n_valid = np.empty(cap, dtype=np.int64)
        events, inflight = self.events, self.inflight
        issue_s = 0.0
        head = tail = 0  # batches issued, batches seen complete

        t0 = time.perf_counter()
        stop = t0 + seconds
        while time.perf_counter() < stop:
            if head == cap:
                cap *= 2
                t_issue, t_done, issued, n_valid = (np.resize(a, cap) for a in (t_issue, t_done, issued,
                                                                                n_valid))
            position = self.position
            s, j = self.schedule[position]
            step = self.steps[s]
            op = self.ops[step.op]
            t = time.perf_counter()
            clear = position == 0 and self.epochs and self.clear_each_epoch
            if annotate:
                if clear:
                    with record("perfbench.clear"):
                        self.target.clear()
                with record(self.labels[step.op]):
                    out = self.target.call(op, step.keys[j], step.lengths[j], step.n_valid[j])
            else:
                if clear:
                    self.target.clear()
                out = self.target.call(op, step.keys[j], step.lengths[j], step.n_valid[j])
            issue_s += time.perf_counter() - t
            event = events[head % inflight]
            if event is not None:
                event.record()
            t_issue[head] = t
            issued[head] = position
            n_valid[head] = step.n_valid[j]
            head += 1
            if op.ANSWERS:
                self._keep(position, out)
            out = None
            self.position = position + 1
            if self.position == len(self.schedule):
                self.position = 0
                self.epochs += 1
            while head - tail >= inflight:
                tail = self._complete(tail, t_done, annotate)
        while head > tail:
            tail = self._complete(tail, t_done, annotate)
        w = Window(seconds=time.perf_counter() - t0, batches=head, keys=int(n_valid[:head].sum()),
                   issue_s=issue_s, latencies=t_done[:head] - t_issue[:head], issued=issued[:head].copy())
        self.capacity = max(self.capacity, cap)
        return w

    def _complete(self, tail: int, t_done: np.ndarray, annotate: bool) -> int:
        """Wait for batch ``tail``; returns the next batch to wait for."""
        event = self.events[tail % self.inflight]
        if event is not None:
            if annotate:
                with torch.profiler.record_function("perfbench.wait"):
                    event.synchronize()
            else:
                event.synchronize()
        t_done[tail] = time.perf_counter()
        return tail + 1
