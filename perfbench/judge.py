"""Whether what the timed path produced is correct, and the work its calls
needed, both from the plain reference that the configuration names.

The reference is given the same keys as the program and works the state
out again itself: it replays the set-up fill and then the epoch, step by
step, and on the way

* compares each sampled batch's verdicts with its own at that step of the
  epoch (every epoch replays the same batches after a ``clear``, or reads
  the same filled state, so a step's verdicts are the same in each one);
* counts, for each batch that a traced window issued, the bytes and
  operations its call needed (the reference module's ``work``), from the
  keys and the reference's state before the call;
* compares the program's state at the close of the window with its own
  after as many steps of the epoch.

Numbers compared, each with the limit 0 (the comparison is exact):
``verdicts_differ`` (sampled verdicts that differ) and
``state_bytes_differ`` (bytes of the state that differ).
"""

from __future__ import annotations

import torch

LIMITS = {"verdicts_differ": 0, "state_bytes_differ": 0}
#: Bytes of the two states compared at a time.
COMPARE_CHUNK = 1 << 27


def bytes_differ(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.numel() != b.numel():
        return max(a.numel(), b.numel())
    return sum(int((a[i : i + COMPARE_CHUNK] != b[i : i + COMPARE_CHUNK]).sum())
               for i in range(0, a.numel(), COMPARE_CHUNK))


def replay(family, params: dict, ops: dict, fill, steps, *, device, sample: list, state_at: int,
           program_state: torch.Tensor, count_work: set) -> tuple[dict, dict]:
    """Replay the fill and one epoch on ``family``'s reference. ``sample``:
    ``(position, verdicts)`` of the program; ``state_at``: the steps of the
    epoch that the program's state holds; ``count_work``: the positions in
    the epoch whose work to count. Returns (compared numbers, work by
    position)."""
    ref = family.Reference(params, device)
    if fill is not None:
        for j in range(fill.n_batches):
            ref.insert(fill.keys[j], fill.lengths[j])
    by_position: dict = {}
    for position, verdicts in sample:
        by_position.setdefault(position, []).append(verdicts)
    schedule = [(s, j) for s, st in enumerate(steps) for j in range(st.n_batches)]
    last = max([state_at - 1, *by_position, *count_work])
    differ, done, state = 0, {}, None
    for position, (s, j) in enumerate(schedule[: last + 1]):
        st = steps[s]
        op = ops[st.op]
        keys, lengths = st.keys[j], st.lengths[j]
        if position in count_work:
            done[position] = family.work(ref, op, keys, lengths)
        out = op.reference(ref, keys, lengths)
        for verdicts in by_position.get(position, ()):
            differ += int((verdicts.to(torch.bool) != out).sum())
        if position == state_at - 1:
            state = bytes_differ(program_state, ref.packed())
    return {"verdicts_differ": differ, "state_bytes_differ": state}, done
