"""The one traffic generator: reads a mix's parameters (``traffic/<mix>.json``)
and makes its keys on the device from ``--seed``.

A mix is a closed loop: one caller keeps ``inflight`` batches queued on the
card. Its parameters:

* ``fill`` (optional): ``{"keys", "batch"}``, inserted during set-up;
* ``epoch``: the steps the loop runs in order, again and again, each
  ``{"op", "batch", and "batches" or "keys"}``: ``keys`` valid keys in
  batches of ``batch`` rows, the last padded with length -1 (the port's
  padding), or ``batches`` full batches. A step's batches are made once and
  replayed in every epoch. Optional: ``repeat_share``, the share of a
  batch that repeats keys drawn uniformly from the step's earlier batches;
  ``held_share`` with ``held_from`` (``"fill"`` or ``"epoch"``), the share
  that repeats keys of the fill or of the epoch's earlier steps that set
  bits. Every other key is fresh: 16 uniform bytes (``key_len`` of the
  configuration) a key, so two fresh keys never meet;
* ``clear_each_epoch``: whether the filter is cleared between epochs.

Every seed gets the same sizes, batches and order; only the keys differ.
"""

from __future__ import annotations

import dataclasses
import hashlib

import torch


def sub_seed(seed: int, *parts) -> int:
    """A generator seed for one purpose, drawn from ``seed``."""
    text = "/".join(str(p) for p in (seed, *parts)).encode()
    return int.from_bytes(hashlib.blake2b(text, digest_size=8).digest(), "little") >> 1


def _generator(device, seed: int, *parts) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *parts))


@dataclasses.dataclass
class Step:
    """One step of an epoch: an op over a pool of batches."""

    op: str
    keys: torch.Tensor  # uint8[n_batches, batch, L]
    lengths: list  # int32[batch] a batch (shared where alike)
    n_valid: list  # valid keys a batch

    @property
    def n_batches(self) -> int:
        return self.keys.shape[0]


def _sizes(step: dict) -> tuple[int, int, list]:
    """(rows a batch, batches, valid keys a batch) of a step or fill."""
    B = int(step["batch"])
    if "batches" in step:
        n = int(step["batches"])
        return B, n, [B] * n
    total = int(step["keys"])
    n = -(-total // B)
    return B, n, [B] * (n - 1) + [total - B * (n - 1)]


def _lengths(B: int, n_valid: list, L: int, device) -> list:
    full = torch.full((B,), L, dtype=torch.int32, device=device)
    out = []
    for v in n_valid:
        if v == B:
            out.append(full)
        else:
            t = full.clone()
            t[v:] = -1
            out.append(t)
    return out


def _fresh(n_batches: int, B: int, n_valid: list, L: int, gen, device) -> torch.Tensor:
    keys = torch.zeros((n_batches, B, L), dtype=torch.uint8, device=device)
    for j in range(n_batches):
        keys[j, : n_valid[j]] = torch.randint(0, 256, (n_valid[j], L), dtype=torch.uint8,
                                              device=device, generator=gen)
    return keys


def _valid_rows(step: Step) -> torch.Tensor:
    """The valid rows of a step's pool as ``uint8[n, L]``: every batch's
    valid rows come first in it."""
    B = step.keys.shape[1]
    rows = step.keys.view(-1, step.keys.shape[2])
    if all(v == B for v in step.n_valid):
        return rows
    return torch.cat([step.keys[j, :v] for j, v in enumerate(step.n_valid)])


def _overwrite(keys: torch.Tensor, n_valid: int, share: float, source: torch.Tensor, gen) -> None:
    """Put ``share`` of a batch's valid rows, at places drawn from ``gen``,
    to keys drawn uniformly from ``source`` (``uint8[n, L]``)."""
    n = round(share * n_valid)
    if n == 0:
        return
    where = torch.randperm(n_valid, device=keys.device, generator=gen)[:n]
    pick = torch.randint(0, source.shape[0], (n,), device=keys.device, generator=gen)
    keys[where] = source[pick]


def make_fill(traffic: dict, L: int, seed: int, device) -> Step | None:
    """The set-up fill's batches (the same for a seed on every call)."""
    spec = traffic.get("fill")
    if not spec:
        return None
    B, n, n_valid = _sizes(spec)
    keys = _fresh(n, B, n_valid, L, _generator(device, seed, "fill"), device)
    return Step("insert", keys, _lengths(B, n_valid, L, device), n_valid)


def make_epoch(traffic: dict, L: int, seed: int, device, fill: Step | None) -> list[Step]:
    """The epoch's steps, each with its pool of batches."""
    steps: list[Step] = []
    for s, spec in enumerate(traffic["epoch"]):
        B, n, n_valid = _sizes(spec)
        keys = _fresh(n, B, n_valid, L, _generator(device, seed, "step", s), device)
        pick = _generator(device, seed, "pick", s)
        repeat = float(spec.get("repeat_share", 0))
        held = float(spec.get("held_share", 0))
        if held:
            if spec.get("held_from") == "fill":
                if fill is None:
                    raise ValueError("held_from fill needs a fill")
                source = _valid_rows(fill)
            else:
                earlier = [_valid_rows(t) for t in steps if t.op in ("insert", "test_insert")]
                if not earlier:
                    raise ValueError("held_from epoch needs an earlier step that sets bits")
                source = torch.cat(earlier)
            for j in range(n):
                _overwrite(keys[j], n_valid[j], held, source, pick)
        if repeat:
            if any(v != B for v in n_valid):
                raise ValueError("repeat_share needs full batches")
            rows = keys.view(-1, L)
            for j in range(1, n):
                _overwrite(keys[j], B, repeat, rows[: j * B], pick)
        steps.append(Step(spec["op"], keys, _lengths(B, n_valid, L, device), n_valid))
    return steps
