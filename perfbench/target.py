"""What the loop drives: the program (``tpubloom_torch``), or, for the
control, the plain reference put in its place with one guarantee of the
configuration broken (its reference module's ``control``)."""

from __future__ import annotations

import torch

from perfbench.reference import family


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A state tensor's bytes, little-endian, as ``uint8[-1]``."""
    if t.dtype == torch.uint32:
        t = t.view(torch.int32)
    return t.contiguous().view(torch.uint8).reshape(-1)


class Program:
    """A filter of the configuration's class (``"filter"``), from the
    port's package; its state is the attribute the configuration names
    (``"state"``)."""

    def __init__(self, config: dict, device):
        import tpubloom_torch
        from tpubloom_torch.config import FilterConfig

        self.filter = getattr(tpubloom_torch, config["filter"])(
            FilterConfig(**config["params"]), device=device)
        self._state = config["state"]

    def call(self, op, keys, lengths, n_valid):
        return op.program(self.filter, keys, lengths, n_valid)

    def clear(self) -> None:
        self.filter.clear()

    def state_bytes(self) -> torch.Tensor:
        return as_bytes(getattr(self.filter, self._state))


class Control:
    """The configuration's reference in the program's place, with the
    parameters its ``control`` breaks."""

    def __init__(self, config: dict, device):
        ref = family(config["reference"])
        self.ref = ref.Reference(ref.control(config["params"]), device)

    def call(self, op, keys, lengths, n_valid):
        return op.reference(self.ref, keys, lengths)

    def clear(self) -> None:
        self.ref.clear()

    def state_bytes(self) -> torch.Tensor:
        return self.ref.packed()


TARGETS = {"program": Program, "control": Control}
