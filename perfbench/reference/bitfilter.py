"""What the plain references of the bit filters share: a byte a bit, plain
PyTorch.

Independent of the program: a reference reads the configuration's
parameters and the benchmark's keys, and works the state out itself from
the frozen spec (:mod:`perfbench.reference.hashspec`). An insert sets a
key's k bytes, a query asks whether all k are set, and a test-and-insert
answers each key by the state before its batch, then inserts the batch.
Padding (a negative length) sets nothing and answers False.

A configuration names its reference module (``"reference"`` in its file,
``perfbench/reference/<name>.py``), which gives ``Reference`` (the state
and the ops), ``work`` (what one call needs, for the rooflines) and
``control`` (the parameters with one guarantee broken).
"""

from __future__ import annotations

import torch

#: Bits packed to bytes at a time (a chunk's temporaries are its bytes).
PACK_CHUNK = 1 << 28


class BitFilter:
    """A filter of ``m`` bits held a byte a bit; a layout gives
    :meth:`key_bits`."""

    def __init__(self, params: dict, device):
        self.params = dict(params)
        self.bits = torch.zeros(params["m"], dtype=torch.uint8, device=device)

    def key_bits(self, keys, lengths) -> torch.Tensor:
        """The k bit indices of each key: int64 ``[B, k]``."""
        raise NotImplementedError

    def positions(self, keys, lengths) -> tuple[torch.Tensor, torch.Tensor]:
        """``(valid, bits)``: whether each key counts, and its k bit
        indices."""
        return lengths >= 0, self.key_bits(keys, lengths)

    def _query(self, valid, pos) -> torch.Tensor:
        return (self.bits[pos] == 1).all(dim=1) & valid

    def _insert(self, valid, pos) -> None:
        self.bits[pos[valid].reshape(-1)] = 1

    def query(self, keys, lengths) -> torch.Tensor:
        return self._query(*self.positions(keys, lengths))

    def insert(self, keys, lengths) -> None:
        self._insert(*self.positions(keys, lengths))

    def test_insert(self, keys, lengths) -> torch.Tensor:
        valid, pos = self.positions(keys, lengths)
        before = self._query(valid, pos)
        self._insert(valid, pos)
        return before

    def clear(self) -> None:
        self.bits.zero_()

    def packed(self) -> torch.Tensor:
        """The state as the program holds it: ``uint8[m / 8]``, bit ``p``
        at bit ``p % 8`` of byte ``p // 8``."""
        out = torch.empty(self.bits.numel() // 8, dtype=torch.uint8, device=self.bits.device)
        for lo in range(0, self.bits.numel(), PACK_CHUNK):
            b = self.bits[lo : lo + PACK_CHUNK].view(-1, 8)
            acc = b[:, 0].clone()
            for j in range(1, 8):
                acc |= b[:, j] << j
            out[lo // 8 : lo // 8 + acc.numel()] = acc
        return out


def control(params: dict) -> dict:
    """The control's parameters: k - 1 bits a key, which breaks the
    configuration's k (and so its false-positive rate at capacity), the
    cheaper step a later change might be tempted by."""
    return dict(params, k=params["k"] - 1)
