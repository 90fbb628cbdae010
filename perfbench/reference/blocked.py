"""The plain reference of a blocked bloom filter (``BlockedBloomFilter``):
each key's k bits in one row of ``block_bits`` bits."""

from __future__ import annotations

import torch

from perfbench.reference import bitfilter, bounds, hashspec

control = bitfilter.control


class Reference(bitfilter.BitFilter):
    def key_bits(self, keys, lengths) -> torch.Tensor:
        p = self.params
        return hashspec.blocked_bits(keys, lengths, m=p["m"], k=p["k"], seed=p["seed"],
                                     block_bits=p["block_bits"], block_hash=p["block_hash"])


def work(ref: Reference, op, keys, lengths) -> tuple[int, int]:
    """(bytes, operations) that one call of ``op`` on these keys needs: the
    distinct rows the batch's keys fall in, each read once (and written
    once by an op that sets bits)."""
    p = ref.params
    valid, pos = ref.positions(keys, lengths)
    B, L = keys.shape
    rows = int(torch.unique(pos[valid, 0] // p["block_bits"]).numel())
    return bounds.blocked(keys=B, L=L, k=p["k"], row_bytes=p["block_bits"] // 8,
                          distinct_rows=rows, answers=op.ANSWERS, sets=op.SETS)
