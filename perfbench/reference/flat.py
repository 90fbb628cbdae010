"""The plain reference of a flat bloom filter (``BloomFilter``, the Redis
bitmap's positions): each key's k bits anywhere in the ``m`` bits."""

from __future__ import annotations

import torch

from perfbench.reference import bitfilter, bounds, hashspec

control = bitfilter.control


class Reference(bitfilter.BitFilter):
    def key_bits(self, keys, lengths) -> torch.Tensor:
        p = self.params
        return hashspec.flat_bits(keys, lengths, m=p["m"], k=p["k"], seed=p["seed"])


def work(ref: Reference, op, keys, lengths) -> tuple[int, int]:
    """(bytes, operations) that one call of ``op`` on these keys needs, by
    the reference's state before the call: the distinct 32-byte sectors of
    the bits it reads (a query stops at each key's first zero bit), each
    read once (and written once by an op that sets bits)."""
    p = ref.params
    valid, pos = ref.positions(keys, lengths)
    B, L = keys.shape
    if op.ANSWERS and not op.SETS:
        zero = ref.bits[pos] == 0
        first = torch.where(zero.any(dim=1), zero.to(torch.int32).argmax(dim=1), p["k"] - 1)
        read = (torch.arange(p["k"], device=pos.device)[None, :] <= first[:, None]) & valid[:, None]
    else:
        read = valid[:, None].expand_as(pos)
    sectors = int(torch.unique(pos[read] >> 8).numel())
    return bounds.flat(keys=B, valid=int(valid.sum()), L=L, distinct_sectors=sectors,
                       positions=int(read.sum()), answers=op.ANSWERS, sets=op.SETS)
