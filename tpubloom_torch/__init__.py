"""tpubloom_torch — the blocked bloom filters on PyTorch and CUDA (Hopper).

The PyTorch/CUDA port of :mod:`tpubloom`, which stays beside it as the
reference. This package imports ``torch`` and numpy, never JAX and never
``tpubloom``. Its filters run on the CUDA card unless the caller passes
``device="cpu"``, where the kernels' plain PyTorch versions run instead.

    from tpubloom_torch import BlockedBloomFilter, BlockedCountingBloomFilter, FilterConfig

    f = BlockedBloomFilter(FilterConfig(m=1 << 32, k=7, block_bits=512))
    present = f.insert_batch([b"alpha", b"beta"], return_presence=True)
    assert f.include_batch([b"alpha", b"beta"]).all()

    c = BlockedCountingBloomFilter(FilterConfig(m=1 << 30, k=7, counting=True))
    c.insert_batch([b"alpha"])
    c.delete_batch([b"alpha"])           # counting filters support delete

    s = ShardedBloomFilter(FilterConfig(m=1 << 36, k=7, block_bits=512, shards=64))
    s.insert_batch([b"alpha"])           # BASELINE config 5: 64 shards, 8 GiB
"""

from tpubloom_torch.config import FilterConfig
from tpubloom_torch.filter import BlockedBloomFilter, BlockedCountingBloomFilter
from tpubloom_torch.parallel.sharded import ShardedBloomFilter

__all__ = [
    "FilterConfig", "BlockedBloomFilter", "BlockedCountingBloomFilter", "ShardedBloomFilter",
]
