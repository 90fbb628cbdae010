"""tpubloom_torch — the bloom filters of tpubloom on PyTorch and CUDA (Hopper).

The PyTorch/CUDA port of :mod:`tpubloom`, which stays beside it as the
reference. This package imports ``torch`` and numpy, never JAX and never
``tpubloom``. Its filters run on the CUDA card unless the caller passes
``device="cpu"``, where the kernels' plain PyTorch versions run instead.

    from tpubloom_torch import BlockedBloomFilter, BlockedCountingBloomFilter, FilterConfig
    from tpubloom_torch import BloomFilter, CountingBloomFilter, ShardedBloomFilter

    f = BlockedBloomFilter(FilterConfig(m=1 << 32, k=7, block_bits=512))
    present = f.insert_batch([b"alpha", b"beta"], return_presence=True)
    assert f.include_batch([b"alpha", b"beta"]).all()

    c = BlockedCountingBloomFilter(FilterConfig(m=1 << 30, k=7, counting=True))
    c.insert_batch([b"alpha"])
    c.delete_batch([b"alpha"])           # counting filters support delete

    s = ShardedBloomFilter(FilterConfig(m=1 << 36, k=7, block_bits=512, shards=64))
    s.insert_batch([b"alpha"])           # BASELINE config 5: 64 shards, 8 GiB

    b = BloomFilter(FilterConfig(m=1 << 30, k=10))  # the flat layout (config 2)
    b.insert_batch([b"alpha"])
    bitmap = b.to_redis_bitmap()         # the reference gem's SETBIT bytes

    from tpubloom_torch.checkpoint import FileSink
    ins = StreamInserter(b, batch_size=1 << 16, sink=FileSink("ckpt"),
                         checkpoint_every=1 << 24)    # BASELINE config 3
    ins.run(b"warc-record-%014d" % i for i in range(1 << 26))
    assert ins.close()                   # the final checkpoint landed

    g = ScalableBloomFilter(1 << 22, 0.01, config=FilterConfig(m=64, k=1, block_bits=512))
    g.insert_batch([b"alpha"])           # BF.RESERVE ... EXPANSION 2: grows when full

    cf = CuckooFilter(FilterConfig(m=1 << 24, k=2, kind="cuckoo"))
    cf.insert_batch([b"alpha"])
    assert cf.take_insert_flags().all()  # False would be FULL
    cf.delete_batch([b"alpha"])

    cms = CountMinSketch(FilterConfig(m=2_718_304, k=7, kind="cms"))
    cms.increment_batch([b"alpha"], [3])  # -> the estimates after the update
    top = TopKSketch(FilterConfig(m=2_718_304, k=7, kind="topk", topk=100))
    top.insert_batch([b"alpha"] * 5)
    top.topk_list()                      # [(b"alpha", 5)]

    from tpubloom_torch import CPUBlockedBloomFilter, optimal_m_k
    m, k = optimal_m_k(1_000_000, 0.01)
    ref = CPUBlockedBloomFilter(FilterConfig(m=1 << 24, k=k, block_bits=512))
    ref.insert_batch([b"alpha"])         # the CPU driver: numpy and C++ on the host
"""

from tpubloom_torch.version import __version__

#: where each public name lives; a name's module is imported on first use,
#: so that ``import tpubloom_torch.cluster`` (the admin CLI, the fleet
#: scraper, the cluster client) and the CPU driver (``cpu_ref``) load
#: neither torch nor the kernels
_HOMES = {
    "FilterConfig": "config", "BloomFilter": "filter", "CountingBloomFilter": "filter",
    "BlockedBloomFilter": "filter", "BlockedCountingBloomFilter": "filter",
    "ShardedBloomFilter": "parallel.sharded", "StreamInserter": "parallel.pipeline",
    "resume_offset": "parallel.pipeline", "AsyncCheckpointer": "checkpoint",
    "ScalableBloomFilter": "scalable", "CuckooFilter": "sketch.cuckoo",
    "CountMinSketch": "sketch.cms", "TopKSketch": "sketch.cms",
    "optimal_m_k": "params", "theoretical_fpr": "params",
    "CPUBloomFilter": "cpu_ref", "CPUBlockedBloomFilter": "cpu_ref",
    "CPUScalableBloomFilter": "scalable",
}

__all__ = ["__version__", *_HOMES]


def __getattr__(name: str):
    import importlib

    if name not in _HOMES:
        raise AttributeError(f"module 'tpubloom_torch' has no attribute {name!r}")
    value = getattr(importlib.import_module(f"tpubloom_torch.{_HOMES[name]}"), name)
    globals()[name] = value
    return value

