"""State carried between ``tpubloom`` and the port.

Both packages hold a filter (flat or blocked, bit or counting, on one
device or sharded; a cuckoo filter, a count-min or top-k sketch) as the
same row-major little-endian ``uint32`` words,
so moving one across is a copy of its words and of its config's fields.
The functions take plain dicts and numpy arrays, so this module needs
nothing of ``tpubloom``:

* ``config_from_dict(tpubloom_filter.config.to_dict())``;
* ``filter_from_words(tpubloom_filter.words_logical, config, device)``
  (or the words of a decoded ``to_bytes()`` blob);
* ``words_to_numpy(port_filter)`` -> its ``words_logical`` (``uint32[NB,
  W]``, ``[shards, NBL, W]`` for a sharded blocked filter, the flat words
  in their device shape), whose bytes the matching ``tpubloom`` class
  takes (``from_bytes``, or ``from_redis_bitmap`` after
  ``words_to_redis_bitmap`` for a flat bit filter).
"""

from __future__ import annotations

import numpy as np

from tpubloom_torch.config import FilterConfig
from tpubloom_torch.filter import (
    BlockedBloomFilter, BlockedCountingBloomFilter, BloomFilter, CountingBloomFilter,
)
from tpubloom_torch.parallel.sharded import ShardedBloomFilter
from tpubloom_torch.sketch import registry as sketch_registry

PortFilter = (
    BloomFilter | CountingBloomFilter | BlockedBloomFilter | BlockedCountingBloomFilter
    | ShardedBloomFilter
)  # or a sketch (tpubloom_torch.sketch), built through its registry


def config_from_dict(d: dict) -> FilterConfig:
    """A port config from ``tpubloom.FilterConfig.to_dict()`` output
    (headers without ``block_hash`` restore as "ap", as in tpubloom)."""
    return FilterConfig.from_dict(dict(d))


def new_filter(config: FilterConfig, device=None) -> PortFilter:
    """An empty port filter of the config's layout, as ``tpubloom``'s
    checkpoint restore routes them: a sketch kind's class from
    :mod:`tpubloom_torch.sketch.registry`; a :class:`ShardedBloomFilter`
    for ``shards > 1`` (one slot on ``device``, or with none one slot per
    visible card); else the flat or blocked, bit or counting class (on
    ``device``, or the card)."""
    if sketch_registry.is_sketch(config):
        return sketch_registry.build(config, device)
    if config.shards > 1:
        return ShardedBloomFilter(config, None if device is None else [device])
    if config.block_bits:
        cls = BlockedCountingBloomFilter if config.counting else BlockedBloomFilter
    else:
        cls = CountingBloomFilter if config.counting else BloomFilter
    return cls(config, device)


def filter_from_words(
    words_logical: np.ndarray,
    config: FilterConfig,
    device=None,
    *,
    n_inserted: int = 0,
) -> PortFilter:
    """A port filter (:func:`new_filter`) holding ``words_logical`` (its
    ``words_logical`` array, or the same words in any shape)."""
    f = new_filter(config, device)
    f._set_words(words_logical)
    f.n_inserted = n_inserted
    return f


def words_to_numpy(f: PortFilter) -> np.ndarray:
    """The filter's words on the host, in its ``words_logical`` shape."""
    return f.words_logical
