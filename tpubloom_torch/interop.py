"""State carried between ``tpubloom`` and the port.

Both packages hold a blocked filter (bit or counting) as the same
row-major little-endian ``uint32`` words, so moving one across is a copy
of its words and of its config's fields. The functions take plain dicts
and numpy arrays, so this module needs nothing of ``tpubloom``:

* ``config_from_dict(tpubloom_filter.config.to_dict())``;
* ``filter_from_words(tpubloom_filter.words_logical, config, device)``
  (or the words of a decoded ``to_bytes()`` blob);
* ``words_to_numpy(port_filter)`` -> ``uint32[NB, W]`` (``[shards, NBL,
  W]`` for a sharded filter), which ``from_bytes(cfg, words.tobytes())`` of
  the matching ``tpubloom`` class takes.
"""

from __future__ import annotations

import numpy as np

from tpubloom_torch.config import FilterConfig
from tpubloom_torch.filter import BlockedBloomFilter, BlockedCountingBloomFilter
from tpubloom_torch.parallel.sharded import ShardedBloomFilter

PortFilter = BlockedBloomFilter | BlockedCountingBloomFilter | ShardedBloomFilter


def config_from_dict(d: dict) -> FilterConfig:
    """A port config from ``tpubloom.FilterConfig.to_dict()`` output
    (headers without ``block_hash`` restore as "ap", as in tpubloom)."""
    return FilterConfig.from_dict(dict(d))


def filter_from_words(
    words_logical: np.ndarray,
    config: FilterConfig,
    device=None,
    *,
    n_inserted: int = 0,
) -> PortFilter:
    """A port filter holding ``words_logical`` (``uint32[NB, W]`` or the
    same words in any shape): a :class:`ShardedBloomFilter` (one slot on
    ``device``, or one per visible card) for ``shards > 1``, else a
    :class:`BlockedCountingBloomFilter` for a counting config, else a
    :class:`BlockedBloomFilter`."""
    if config.shards > 1:
        f = ShardedBloomFilter(config, None if device is None else [device])
    else:
        cls = BlockedCountingBloomFilter if config.counting else BlockedBloomFilter
        f = cls(config, device)
    expect = f.config.n_blocks * f.config.words_per_block
    words = np.asarray(words_logical, dtype=np.uint32)
    if words.size != expect:
        raise ValueError(f"{words.size} words given, the config holds {expect}")
    f._set_words(words)
    f.n_inserted = n_inserted
    return f


def words_to_numpy(f: PortFilter) -> np.ndarray:
    """The filter's words as ``uint32[NB, W]`` on the host."""
    return f.words_logical
