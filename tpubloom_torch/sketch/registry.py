"""Kind registry: the one table that makes the port's filter kinds pluggable.

A copy of ``tpubloom/sketch/registry.py`` whose factories name the port's
classes (``tpubloom_torch.sketch.*``), resolved lazily so that the registry
imports nothing heavy. Every decision that varies by kind is a column:

* ``factory`` — builds the filter from its ``FilterConfig`` (checkpoint
  restore and :func:`tpubloom_torch.interop.new_filter` both dispatch
  through it, so the two cannot disagree on construction);
* ``blob_format`` — the checkpoint payload tag, the same as ``tpubloom``'s
  (``sketch_{cuckoo,cms,topk}_le_words``: the flat ``uint32`` storage's
  little-endian words); a restore refuses a blob whose tag does not match
  the config's kind;
* ``replay_unsafe_insert`` — whether replaying an acknowledged insert
  changes state (a cuckoo add stores a second copy; a count-min add
  doubles a count);
* ``supports_delete`` — whether a delete is legal (cuckoo: yes; count-min
  and top-k: no).

The ``"bloom"`` kind is not a row: the bloom family keeps its own routing
(:mod:`tpubloom_torch.interop`, :mod:`tpubloom_torch.checkpoint`), and the
helpers answer the neutral value for it.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

__all__ = [
    "KindSpec",
    "blob_format",
    "build",
    "is_sketch",
    "kind_of",
    "replay_unsafe_insert",
    "sketch_kinds",
    "spec",
    "supports_delete",
]


@dataclasses.dataclass(frozen=True)
class KindSpec:
    """One pluggable filter kind. ``factory`` is a ``module:Class``
    dotted path resolved lazily (the sketch classes import torch and their
    kernels; the registry stays importable without them)."""

    name: str
    factory: str
    blob_format: str
    replay_unsafe_insert: bool
    supports_delete: bool

    def resolve(self) -> Callable:
        module, _, attr = self.factory.partition(":")
        return getattr(importlib.import_module(module), attr)


_SPECS = {
    "cuckoo": KindSpec(
        name="cuckoo",
        factory="tpubloom_torch.sketch.cuckoo:CuckooFilter",
        blob_format="sketch_cuckoo_le_words",
        replay_unsafe_insert=True,  # multiset adds: replay stores a 2nd copy
        supports_delete=True,
    ),
    "cms": KindSpec(
        name="cms",
        factory="tpubloom_torch.sketch.cms:CountMinSketch",
        blob_format="sketch_cms_le_words",
        replay_unsafe_insert=True,  # replayed increment doubles counts
        supports_delete=False,
    ),
    "topk": KindSpec(
        name="topk",
        factory="tpubloom_torch.sketch.cms:TopKSketch",
        blob_format="sketch_topk_le_words",
        replay_unsafe_insert=True,  # CMS-backed: same doubling hazard
        supports_delete=False,
    ),
}


def sketch_kinds() -> tuple:
    """Registered sketch kinds (excludes "bloom")."""
    return tuple(sorted(_SPECS))


def kind_of(config) -> str:
    """The kind of a FilterConfig or config dict ("bloom" when absent —
    every header/record written before the field existed is bloom)."""
    if isinstance(config, dict):
        return config.get("kind") or "bloom"
    return getattr(config, "kind", "bloom") or "bloom"


def is_sketch(config) -> bool:
    return kind_of(config) != "bloom"


def spec(kind: str) -> KindSpec:
    try:
        return _SPECS[kind]
    except KeyError:
        raise ValueError(
            f"unknown filter kind {kind!r} (registered: {sketch_kinds()})"
        ) from None


def build(config, device=None):
    """Construct the filter instance for a sketch-kind config, on
    ``device`` (the card unless given)."""
    return spec(kind_of(config)).resolve()(config, device)


def blob_format(config) -> str:
    return spec(kind_of(config)).blob_format


def replay_unsafe_insert(config) -> bool:
    """Whether this kind's inserts must ride the rid-dedup cache.
    False for "bloom" — the bloom family's own classification
    (counting/scalable/presence) applies there."""
    kind = kind_of(config)
    if kind == "bloom":
        return False
    return spec(kind).replay_unsafe_insert


def supports_delete(config) -> bool:
    """Whether DeleteBatch is legal for this kind. False for "bloom" —
    the counting-filter check applies there."""
    kind = kind_of(config)
    if kind == "bloom":
        return False
    return spec(kind).supports_delete
