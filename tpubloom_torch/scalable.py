"""Scalable (layered) bloom filter on the port's filters: it grows when
full, and its false-positive rate stays bounded.

The counterpart of ``tpubloom/scalable.py``, with the same growth policy,
layer geometry, seeds and snapshot dicts, so a layer stack and its
``scalable_stack`` checkpoint are interchangeable between the packages.
The design is the scalable bloom filter of Almeida, Baquero, Preguiça and
Hutchison (2007):

* a stack of plain bloom-filter layers; layer ``i`` holds ``capacity ·
  growth^i`` keys at error rate ``error_rate · tightening^i``
  (:func:`layer_config`);
* inserts go to the newest layer; when it reaches its capacity a larger,
  tighter layer is pushed, and a batch that straddles the boundary is
  split there;
* membership is the OR over the layers, so the compound false-positive
  rate is bounded by ``sum_i p·r^i < error_rate / (1 - tightening)``.

The policy is written once (``_ScalableCore``) and shared by two
stacks. In :class:`ScalableBloomFilter` each layer is a port
:class:`~tpubloom_torch.filter.BlockedBloomFilter` (when the base config
sets ``block_bits``) or :class:`~tpubloom_torch.filter.BloomFilter`, on
the card unless the caller passes ``device``; each runs its own kernels
(:mod:`tpubloom_torch.ops.sweep`). The layers stay separate tensors: they
have different sizes and appear at data-dependent times, and their count
grows only logarithmically in the keys. In :class:`CPUScalableBloomFilter`
each layer is a CPU driver (:mod:`tpubloom_torch.cpu_ref`), as in
``tpubloom``'s class of that name. Each layer's seed is derived from the
base seed, so the layers' memberships are independent.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from tpubloom_torch.config import FilterConfig
from tpubloom_torch.cpu_ref import CPUBlockedBloomFilter, CPUBloomFilter
from tpubloom_torch.filter import BlockedBloomFilter, BloomFilter, resolve_device
from tpubloom_torch.params import optimal_m_k, round_up_pow2

#: Seed derivation for layer i (any fixed odd constant; part of the filter's
#: identity like FilterConfig.seed itself): seed_i = (seed + i·LAYER_SEED_STRIDE) mod 2^32.
LAYER_SEED_STRIDE = 0x61C88647  # 2^32 / golden ratio, odd


def layer_config(
    base: FilterConfig,
    capacity: int,
    error_rate: float,
    layer: int,
    *,
    growth: int = 2,
    tightening: float = 0.5,
) -> tuple[FilterConfig, int]:
    """Config and capacity of layer ``layer`` under the scalable policy:
    ``(config, layer_capacity)``, deterministic in its inputs (the same as
    ``tpubloom.scalable.layer_config``)."""
    cap_i = capacity * (growth**layer)
    p_i = error_rate * (tightening**layer)
    m, k = optimal_m_k(cap_i, p_i)
    m = round_up_pow2(m)
    if base.block_bits:
        # a blocked layer needs at least one whole block (more bits only
        # tighten the layer under its error budget)
        m = max(m, base.block_bits)
    seed_i = (base.seed + layer * LAYER_SEED_STRIDE) % (1 << 32)
    return base.replace(m=m, k=k, seed=seed_i, shards=1), cap_i


class _ScalableCore:
    """The growth policy over a stack of layers made by ``make_layer``
    (a config -> a filter): shared by the card's and the CPU's stacks.

    ``config`` is the base (template) config: its key width, key policy,
    layout (``block_bits``: blocked layers; 0: flat layers), seed and
    ``key_name``; each layer derives its own ``m``, ``k`` and seed.
    Counting configs are refused: a layered delete is ill-defined (which
    layer holds the key?).
    """

    def __init__(
        self,
        make_layer: Callable[[FilterConfig], object],
        config: FilterConfig,
        capacity: int,
        error_rate: float,
        *,
        growth: int = 2,
        tightening: float = 0.5,
    ):
        if config.counting:
            raise ValueError(
                "scalable filters do not support counting configs — use "
                "CountingBloomFilter / BlockedCountingBloomFilter"
            )
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        if not (0.0 < error_rate < 1.0):
            raise ValueError(f"error_rate must be in (0, 1), got {error_rate}")
        if growth < 2:
            raise ValueError(f"growth must be >= 2, got {growth}")
        if not (0.0 < tightening < 1.0):
            raise ValueError(f"tightening must be in (0, 1), got {tightening}")
        self._make_layer = make_layer
        self.base_config = config
        self.capacity = capacity
        self.error_rate = error_rate
        self.growth = growth
        self.tightening = tightening
        self.layers: list = []
        self._layer_caps: list[int] = []
        self._layer_counts: list[int] = []
        self.n_inserted = 0
        self._push_layer()

    # -- growth -------------------------------------------------------------

    def _push_layer(self) -> None:
        cfg, cap = layer_config(
            self.base_config, self.capacity, self.error_rate, len(self.layers),
            growth=self.growth, tightening=self.tightening,
        )
        self.layers.append(self._make_layer(cfg))
        self._layer_caps.append(cap)
        self._layer_counts.append(0)

    def _room(self) -> int:
        return self._layer_caps[-1] - self._layer_counts[-1]

    # -- batch API -----------------------------------------------------------

    def insert_batch(self, keys: Sequence[bytes | str]) -> None:
        """Insert, splitting at a growth boundary so that every layer stays
        within its design capacity (the FPR bound depends on it)."""
        keys = list(keys)
        start = 0
        while start < len(keys):
            room = self._room()
            if room <= 0:
                self._push_layer()
                continue
            chunk = keys[start : start + room]
            self.layers[-1].insert_batch(chunk)
            self._layer_counts[-1] += len(chunk)
            self.n_inserted += len(chunk)
            start += len(chunk)

    def include_batch(self, keys: Sequence[bytes | str]) -> np.ndarray:
        """Membership, the OR over the layers."""
        out = np.zeros(len(keys), dtype=bool)
        for layer in self.layers:
            out |= np.asarray(layer.include_batch(keys))
        return out

    def insert(self, key: bytes | str) -> None:
        self.insert_batch([key])

    def include(self, key: bytes | str) -> bool:
        return bool(self.include_batch([key])[0])

    __contains__ = include

    def clear(self) -> None:
        self.layers = []
        self._layer_caps = []
        self._layer_counts = []
        self.n_inserted = 0
        self._push_layer()

    # -- persistence (tpubloom_torch.checkpoint frames the stack) -------------

    def snapshot_meta(self) -> dict:
        """Everything but the payload needed to rebuild the stack: the
        growth policy (it fixes every layer's geometry), each layer's
        config and count. Taken with the words in stream order."""
        return {
            "capacity": self.capacity,
            "error_rate": self.error_rate,
            "growth": self.growth,
            "tightening": self.tightening,
            "layer_counts": list(self._layer_counts),
            "layer_configs": [layer.config.to_dict() for layer in self.layers],
        }

    def _load_layers(self, meta: dict, layer_words) -> None:
        """Replace the stack with a restored one: one ``uint32`` array a
        layer, in payload order. Each layer's geometry is derived again
        from the policy and checked against the stored config, so a
        checkpoint of another policy or base config is refused."""
        self.layers = []
        self._layer_caps = []
        self._layer_counts = []
        for i, (cfg_dict, count) in enumerate(zip(meta["layer_configs"], meta["layer_counts"])):
            self._push_layer()
            got = self.layers[i].config.to_dict()
            # through from_dict, so that headers written before block_hash
            # existed compare as the "ap" spec they were built with
            cfg_dict = FilterConfig.from_dict(dict(cfg_dict)).to_dict()
            if got != cfg_dict:
                raise ValueError(
                    f"layer {i} config mismatch on restore: policy derives "
                    f"{got}, checkpoint holds {cfg_dict}"
                )
            self.layers[i]._set_words(layer_words[i])
            self._layer_counts[i] = int(count)
        self.n_inserted = sum(self._layer_counts)

    # -- observability --------------------------------------------------------

    @property
    def config(self) -> FilterConfig:
        """The base config (key name, layout, seed; not a layer's m / k)."""
        return self.base_config

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    def compound_fpr_bound(self) -> float:
        """Design bound on the compound FPR: the sum of the layers' rates."""
        return sum(self.error_rate * self.tightening**i for i in range(len(self.layers)))

    def stats(self) -> dict:
        st = {
            "n_layers": self.n_layers,
            "n_inserted": self.n_inserted,
            "capacity_current_layer": self._layer_caps[-1],
            "count_current_layer": self._layer_counts[-1],
            "total_bits": sum(layer.config.m for layer in self.layers),
            "compound_fpr_bound": self.compound_fpr_bound(),
        }
        if all(hasattr(layer, "estimated_fpr") for layer in self.layers):
            # observed compound FPR (a false positive when ANY layer has
            # one) against the design bound: the scalable filter's drift
            # gauge (a CPU driver's blocked layer has no estimate)
            miss = 1.0
            for layer in self.layers:
                miss *= 1.0 - layer.estimated_fpr()
            st["estimated_fpr"] = 1.0 - miss
            st["fpr_drift"] = st["estimated_fpr"] - st["compound_fpr_bound"]
            st["predicted_fpr"] = st["compound_fpr_bound"]
        return st


class ScalableBloomFilter(_ScalableCore):
    """A stack of bloom-filter layers on one device that grows when full.

    The default base config is the flat ``FilterConfig(m=64, k=1)``, as
    in ``tpubloom``; ``device`` as for the port's filters (the card
    unless named).
    """

    def __init__(
        self,
        capacity: int,
        error_rate: float,
        *,
        config: FilterConfig | None = None,
        growth: int = 2,
        tightening: float = 0.5,
        device=None,
    ):
        base = config if config is not None else FilterConfig(m=64, k=1)
        self.device = dev = resolve_device(device)
        layer_cls = BlockedBloomFilter if base.block_bits else BloomFilter
        # the layer maker holds the device, not self: no reference cycle, so
        # a dropped stack frees its tensors at once (tenant eviction)
        super().__init__(
            lambda cfg: layer_cls(cfg, dev), base, capacity, error_rate,
            growth=growth, tightening=tightening,
        )

    def include_batch(self, keys: Sequence[bytes | str]) -> np.ndarray:
        """Membership, the OR over the layers: the keys are packed and
        staged once, each layer's verdicts are ORed on the device, and one
        copy comes back (the layers share key width and key policy)."""
        first = self.layers[0]
        keys_u8, lengths, B = first._pack_padded(list(keys))
        d_keys, d_lengths = first._stage_batch(keys_u8, lengths)
        hits = torch.zeros((d_keys.shape[0],), dtype=torch.bool, device=self.device)
        for layer in self.layers:
            hits |= layer.include_arrays(d_keys, d_lengths)
        return hits.cpu().numpy()[:B]

    def _state_tensors(self) -> list[torch.Tensor]:
        """Every layer's words, in the order of the checkpoint payload."""
        return [t for layer in self.layers for t in layer._state_tensors()]


class CPUScalableBloomFilter(_ScalableCore):
    """The same policy over CPU-driver layers (:mod:`tpubloom_torch.cpu_ref`):
    :class:`~tpubloom_torch.cpu_ref.CPUBlockedBloomFilter` when the base
    config sets ``block_bits``, else
    :class:`~tpubloom_torch.cpu_ref.CPUBloomFilter`; ``use_native`` as
    theirs."""

    def __init__(
        self,
        capacity: int,
        error_rate: float,
        *,
        config: FilterConfig | None = None,
        growth: int = 2,
        tightening: float = 0.5,
        use_native: bool | None = None,
    ):
        base = config if config is not None else FilterConfig(m=64, k=1)
        layer_cls = CPUBlockedBloomFilter if base.block_bits else CPUBloomFilter
        super().__init__(
            lambda cfg: layer_cls(cfg, use_native=use_native), base, capacity, error_rate,
            growth=growth, tightening=tightening,
        )
