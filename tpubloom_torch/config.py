"""FilterConfig — the one config object for the whole framework.

A framework-free copy of ``tpubloom/config.py``: the port may not import
``tpubloom`` (its package ``__init__`` pulls in JAX), and a config must
mean the same filter in both packages, so ``to_dict``/``from_dict``
round-trip between them unchanged.

Parity: the reference's config surface is the constructor options hash
``:size, :error_rate, :key_name, :driver, :redis`` (+ ``:hash_engine``)
(SURVEY.md §5 "Config/flag system" [PK]; BASELINE.json pins the driver
boundary). We mirror it as a single frozen dataclass — no global flags —
and derive (m, k) from (capacity, error_rate) with the reference-identical
math in :mod:`tpubloom_torch.params` so configs are portable between the
Ruby front-end and this framework.

In the port ``insert_path``/``query_path`` select nothing: a CUDA filter
always runs the hand-written kernels (``tpubloom_torch.ops.sweep``). The
fields stay so that a config and its identity round-trip with
``tpubloom``.
"""

from __future__ import annotations

import dataclasses

from tpubloom_torch.params import optimal_m_k, round_up_pow2

#: Default seed for the hash family (any fixed u32; part of the filter's
#: identity — two filters interoperate only if (m, k, seed, hash spec) match).
DEFAULT_SEED = 0x9747B28C

#: Fields that define a filter's *semantic identity*: two configs agreeing on
#: these produce interchangeable bit arrays (positions are only portable
#: between identical hash configs; shards is identity-relevant because the
#: sharded payload is shard-major with per-shard-local positions).
IDENTITY_FIELDS = (
    "m", "k", "seed", "counting", "shards", "block_bits", "block_hash",
    "kind", "topk",
)

#: Filter kinds with their own storage layout + kernels.
#: "bloom" covers the whole pre-existing family (plain/counting/blocked/
#: sharded/scalable); the sketch kinds plug in via tpubloom.sketch.registry.
FILTER_KINDS = ("bloom", "cuckoo", "cms", "topk")


def identity_mismatch(a, b, fields=IDENTITY_FIELDS):
    """First identity field on which configs ``a`` and ``b`` disagree, or
    None if they match. ``a``/``b`` may be FilterConfig or plain dicts."""

    def get(c, f):
        if isinstance(c, dict):
            if f in c:
                return c[f]
            if f == "block_hash":
                # headers serialized before the field existed were written
                # by the AP in-block spec (the only one that existed then),
                # NOT the current default — see FilterConfig.from_dict
                return "ap" if c.get("block_bits", 0) else ""
            # configs serialized before a field existed (e.g. block_bits in
            # old checkpoint headers) compare as the field's default
            default = FilterConfig.__dataclass_fields__[f].default
            if default is dataclasses.MISSING:
                raise KeyError(f)
            return default
        return getattr(c, f)

    for field in fields:
        if get(a, field) != get(b, field):
            return field
    return None


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    """Identity + layout of one bloom filter.

    Attributes:
      m: number of bits in the filter. Powers of two use the 64-bit position
        path (supports m up to 2^36); non-powers-of-two must be < 2^31 and
        use the 32-bit path. See ``tpubloom_torch.ops.hashing`` for the exact spec.
      k: number of hash positions per key.
      seed: u32 seed for the hash family.
      key_len: maximum key length in bytes; keys are zero-padded to this
        length on device. Must be a multiple of 4.
      key_policy: what to do with keys longer than ``key_len``:
        ``"error"`` (default) or ``"digest"`` (replace by a 16-byte BLAKE2b
        digest on the host before packing).
      counting: counting-filter variant (4-bit counters, supports delete).
      shards: number of device shards for the sharded filter array
        (1 = single device). m must be divisible by shards*32.
      key_name: checkpoint namespace (mirrors the reference's Redis key name).
      checkpoint_every: insert count between automatic async checkpoints
        (0 = never).
      block_bits: 0 = flat layout (the reference-compatible position spec);
        a power of two in [128, 4096] selects the *blocked* layout, where all
        k bits of a key land in one block_bits-sized block (cache-line bloom
        filter, Putze et al. 2007). Blocked trades a slightly higher FPR at
        high fill for ~k× fewer random HBM accesses — the throughput layout.
        Positions follow the blocked spec in ``tpubloom_torch.ops.blocked``;
        blocked filters are NOT bit-compatible with flat ones.
      insert_path: blocked-insert implementation: ``"auto"`` (default)
        picks the Pallas partition-sweep kernel on TPU when the shape
        qualifies and the sorted-scatter XLA path otherwise; ``"sweep"``
        / ``"scatter"`` force one. Not part of the filter's identity —
        both paths produce bit-identical arrays.
      query_path: blocked-membership implementation: ``"auto"`` (default)
        picks the read-only Pallas query sweep on TPU when the shape
        qualifies (``tpubloom.ops.sweep.choose_fat_query_params``) and
        the row-gather XLA path otherwise; ``"sweep"`` / ``"gather"``
        force one. Not part of the filter's identity — both paths
        answer bit-identical verdicts (reads never change the array).
      block_hash: in-block position derivation for the blocked layout
        (part of the filter's identity). ``"chunk"`` (the default when it
        fits) slices each position from disjoint bit ranges of the
        (h_b, g_a, g_b) 96-bit hash pool — positions are i.i.d. uniform.
        ``"ap"`` is the legacy arithmetic-progression walk
        ``(g_a + i*(g_b|1)) mod block_bits``, whose position sets form a
        tiny 2-parameter family: two same-block keys colliding in
        (g_a mod b, g_b mod b) share ALL positions, which puts a measured
        FPR floor of ~4*load/block_bits^2 under every blocked filter
        (see params.blocked_fpr). ``"auto"`` resolves to "chunk" when
        k*log2(in-block positions) <= 96, else "ap". Flat layouts carry
        ``""``. Checkpoint headers written before this field existed
        restore as "ap" (the spec they were built with).
    """

    m: int
    k: int
    seed: int = DEFAULT_SEED
    key_len: int = 16
    key_policy: str = "error"
    counting: bool = False
    shards: int = 1
    key_name: str = "tpubloom"
    checkpoint_every: int = 0
    block_bits: int = 0
    insert_path: str = "auto"
    query_path: str = "auto"
    block_hash: str = "auto"
    #: Filter kind: "bloom" (the whole pre-existing family),
    #: "cuckoo" (m = fingerprint slots, k = candidate buckets per key),
    #: "cms" (m = row width in counters, k = rows), or "topk" (a CMS that
    #: additionally maintains a host-side top-`topk` heavy-hitter heap).
    #: Part of the filter's identity — storage layouts are incompatible.
    kind: str = "bloom"
    #: Heavy-hitter heap size; required > 0 for kind="topk", 0 otherwise.
    topk: int = 0

    def __post_init__(self) -> None:
        if self.kind not in FILTER_KINDS:
            raise ValueError(f"kind must be one of {FILTER_KINDS}, got {self.kind!r}")
        if self.kind != "bloom":
            # sketch kinds own their storage layout; the bloom-family
            # layout options are meaningless (and unimplemented) for them
            if self.counting or self.block_bits or self.shards != 1:
                raise ValueError(
                    f"kind={self.kind!r} does not combine with counting/"
                    "block_bits/shards — those are bloom-family layouts"
                )
            if self.kind == "cuckoo" and not (self.m & (self.m - 1)) == 0:
                raise ValueError(
                    f"cuckoo filters need a power-of-two slot count m, got {self.m}"
                )
        if self.kind == "topk":
            if self.topk <= 0:
                raise ValueError("kind='topk' requires topk > 0")
        elif self.topk:
            raise ValueError(f"topk is only meaningful for kind='topk', got {self.topk}")
        if self.m <= 0:
            raise ValueError(f"m must be positive, got {self.m}")
        if not self.m_is_pow2 and self.m >= (1 << 31):
            raise ValueError(
                f"non-power-of-two m must be < 2^31 (32-bit position path), got {self.m}"
            )
        if self.m_is_pow2 and self.m > (1 << 36):
            # word indices are int32: pos >> 5 must stay < 2^31 (see
            # hashing.split_word_bit), so 2^36 bits is the single-array cap.
            raise ValueError(f"m must be <= 2^36, got {self.m}")
        if not (1 <= self.k <= 64):
            raise ValueError(f"k must be in [1, 64], got {self.k}")
        if self.key_len <= 0 or self.key_len % 4 != 0:
            raise ValueError(f"key_len must be a positive multiple of 4, got {self.key_len}")
        if self.key_policy not in ("error", "digest"):
            raise ValueError(f"key_policy must be 'error' or 'digest', got {self.key_policy}")
        if not (0 <= self.seed < (1 << 32)):
            raise ValueError(f"seed must be a u32, got {self.seed}")
        if self.shards < 1:
            raise ValueError(f"shards must be >= 1, got {self.shards}")
        if self.m % (self.shards * 32) != 0:
            raise ValueError(
                f"m ({self.m}) must be divisible by shards*32 ({self.shards * 32})"
            )
        if self.counting and self.m % 8 != 0:
            raise ValueError(f"counting filters need m divisible by 8, got {self.m}")
        if self.insert_path not in ("auto", "sweep", "scatter"):
            raise ValueError(
                f"insert_path must be auto/sweep/scatter, got {self.insert_path}"
            )
        if self.query_path not in ("auto", "sweep", "gather"):
            raise ValueError(
                f"query_path must be auto/sweep/gather, got {self.query_path}"
            )
        if self.block_bits:
            bb = self.block_bits
            if bb & (bb - 1) or not (128 <= bb <= 4096):
                raise ValueError(
                    f"block_bits must be a power of two in [128, 4096], got {bb}"
                )
            if not self.m_is_pow2:
                raise ValueError("blocked layout requires power-of-two m")
            if self.counting:
                # blocked counting: a block_bits-bit block holds
                # block_bits/4 counters; m counts COUNTERS (as in the
                # flat counting layout) and must be < 2^31 (positions
                # flatten to blk * counters_per_block + c for the flat
                # counting kernels / oracle)
                if self.m < bb // 4:
                    raise ValueError(
                        f"m ({self.m}) must be >= counters per block ({bb // 4})"
                    )
                if self.m % (self.shards * (bb // 4)) != 0:
                    raise ValueError(
                        f"m ({self.m}) must be divisible by "
                        f"shards*counters_per_block ({self.shards * (bb // 4)})"
                    )
            else:
                if self.m < bb:
                    raise ValueError(
                        f"m ({self.m}) must be >= block_bits ({bb})"
                    )
                if self.m % (self.shards * bb) != 0:
                    raise ValueError(
                        f"m ({self.m}) must be divisible by shards*block_bits "
                        f"({self.shards * bb})"
                    )
        # resolve/validate the in-block hash spec (identity field)
        if self.block_bits:
            domain = self.block_bits // 4 if self.counting else self.block_bits
            nb = (domain - 1).bit_length()
            fits = self.k * nb <= 96  # the (h_b, g_a, g_b) pool
            bh = self.block_hash
            if bh == "auto":
                bh = "chunk" if fits else "ap"
                object.__setattr__(self, "block_hash", bh)
            if self.block_hash not in ("chunk", "ap"):
                raise ValueError(
                    f"block_hash must be auto/chunk/ap, got {self.block_hash!r}"
                )
            if self.block_hash == "chunk" and not fits:
                raise ValueError(
                    f"block_hash='chunk' needs k*log2(in-block positions) <= 96 "
                    f"(k={self.k}, {nb} bits/position) — use 'ap'"
                )
        else:
            if self.block_hash not in ("", "auto"):
                raise ValueError(
                    "block_hash is only meaningful for blocked layouts "
                    f"(block_bits=0), got {self.block_hash!r}"
                )
            object.__setattr__(self, "block_hash", "")

    # -- derived layout ----------------------------------------------------

    @property
    def m_is_pow2(self) -> bool:
        return (self.m & (self.m - 1)) == 0

    @property
    def log2_m(self) -> int:
        if not self.m_is_pow2:
            raise ValueError("log2_m only defined for power-of-two m")
        return self.m.bit_length() - 1

    @property
    def n_words(self) -> int:
        """uint32 words in the packed bit array (plain filter)."""
        return (self.m + 31) // 32

    @property
    def n_counter_words(self) -> int:
        """uint32 words in the packed 4-bit counter array (counting filter)."""
        return (self.m + 7) // 8

    @property
    def counters_per_block(self) -> int:
        """4-bit counters per block (blocked counting layout)."""
        if not self.block_bits or not self.counting:
            raise ValueError(
                "counters_per_block is only defined for blocked counting layouts"
            )
        return self.block_bits // 4

    @property
    def n_blocks(self) -> int:
        """Number of blocks (blocked layout only). For blocked counting
        filters m counts counters, so a block covers block_bits/4 of them."""
        if not self.block_bits:
            raise ValueError("n_blocks is only defined for blocked layouts")
        if self.counting:
            return self.m // self.counters_per_block
        return self.m // self.block_bits

    @property
    def n_blocks_per_shard(self) -> int:
        return self.n_blocks // self.shards

    @property
    def words_per_block(self) -> int:
        if not self.block_bits:
            raise ValueError("words_per_block is only defined for blocked layouts")
        return self.block_bits // 32

    @property
    def n_words_per_shard(self) -> int:
        return self.n_words // self.shards

    @property
    def m_per_shard(self) -> int:
        return self.m // self.shards

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_capacity(
        cls,
        capacity: int,
        error_rate: float,
        *,
        pow2_m: bool = True,
        **kwargs,
    ) -> "FilterConfig":
        """Reference-style sizing: give capacity + error rate, get a filter.

        ``pow2_m=True`` (default) rounds m up to a power of two — strictly
        more bits, so the configured error rate stays an upper bound — which
        enables the fast device path (mask instead of mod) and arbitrary m.
        """
        m, k = optimal_m_k(capacity, error_rate)
        if pow2_m:
            m = round_up_pow2(m)
        else:
            m = ((m + 31) // 32) * 32  # keep the packed array whole-word
        return cls(m=m, k=k, **kwargs)

    def replace(self, **kwargs) -> "FilterConfig":
        if "block_bits" in kwargs and "block_hash" not in kwargs:
            # crossing the flat<->blocked boundary invalidates the resolved
            # in-block spec ("" <-> chunk/ap); re-resolve from "auto"
            if bool(kwargs["block_bits"]) != bool(self.block_bits):
                kwargs["block_hash"] = "auto"
        return dataclasses.replace(self, **kwargs)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FilterConfig":
        if d.get("block_bits") and "block_hash" not in d:
            # serialized before the field existed == built with the AP spec
            d = dict(d, block_hash="ap")
        return cls(**d)
