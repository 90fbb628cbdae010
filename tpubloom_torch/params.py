"""Bloom-filter parameter math: (capacity, error_rate) -> (m, k).

Parity: the reference front-end computes optimal ``m`` (bits) and ``k`` (hash
count) from desired capacity + error rate with the textbook formulas
``m = -n·ln(p)/ln(2)²`` and ``k = (m/n)·ln(2)`` (SURVEY.md §2.1,
"Parameter math", expected in lib/redis-bloomfilter.rb [PK]; pinned by
BASELINE.json north_star which fixes m=2^32, k=7 at ≤1% FPR).

Kept dependency-free (pure ``math``) so the Ruby client, the CPU oracle and
the device kernels can all share one source of truth for sizing. This is
a copy of ``tpubloom/params.py``: the port imports nothing of
``tpubloom``.
"""

from __future__ import annotations

import math


def optimal_m_k(capacity: int, error_rate: float) -> tuple[int, int]:
    """Return ``(m, k)`` — bit-array size and hash count — for a filter that
    holds ``capacity`` keys at false-positive probability ``error_rate``.

    ``m = ceil(-n·ln(p) / ln(2)²)``, ``k = max(1, round((m/n)·ln(2)))``.
    """
    if capacity <= 0:
        raise ValueError(f"capacity must be positive, got {capacity}")
    if not (0.0 < error_rate < 1.0):
        raise ValueError(f"error_rate must be in (0, 1), got {error_rate}")
    n = float(capacity)
    p = float(error_rate)
    m = math.ceil(-n * math.log(p) / (math.log(2.0) ** 2))
    k = max(1, round((m / n) * math.log(2.0)))
    return m, k


def theoretical_fpr(m: int, k: int, n: int) -> float:
    """Expected false-positive rate after inserting ``n`` keys:
    ``(1 - e^(-k·n/m))^k``."""
    if n == 0:
        return 0.0
    return (1.0 - math.exp(-k * n / m)) ** k


def _distinct_distribution(k: int, b: int) -> list[float]:
    """P(D = d): distribution of the number of DISTINCT values among k
    i.i.d. uniforms over b bins — ``P(D=d) = S2(k,d) · b!/(b-d)! / b^k``
    with S2 the Stirling numbers of the second kind."""
    # S2 via the triangle recurrence
    s2 = [[0.0] * (k + 1) for _ in range(k + 1)]
    s2[0][0] = 1.0
    for i in range(1, k + 1):
        for d in range(1, i + 1):
            s2[i][d] = s2[i - 1][d - 1] + d * s2[i - 1][d]
    out = [0.0] * (k + 1)
    for d in range(1, k + 1):
        falling = 1.0
        for j in range(d):
            falling *= (b - j) / b
        out[d] = s2[k][d] * falling * b ** (d - k)
    return out


def blocked_fpr(
    n: int,
    *,
    m: int,
    k: int,
    block_bits: int,
    block_hash: str = "chunk",
    tail_sigmas: float = 12.0,
) -> float:
    """Expected false-positive rate of the BLOCKED layout after ``n`` keys.

    The blocked spec (tpubloom_torch.ops.blocked) confines all k bits of a key
    to one ``block_bits``-bit block, so per-block load is
    ``L ~ Poisson(lambda = n / n_blocks)`` and the filter is a Poisson
    mixture of tiny b-bit bloom filters:

        FPR = E_L[ f(L) ],   b = block_bits.

    For ``block_hash="chunk"`` positions are i.i.d. uniform, so a block
    bit survives one insert with probability (1 - 1/b)^k exactly, and a
    query testing D distinct positions (D per the Stirling distribution
    of k uniforms) hits with

        f(L) = E_D[ (1 - (1 - 1/b)^(k·L))^D ].

    For ``block_hash="ap"`` each key's positions are k DISTINCT residues
    of an odd-stride walk, giving f(L) = (1 - (1 - k/b)^L)^k — PLUS the
    AP family floor: the position set is determined by the ~2·log2(b)-bit
    pair (g_a mod b, g_b mod b), and a query whose pair matches an insert
    in its block (same AP, or the reversed AP) shares every position:

        floor ≈ lambda · 4 / b²

    (two set-equal (start, stride) pairs out of b·(b/2); partial-AP
    overlap adds ~25% more in measurement, so this is a lower bound —
    measured 1.6e-4 total vs 1.3e-4 floor at m=2^32, b=512, lambda=8.6,
    where the mixture alone says 1e-6). This floor is linear in load and
    does NOT vanish at low fill; it is why "chunk" is the default spec.

    Jensen's inequality makes the mixture >= the flat ``theoretical_fpr``
    at equal fill (block loads are skewed); the expected OVERALL fill is
    identical (E[1 - (1-k/b)^L] = 1 - e^(-k n / m)). The Poisson sum is
    truncated at ``lambda + tail_sigmas * sqrt(lambda)`` which bounds the
    truncated mass far below the returned value's precision.
    """
    if n == 0:
        return 0.0
    b = block_bits
    if b <= 0 or b & (b - 1) or b < k:
        raise ValueError(f"block_bits must be a power of two >= k, got {b}")
    n_blocks = m // b
    lam = n / n_blocks
    lmax = int(lam + tail_sigmas * math.sqrt(lam) + 16)
    if block_hash == "chunk":
        pd = _distinct_distribution(k, b)
        unset_per_insert = (1.0 - 1.0 / b) ** k

        def f(L: int) -> float:
            q = 1.0 - unset_per_insert**L
            return sum(pd[d] * q**d for d in range(1, k + 1))

    elif block_hash == "ap":
        per_key_unset = 1.0 - k / b

        def f(L: int) -> float:
            q = 1.0 - per_key_unset**L
            return q**k

    else:
        raise ValueError(f"block_hash must be 'chunk' or 'ap', got {block_hash!r}")
    # Poisson pmf iteratively (avoids factorial overflow at large lambda)
    log_p = -lam  # log pmf at L=0
    total = 0.0
    for L in range(lmax + 1):
        if L > 0:
            log_p += math.log(lam) - math.log(L)
        total += math.exp(log_p) * f(L)
    if block_hash == "ap":
        total += lam * 4.0 / (b * b)  # family floor (see docstring)
    return total


def round_up_pow2(x: int) -> int:
    """Smallest power of two >= x (device-friendly m; pow2 m enables the
    64-bit position path and turns mod into a bit mask)."""
    if x <= 1:
        return 1
    return 1 << (x - 1).bit_length()
