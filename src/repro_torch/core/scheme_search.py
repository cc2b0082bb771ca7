"""Beyond-paper: optimal area-layout search (the paper's §8 future work).

The paper's schemes were "obtained empirically". Here we formalize the
problem: pick ``n_areas = 2**prefix_bits`` areas, area ``a`` holding
``n_a <= 2**s_a`` symbols with code length ``prefix_bits + s_a``, covering
all 256 ranks, minimizing the expected code length under a descending
PMF, optionally with at most ``max_distinct_lengths`` distinct lengths
(4 == "quad").

Key structural facts (proved by rearrangement/exchange arguments):
  * With the PMF sorted descending, an optimal scheme uses non-decreasing
    symbol_bits across areas.
  * Given the multiset {s_a}, filling earlier (shorter) areas to capacity
    is optimal — except the total must be exactly 256, so the tail area
    absorbs the remainder.

Hence the search space is exactly the multisets of size ``n_areas`` over
symbol_bits 0..8 — C(16,8)=12870 for 3 prefix bits — which we enumerate
exhaustively and score vectorized. Globally optimal within the code
family, in milliseconds.
"""
from __future__ import annotations

import itertools
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.schemes import NUM_SYMBOLS, QLCScheme


def _fill_areas(sbits: Tuple[int, ...]) -> Optional[Tuple[int, ...]]:
    """Greedy max-fill-early area sizes for a non-decreasing s multiset.

    Returns None if the multiset cannot cover exactly 256 symbols with
    every area holding >= 1 symbol.
    """
    caps = [1 << s for s in sbits]
    n = len(sbits)
    total = sum(caps)
    if total < NUM_SYMBOLS:
        return None
    sizes = []
    remaining = NUM_SYMBOLS
    for i, c in enumerate(caps):
        tail_needed = (n - 1 - i)          # later areas need >= 1 each
        take = min(c, remaining - tail_needed)
        if take < 1:
            return None
        sizes.append(take)
        remaining -= take
    if remaining != 0:
        return None
    return tuple(sizes)


def enumerate_schemes(prefix_bits: int = 3,
                      max_distinct_lengths: Optional[int] = 4):
    """Yield every candidate (sizes, sbits) layout for the search."""
    n_areas = 1 << prefix_bits
    for sbits in itertools.combinations_with_replacement(range(9), n_areas):
        if max_distinct_lengths is not None:
            if len(set(sbits)) > max_distinct_lengths:
                continue
        sizes = _fill_areas(sbits)
        if sizes is None:
            continue
        yield sizes, sbits


def optimal_scheme(pmf_sorted: np.ndarray, prefix_bits: int = 3,
                   max_distinct_lengths: Optional[int] = 4
                   ) -> Tuple[QLCScheme, float]:
    """Exhaustively find the minimum-expected-bits scheme.

    Args:
      pmf_sorted: [256] descending-sorted PMF.
      prefix_bits: area-code width (3 => 8 areas, as in the paper).
      max_distinct_lengths: cap on distinct code lengths (4 == quad;
        None => unconstrained within the family).

    Returns:
      (scheme, expected_bits).
    """
    pmf_sorted = np.asarray(pmf_sorted, dtype=np.float64)
    if pmf_sorted.shape != (NUM_SYMBOLS,):
        raise ValueError("pmf must have shape (256,)")
    csum = np.concatenate([[0.0], np.cumsum(pmf_sorted)])

    best_cost = np.inf
    best: Optional[QLCScheme] = None
    for sizes, sbits in enumerate_schemes(prefix_bits, max_distinct_lengths):
        # cost = sum over areas of (prefix+s) * P(area's rank span)
        cost = 0.0
        r = 0
        for n, s in zip(sizes, sbits):
            cost += (prefix_bits + s) * (csum[r + n] - csum[r])
            r += n
        if cost < best_cost - 1e-15:
            best_cost = cost
            best = QLCScheme(areas=tuple(zip(sizes, sbits)),
                             prefix_bits=prefix_bits)
    assert best is not None
    return best, float(best_cost)


def search_report(pmf_sorted: np.ndarray) -> dict:
    """Compare paper tables vs searched optima. Returns a metrics dict."""
    from repro_torch.core.schemes import TABLE1, TABLE2  # local to avoid cycle
    out = {}
    out["table1_bits"] = TABLE1.expected_bits(pmf_sorted)
    out["table2_bits"] = TABLE2.expected_bits(pmf_sorted)
    quad, quad_bits = optimal_scheme(pmf_sorted, 3, 4)
    free, free_bits = optimal_scheme(pmf_sorted, 3, None)
    out["opt_quad_bits"] = quad_bits
    out["opt_quad_scheme"] = quad
    out["opt_free_bits"] = free_bits
    out["opt_free_scheme"] = free
    for k in ("table1", "table2", "opt_quad", "opt_free"):
        out[k + "_compressibility"] = (8.0 - out[k + "_bits"]) / 8.0
    return out
