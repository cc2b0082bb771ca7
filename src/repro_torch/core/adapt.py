"""Scheme adaptation (paper §6) + calibration plumbing.

The paper shows that one fixed scheme (Table 1) loses badly on a
distribution with a dominant symbol (FFN2 activations post-nonlinearity):
16.7% vs the adapted Table 2's 19.0%. Deployment keeps one LUT per
tensor type, calibrated apriori (paper §7). This module picks or builds
the scheme for a measured histogram.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import entropy, lut, scheme_search
from repro_torch.core.schemes import PAPER_SCHEMES, QLCScheme, TABLE1, TABLE2


@dataclasses.dataclass(frozen=True)
class AdaptResult:
    scheme: QLCScheme
    scheme_name: str
    expected_bits: float
    compressibility: float
    entropy_bits: float
    ideal_compressibility: float


def select_scheme(counts: np.ndarray, allow_search: bool = False,
                  prefix_bits: int = 3) -> AdaptResult:
    """Pick the best scheme for a histogram.

    With ``allow_search=False`` chooses between the paper's Table 1 and
    Table 2 (what the paper does manually). With ``allow_search=True``
    additionally runs the beyond-paper exhaustive quad-constrained search.
    """
    pmf_sorted, _ = entropy.sort_pmf_desc(counts)
    h = entropy.shannon_entropy(pmf_sorted)

    candidates = {name: s for name, s in PAPER_SCHEMES.items()}
    if allow_search:
        opt, _ = scheme_search.optimal_scheme(pmf_sorted, prefix_bits, 4)
        candidates["searched"] = opt

    best_name, best_scheme, best_bits = None, None, np.inf
    for name, scheme in candidates.items():
        bits = scheme.expected_bits(pmf_sorted)
        if bits < best_bits:
            best_name, best_scheme, best_bits = name, scheme, bits

    return AdaptResult(
        scheme=best_scheme,
        scheme_name=best_name,
        expected_bits=float(best_bits),
        compressibility=(8.0 - best_bits) / 8.0,
        entropy_bits=float(h),
        ideal_compressibility=(8.0 - h) / 8.0,
    )


def calibrate_tables(counts: np.ndarray, scheme: Optional[QLCScheme] = None,
                     allow_search: bool = False) -> lut.CodecTables:
    """Histogram -> ready-to-use codec tables (one per tensor type)."""
    if scheme is None:
        scheme = select_scheme(counts, allow_search=allow_search).scheme
    return lut.build_tables(counts, scheme)


def has_dominant_symbol(counts: np.ndarray, threshold: float = 0.15) -> bool:
    """Heuristic from §6: a zero-spike distribution wants Table 2."""
    pmf = entropy.normalize_counts(counts)
    return bool(pmf.max() >= threshold)


def default_scheme_for(counts: np.ndarray) -> QLCScheme:
    """Cheap static rule mirroring the paper's manual choice."""
    return TABLE2 if has_dominant_symbol(counts) else TABLE1
