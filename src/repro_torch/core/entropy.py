"""Entropy / compressibility metrics (paper §4)."""
from __future__ import annotations

import numpy as np

NUM_SYMBOLS = 256


def normalize_counts(counts: np.ndarray) -> np.ndarray:
    counts = np.asarray(counts, dtype=np.float64)
    total = counts.sum()
    if total <= 0:
        raise ValueError("counts must sum to a positive value")
    return counts / total


def shannon_entropy(pmf: np.ndarray) -> float:
    """Shannon entropy in bits. Zero-probability symbols contribute 0."""
    pmf = np.asarray(pmf, dtype=np.float64)
    nz = pmf[pmf > 0]
    return float(-(nz * np.log2(nz)).sum())


def ideal_compressibility(pmf: np.ndarray, symbol_bits: int = 8) -> float:
    """Paper's ideal bound: (b - H) / b."""
    return (symbol_bits - shannon_entropy(pmf)) / symbol_bits


def avg_code_length(lengths: np.ndarray, pmf: np.ndarray) -> float:
    """Expected code length of a code with per-symbol ``lengths`` under pmf.

    ``lengths`` and ``pmf`` must be aligned (same symbol order).
    """
    lengths = np.asarray(lengths, dtype=np.float64)
    pmf = np.asarray(pmf, dtype=np.float64)
    return float(np.dot(lengths, pmf))


def compressibility(lengths: np.ndarray, pmf: np.ndarray,
                    symbol_bits: int = 8) -> float:
    """Paper's achieved metric: (b - avg_bits) / b."""
    return (symbol_bits - avg_code_length(lengths, pmf)) / symbol_bits


def sort_pmf_desc(counts: np.ndarray):
    """Sort counts descending (stable; ties broken by symbol value).

    Returns (pmf_sorted, order) where ``order[rank] = symbol``.
    """
    counts = np.asarray(counts)
    if counts.shape != (NUM_SYMBOLS,):
        raise ValueError("counts must have shape (256,)")
    if counts.astype(np.float64).sum() <= 0:
        # Degenerate (e.g. uncalibrated) histogram: uniform / identity rank.
        counts = np.ones(NUM_SYMBOLS, dtype=np.float64)
    # argsort ascending on (-count, symbol) => stable deterministic ranking.
    order = np.lexsort((np.arange(NUM_SYMBOLS), -counts.astype(np.float64)))
    pmf = normalize_counts(counts)[order]
    return pmf, order.astype(np.int32)
