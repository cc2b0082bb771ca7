"""Wire-format planning: the static slot size per chunk, from the
calibration histogram (mean code length plus a Hoeffding-bounded margin
so the per-chunk escape probability stays below ``target_escape_prob``).

The transport cost model of the reference's planner comes with the
collectives slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.core import entropy
from repro_torch.core.lut import CodecTables

MIN_CODE_BITS = 4
MAX_CODE_BITS = 11


@dataclasses.dataclass(frozen=True)
class CommPlan:
    """Static wire-format parameters for one tensor type."""
    chunk_symbols: int
    capacity_words: int          # QLC slot per chunk, 32-bit words
    pool_slots_per_1k: int       # escape-pool slots per 1024 chunks (min 1)
    expected_bits_per_symbol: float
    escape_prob_bound: float
    #: per-symbol slack between the expected code length and the slot,
    #: read by the drift policy as its recalibration threshold.
    drift_margin_bits: float = 0.5


def hoeffding_margin_bits(chunk_symbols: int, target_prob: float,
                          lo: float = MIN_CODE_BITS,
                          hi: float = MAX_CODE_BITS) -> float:
    """Per-symbol margin t with P(mean_len > mu + t) <= target_prob."""
    return (hi - lo) * math.sqrt(math.log(1.0 / target_prob)
                                 / (2.0 * chunk_symbols))


def plan_for_tables(tables: CodecTables, counts: np.ndarray,
                    chunk_symbols: int = 1024,
                    target_escape_prob: float = 1e-6,
                    capacity_factor: Optional[float] = None,
                    pool_slots_per_1k: int = 8,
                    drift_margin_bits: float = 0.5) -> CommPlan:
    """Build a plan from calibrated tables + the calibration histogram.

    ``capacity_factor`` (bytes-per-symbol / 1.0) overrides the Hoeffding
    sizing when given.
    """
    pmf = entropy.normalize_counts(counts)
    mu = float(np.dot(tables.enc_len.astype(np.float64), pmf))
    if capacity_factor is None:
        t = hoeffding_margin_bits(chunk_symbols, target_escape_prob)
        bits_per_sym = min(8.0, mu + t)
    else:
        bits_per_sym = 8.0 * capacity_factor
    cap_words = max(1, math.ceil(bits_per_sym * chunk_symbols / 32))
    return CommPlan(
        chunk_symbols=chunk_symbols,
        capacity_words=cap_words,
        pool_slots_per_1k=pool_slots_per_1k,
        expected_bits_per_symbol=mu,
        escape_prob_bound=target_escape_prob,
        drift_margin_bits=drift_margin_bits,
    )
