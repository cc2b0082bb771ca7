"""Recalibration off the hot path, and registration of the revision.

From a drifted binding's accumulated histogram the codec is rebuilt as
the first calibration built it: ``calibrate_tables`` (with
``allow_search`` the exhaustive quad-constrained search), the iid
``plan_for_tables`` sizing, then ``empirical_plan`` on a synthetic
stream drawn from the histogram; the result is registered under a new
scheme-id (``CodecRegistry.register_revision``).

Geometry: the revision keeps the old plan's ``chunk_symbols`` (the
ZeRO-1 flat geometry and the KV page layout are built on the chunk
grid); ``capacity_words`` and the escape pool may change, so a consumer
that baked the plan in rebuilds (``TrainingAdapter`` rebuilds the train
step).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.comm.calibrate import empirical_plan
from repro_torch.comm.planner import plan_for_tables
from repro_torch.core import adapt


class Recalibrator:
    """Rebuilds codec and plan from measured traffic and registers them.

    ``allow_search=True`` runs the exhaustive scheme search (a few ms at
    3 prefix bits); False keeps to the paper's Table 1 / Table 2 choice.
    """

    def __init__(self, registry, *, allow_search: bool = True,
                 target_escape_prob: float = 1e-6,
                 max_pool_slots_per_1k: Optional[int] = 64,
                 sample_symbols: int = 1 << 16, seed: int = 0):
        self.registry = registry
        self.allow_search = bool(allow_search)
        self.target_escape_prob = float(target_escape_prob)
        self.max_pool_slots_per_1k = max_pool_slots_per_1k
        self.sample_symbols = int(sample_symbols)
        self.seed = int(seed)

    def _synthetic_stream(self, counts: np.ndarray) -> np.ndarray:
        """A deterministic iid symbol stream with the histogram's pmf,
        the empirical sizing's input (the monitor keeps counts, not the
        stream). The same draw as the reference's, so the plans are
        equal."""
        pmf = np.asarray(counts, np.float64)
        pmf = pmf / pmf.sum()
        rng = np.random.default_rng(self.seed)
        return rng.choice(256, size=self.sample_symbols,
                          p=pmf).astype(np.uint8)

    def recalibrate(self, name: str, counts: np.ndarray):
        """Histogram -> the revision entry bound to ``name`` (the current
        entry when recalibration lands on the deployed codec)."""
        counts = np.asarray(counts, np.float64)
        if counts.sum() <= 0:
            raise ValueError(f"empty histogram for {name!r}")
        cur = self.registry[name]
        tables = adapt.calibrate_tables(counts,
                                        allow_search=self.allow_search)
        plan0 = plan_for_tables(
            tables, counts,
            chunk_symbols=cur.plan.chunk_symbols,
            target_escape_prob=self.target_escape_prob,
            pool_slots_per_1k=cur.plan.pool_slots_per_1k,
            drift_margin_bits=cur.plan.drift_margin_bits)
        plan = empirical_plan(
            tables, self._synthetic_stream(counts), plan0,
            chunk_symbols=cur.plan.chunk_symbols,
            target_escape_prob=self.target_escape_prob,
            max_pool_slots_per_1k=self.max_pool_slots_per_1k)
        return self.registry.register_revision(name, tables, plan,
                                               counts=counts)
