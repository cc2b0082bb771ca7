"""Drift detection over the traffic monitor's ledgers.

A binding drifts when its measured bits/symbol exceeds what its plan
promised by more than the plan's own ``drift_margin_bits``, the headroom
the slot sizing used, so slot capacity and recalibration trigger at one
threshold. Escape-pool or container-overflow spikes trigger on their
own: a shifted distribution can keep its mean code length while its
tails grow.

Noise control: the signal is EMA'd, a flag needs ``hysteresis``
consecutive updates over the threshold, and a fresh (just swapped)
binding is immune for ``cooldown`` updates.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.adaptive.monitor import TrafficMonitor


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    #: Override of the per-entry ``plan.drift_margin_bits``; None reads
    #: each entry's own.
    margin_bits: Optional[float] = None
    #: EMA weight of the newest measured-bits observation.
    ema_alpha: float = 0.3
    #: Minimum (decayed) symbols in the ledger before judging.
    min_symbols: float = 4096.0
    #: Minimum observations before judging.
    min_events: int = 2
    #: Escape-rate trigger: a rate beyond ``factor *
    #: plan.escape_prob_bound`` flags drift on its own.
    escape_rate_factor: float = 8.0
    #: Container-overflow-rate trigger (an overflow already paid the
    #: lossless fallback, so the bar is low).
    overflow_rate_limit: float = 0.05
    #: Consecutive over-threshold updates required to flag.
    hysteresis: int = 2
    #: Updates a fresh (just swapped) binding is immune for.
    cooldown: int = 3


@dataclasses.dataclass
class _State:
    ema_bits: Optional[float] = None
    over: int = 0
    cooldown: int = 0


class DriftPolicy:
    """Stateful per-binding drift decision over a :class:`TrafficMonitor`."""

    def __init__(self, monitor: TrafficMonitor,
                 config: DriftConfig = DriftConfig()):
        self.monitor = monitor
        self.config = config
        self._state: Dict[Tuple[str, int], _State] = {}

    def _state_for(self, name: str, sid: int) -> _State:
        return self._state.setdefault((name, sid), _State())

    def update(self, name: str) -> bool:
        """Fold the latest ledger into the EMA; True: drift flagged."""
        cfg = self.config
        entry = self.monitor.registry[name]
        t = self.monitor.traffic(name)
        st = self._state_for(name, entry.scheme_id)
        if st.cooldown > 0:
            st.cooldown -= 1
            return False
        if t is None or t.symbols < cfg.min_symbols \
                or t.events < cfg.min_events:
            return False

        measured = t.measured_bits_per_symbol(entry.tables.enc_len)
        st.ema_bits = measured if st.ema_bits is None else \
            (1 - cfg.ema_alpha) * st.ema_bits + cfg.ema_alpha * measured

        margin = cfg.margin_bits if cfg.margin_bits is not None \
            else entry.plan.drift_margin_bits
        bits_over = (st.ema_bits
                     > entry.plan.expected_bits_per_symbol + margin)
        escapes_over = (t.chunks > 0 and t.escape_rate
                        > cfg.escape_rate_factor
                        * max(entry.plan.escape_prob_bound, 1e-9))
        overflow_over = (t.containers > 0
                         and t.overflow_rate > cfg.overflow_rate_limit)

        if bits_over or escapes_over or overflow_over:
            st.over += 1
        else:
            st.over = 0
        return st.over >= cfg.hysteresis

    def notify_swapped(self, name: str):
        """Arm the post-swap cooldown on the new binding."""
        entry = self.monitor.registry[name]
        st = self._state_for(name, entry.scheme_id)
        st.ema_bits = None
        st.over = 0
        st.cooldown = self.config.cooldown
