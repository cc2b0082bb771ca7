"""Traffic telemetry: encode-pass histograms accumulated per channel.

K1 counts the symbols it encodes (``emit_hist``), so observing a channel
costs one int32 [256] device-to-host read per observation. The monitor
turns those histograms into what the drift policy reads: measured
bits/symbol under the deployed codec, the escape-chunk rate and the
container-overflow rate, per ``(name, scheme_id)``, so a hot-swap starts
a fresh ledger.

Accumulation decays per observation, so after a shift the old phase
washes out and a recalibration on :attr:`ChannelTraffic.counts` follows
the new distribution. The float64 arithmetic is the reference's, op for
op, so both packages give the same numbers on the same histograms.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

NUM_SYMBOLS = 256


@dataclasses.dataclass
class ChannelTraffic:
    """Decayed traffic ledger of one ``(name, scheme_id)`` binding."""
    name: str
    scheme_id: int
    counts: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(NUM_SYMBOLS, np.float64))
    symbols: float = 0.0          # decayed total of counts.sum()
    escaped_chunks: float = 0.0   # decayed escape-pool occupancy
    chunks: float = 0.0           # decayed chunk count (escape basis)
    overflows: float = 0.0        # decayed container-overflow events
    containers: float = 0.0       # decayed container count
    events: int = 0               # observations (not decayed)

    def measured_bits_per_symbol(self, enc_len: np.ndarray) -> float:
        """Mean code length of the observed traffic under ``enc_len``
        (the deployed codec's per-symbol bit table)."""
        if self.symbols <= 0:
            return 0.0
        return float(np.dot(self.counts,
                            np.asarray(enc_len, np.float64))
                     / self.symbols)

    def entropy_bits_per_symbol(self) -> float:
        """Shannon bound of the observed traffic: the best any codec
        could do."""
        if self.symbols <= 0:
            return 0.0
        p = self.counts / self.counts.sum()
        nz = p[p > 0]
        return float(-(nz * np.log2(nz)).sum())

    @property
    def escape_rate(self) -> float:
        return self.escaped_chunks / self.chunks if self.chunks > 0 else 0.0

    @property
    def overflow_rate(self) -> float:
        return (self.overflows / self.containers
                if self.containers > 0 else 0.0)


class TrafficMonitor:
    """Accumulates encode-side histograms per ``(name, scheme_id)``.

    ``registry`` resolves a name to its current binding, so
    ``observe(name, hist)`` files the histogram under the deployed
    scheme-id; after a hot-swap new traffic lands in a fresh ledger and
    the old one stays readable.
    """

    def __init__(self, registry, *, decay: float = 0.97):
        if not (0.0 < decay <= 1.0):
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        self.registry = registry
        self.decay = float(decay)
        self._traffic: Dict[Tuple[str, int], ChannelTraffic] = {}

    def observe(self, name: str, hist, *,
                escaped_chunks: Optional[float] = None,
                chunks: Optional[float] = None,
                overflow: bool = False,
                containers: float = 0.0,
                scheme_id: Optional[int] = None) -> ChannelTraffic:
        """File one encode pass's histogram (256 bins, numpy or a CPU
        tensor). ``escaped_chunks`` / ``chunks`` record escape-pool
        pressure where the caller has it; ``overflow`` marks a container
        whose pool overflowed (the lossless fallback was taken)."""
        hist = np.asarray(hist, np.float64).reshape(-1)
        if hist.shape[0] != NUM_SYMBOLS:
            raise ValueError(f"hist must have {NUM_SYMBOLS} bins, "
                             f"got {hist.shape}")
        if scheme_id is None:
            scheme_id = self.registry[name].scheme_id
        key = (name, int(scheme_id))
        t = self._traffic.get(key)
        if t is None:
            t = self._traffic[key] = ChannelTraffic(name=name,
                                                    scheme_id=key[1])
        d = self.decay
        t.counts = t.counts * d + hist
        t.symbols = t.symbols * d + float(hist.sum())
        t.escaped_chunks = t.escaped_chunks * d + float(escaped_chunks or 0)
        t.chunks = t.chunks * d + float(chunks or 0)
        t.overflows = t.overflows * d + (1.0 if overflow else 0.0)
        t.containers = t.containers * d + float(containers)
        t.events += 1
        return t

    def traffic(self, name: str,
                scheme_id: Optional[int] = None) -> Optional[ChannelTraffic]:
        """Ledger of ``name`` under its current (or the given) id."""
        if scheme_id is None:
            scheme_id = self.registry[name].scheme_id
        return self._traffic.get((name, int(scheme_id)))

    def names(self) -> List[str]:
        return sorted({n for n, _ in self._traffic})

    def measured_bits(self, name: str) -> Optional[float]:
        """Measured bits/symbol of ``name``'s current binding, or None
        before any traffic."""
        entry = self.registry[name]
        t = self.traffic(name)
        if t is None or t.symbols <= 0:
            return None
        return t.measured_bits_per_symbol(entry.tables.enc_len)

    def excess_bits(self, name: str) -> Optional[float]:
        """Measured minus the plan's expectation (positive: drift)."""
        m = self.measured_bits(name)
        if m is None:
            return None
        return m - self.registry[name].plan.expected_bits_per_symbol

    def reset(self, name: str, scheme_id: Optional[int] = None):
        """Drop the ledger of one binding."""
        if scheme_id is None:
            scheme_id = self.registry[name].scheme_id
        self._traffic.pop((name, int(scheme_id)), None)

    def snapshot(self) -> List[dict]:
        """Loggable summary rows, one per tracked binding."""
        rows = []
        for (name, sid), t in sorted(self._traffic.items()):
            entry = self.registry._by_id.get(sid)
            row = {"name": name, "scheme_id": sid, "events": t.events,
                   "symbols": t.symbols,
                   "escape_rate": t.escape_rate,
                   "overflow_rate": t.overflow_rate,
                   "entropy_bits": t.entropy_bits_per_symbol()}
            if entry is not None:
                row["measured_bits"] = t.measured_bits_per_symbol(
                    entry.tables.enc_len)
                row["expected_bits"] = entry.plan.expected_bits_per_symbol
            rows.append(row)
        return rows
