"""Wire-format and transport planning.

Wire format: the static slot size per chunk, from the calibration
histogram (mean code length plus a Hoeffding-bounded margin so the
per-chunk escape probability stays below ``target_escape_prob``).

Transport: an alpha-beta cost model (:class:`AlphaBetaModel`) picks
between one-shot (one collective of the whole payload, decode after it)
and ring (point-to-point hops, hop *k*'s decode overlapping hop *k+1*'s
transfer) and sizes the ring's hop chunking; the all-to-all's ring is priced
with the link traversals of its distance-*s* hops
(:func:`modeled_a2a_ring_time`). ``Channel.autotune`` replaces the
model's first-order constants with measured ones. The hierarchical
(two-tier) kind and the use of the cross-pod (``"dcn"``) link class
wait for multi-node (ROADMAP queue 1, item 13): its constants are
carried, and round-trip through registry JSON, but no schedule here
reads them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

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

    @property
    def capacity_bits(self) -> int:
        return self.capacity_words * 32

    @property
    def wire_bytes_per_symbol(self) -> float:
        """Main-slot wire bytes per symbol (without scales, flags, pool)."""
        return self.capacity_words * 4 / self.chunk_symbols

    def pool_slots(self, n_chunks: int) -> int:
        return max(1, math.ceil(n_chunks * self.pool_slots_per_1k / 1024))


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


def effective_compression_ratio(plan: CommPlan,
                                scale_bytes_per_symbol: float = 2.0 / 32,
                                baseline_bytes: float = 2.0) -> float:
    """Baseline (bf16) bytes over compressed wire bytes per symbol, the
    scales and the flag byte per chunk included."""
    wire = plan.wire_bytes_per_symbol + scale_bytes_per_symbol \
        + 1.0 / plan.chunk_symbols
    return baseline_bytes / wire


# --------------------------------------------------------------------------
# Transport selection (one-shot vs ring, hop chunking)
# --------------------------------------------------------------------------

#: The valid ``TransportConfig.kind`` values. ``"hierarchical"`` is kept
#: so configs round-trip with the reference; running it raises (item 13).
TRANSPORT_KINDS = ("oneshot", "ring", "hierarchical")


@dataclasses.dataclass(frozen=True)
class TransportConfig:
    """Static transport selection for one compressed collective.

    ``kind``: ``"oneshot"`` (one ``all_to_all`` / ``all_gather`` of the
    whole compressed payload, decode strictly after it) or ``"ring"``
    (``d - 1`` point-to-point hops; hop *k* is decoded, and for a
    reduce-scatter accumulated, while hop *k+1* is in flight).
    ``hop_chunks`` splits each hop's payload into that many
    independently compressed pieces.
    """
    kind: str = "oneshot"
    hop_chunks: int = 1

    def __post_init__(self):
        if self.kind not in TRANSPORT_KINDS:
            raise ValueError(
                f"unknown transport kind {self.kind!r}; valid kinds: "
                + ", ".join(repr(k) for k in TRANSPORT_KINDS))
        if self.hop_chunks < 1:
            raise ValueError("hop_chunks must be >= 1")


ONESHOT = TransportConfig("oneshot")
RING = TransportConfig("ring")


def resolve_transport(transport) -> TransportConfig:
    """Normalize ``None`` (one-shot) / str / TransportConfig."""
    if transport is None:
        return ONESHOT
    if isinstance(transport, TransportConfig):
        return transport
    if isinstance(transport, str):
        return TransportConfig(kind=transport)
    raise TypeError(
        f"bad transport spec: {transport!r} (expected None, a "
        f"TransportConfig, or one of {TRANSPORT_KINDS})")


#: Ring hop-chunk candidates the planner compares.
HOP_CHUNK_CANDIDATES = (1, 2, 4, 8)


def clamp_hop_chunks(hop_chunks: int, n_chunks: int) -> int:
    """Largest h <= hop_chunks that tiles ``n_chunks`` (>= 1): ring hop
    pieces must tile the payload's chunk count, or the per-piece padding
    would change the ZeRO-1 segment geometry."""
    h = max(1, min(hop_chunks, n_chunks))
    while n_chunks % h:
        h -= 1
    return h


#: Link classes of the cost model: ``"ici"``, the link a single-node
#: group runs over (NVLink here; the name is the reference's), and
#: ``"dcn"``, the cross-node network a pod axis crosses (item 13).
LINK_CLASSES = ("ici", "dcn")


@dataclasses.dataclass(frozen=True)
class AlphaBetaModel:
    """alpha-beta cost model of one compressed-collective exchange.

    Defaults are for one NVIDIA H100 SXM node (NVIDIA's H100 SXM data
    sheet: NVLink 900 GB/s per card, 450 GB/s each way; HBM 3.35 TB/s):

    * ``alpha_s`` — per-message latency of an NCCL point-to-point or
      collective launch, a first-order 10 us.
    * ``wire_Bps`` — one NVLink direction, 450 GB/s.
    * ``decode_Bps`` — fused decode->dequantize throughput in decoded f32
      bytes per second: K2's rate on the H100 at the weight wire's
      largest leaf, 3.2 GB in 4.7 ms (``chip_smoke.py``), about
      0.69 TB/s; the HBM rate of 3.35 TB/s bounds it.
    * ``dispatch_s`` — per decode dispatch on the host: the eager
      PyTorch launches around one piece's decode and escape merge,
      about ten at ~30 us each (``chip_smoke.py``'s profile line).
    * ``dcn_alpha_s`` / ``dcn_wire_Bps`` — the cross-node class: a
      first-order 25 us and one 400 Gb/s NIC (50 GB/s). Carried for the
      registry's link cache; no port schedule reads them yet (item 13).

    ``with_link(link, ...)`` folds measured constants of one link class
    in (``Channel.autotune``'s wire probe -> the registry's link cache
    -> here).
    """
    alpha_s: float = 10e-6
    wire_Bps: float = 450e9
    decode_Bps: float = 0.69e12
    dispatch_s: float = 300e-6
    dcn_alpha_s: float = 25e-6
    dcn_wire_Bps: float = 50e9

    def _check_link(self, link: str):
        if link not in LINK_CLASSES:
            raise ValueError(f"unknown link class {link!r}; valid "
                             f"classes: {LINK_CLASSES}")

    def link_alpha(self, link: str = "ici") -> float:
        self._check_link(link)
        return self.dcn_alpha_s if link == "dcn" else self.alpha_s

    def link_Bps(self, link: str = "ici") -> float:
        self._check_link(link)
        return self.dcn_wire_Bps if link == "dcn" else self.wire_Bps

    def with_link(self, link: str, *, alpha_s: Optional[float] = None,
                  wire_Bps: Optional[float] = None) -> "AlphaBetaModel":
        """Copy with ``link``'s measured constants substituted."""
        self._check_link(link)
        pre = "dcn_" if link == "dcn" else ""
        kw = {}
        if alpha_s is not None:
            kw[pre + "alpha_s"] = float(alpha_s)
        if wire_Bps is not None:
            kw[pre + "wire_Bps"] = float(wire_Bps)
        return dataclasses.replace(self, **kw) if kw else self

    def wire_time(self, wire_bytes: float, link: str = "ici") -> float:
        return self.link_alpha(link) + wire_bytes / self.link_Bps(link)

    def decode_time(self, value_bytes: float) -> float:
        return self.dispatch_s + value_bytes / self.decode_Bps


def payload_wire_bytes(n_symbols: int, chunk_symbols: int,
                       capacity_words: int, pool_slots_per_1k: int = 8,
                       scale_bytes: int = 2, hop_chunks: int = 1) -> int:
    """Static wire bytes of one shard's compressed payload (slots +
    flags + pool + pool count + block-32 scales) without building it.
    ``hop_chunks > 1`` charges one row-sized escape pool and pool count
    per piece (the ring's ok-parity wire shape)."""
    n_chunks = max(1, math.ceil(n_symbols / chunk_symbols))
    pool_slots = max(1, math.ceil(n_chunks * pool_slots_per_1k / 1024))
    pieces = max(1, int(hop_chunks))
    return (n_chunks * capacity_words * 4
            + n_chunks
            + pieces * pool_slots * chunk_symbols
            + pieces * 4
            + scale_bytes * math.ceil(n_symbols / 32))


def modeled_oneshot_time(model: AlphaBetaModel, shard_wire_bytes: float,
                         shard_value_bytes: float, axis_size: int,
                         n_decode_dispatches: int = 1) -> float:
    """One-shot: every peer's payload crosses the wire, then decode runs
    strictly after it. The reduce-scatter pays ``axis_size`` accumulate
    dispatches (the ring's op sequence), the all-gather one."""
    d = axis_size
    wire = model.wire_time(shard_wire_bytes * (d - 1))
    return (wire + shard_value_bytes * d / model.decode_Bps
            + max(1, n_decode_dispatches) * model.dispatch_s)


def modeled_ring_time(model: AlphaBetaModel, shard_wire_bytes: float,
                      shard_value_bytes: float, axis_size: int,
                      hop_chunks: int = 1) -> float:
    """Ring: ``(d-1) * hop_chunks`` messages; decode of unit *k* overlaps
    the transfer of unit *k+1*: fill + steady ``max(transfer, decode)``
    per unit + drain."""
    d = axis_size
    if d <= 1:
        return model.decode_time(shard_value_bytes)
    h = hop_chunks
    unit_wire = model.wire_time(shard_wire_bytes / h)
    unit_dec = model.decode_time(shard_value_bytes / h)
    n_units = (d - 1) * h
    return (unit_wire + (n_units - 1) * max(unit_wire, unit_dec)
            + unit_dec)


def choose_transport(shard_wire_bytes: float, shard_value_bytes: float,
                     axis_size: int,
                     model: Optional[AlphaBetaModel] = None,
                     hop_chunk_candidates: Sequence[int]
                     = HOP_CHUNK_CANDIDATES,
                     n_oneshot_decode_dispatches: int = 1
                     ) -> TransportConfig:
    """The transport (and ring hop chunking) of least modeled time for
    one device's shard of ``shard_wire_bytes`` / ``shard_value_bytes``
    over a group of ``axis_size``."""
    model = model or AlphaBetaModel()
    if axis_size <= 1:
        return ONESHOT
    best = ("oneshot", 1,
            modeled_oneshot_time(model, shard_wire_bytes,
                                 shard_value_bytes, axis_size,
                                 n_oneshot_decode_dispatches))
    for h in hop_chunk_candidates:
        t = modeled_ring_time(model, shard_wire_bytes, shard_value_bytes,
                              axis_size, h)
        if t < best[2]:
            best = ("ring", h, t)
    return TransportConfig(kind=best[0], hop_chunks=best[1])


def modeled_a2a_ring_time(model: AlphaBetaModel, row_wire_bytes: float,
                          row_value_bytes: float, axis_size: int,
                          hop_chunks: int = 1) -> float:
    """Ring all-to-all: hop *s* moves row ``(i+s) % d`` over distance
    *s* while the previous unit decodes. A distance-*s* hop is charged
    *s* link traversals (``s * row_wire_bytes / wire_Bps``), as on one
    physical ring, so the a2a ring wins only where decode is slow next to
    the wire. ``row_*_bytes`` describe one destination row; the own
    row's decode overlaps the first transfer."""
    d = axis_size
    if d <= 1:
        return model.decode_time(row_value_bytes)
    h = hop_chunks
    unit_dec = model.decode_time(row_value_bytes / h)

    def unit_wire(s: int) -> float:
        return model.alpha_s + s * (row_wire_bytes / h) / model.wire_Bps

    units = [s for s in range(1, d) for _ in range(h)]
    t = unit_wire(units[0])
    for s in units[1:]:
        t += max(unit_wire(s), unit_dec)
    return t + unit_dec


def choose_a2a_transport(row_wire_bytes: float, row_value_bytes: float,
                         axis_size: int,
                         model: Optional[AlphaBetaModel] = None,
                         hop_chunk_candidates: Sequence[int]
                         = HOP_CHUNK_CANDIDATES) -> TransportConfig:
    """Transport of ``Channel.all_to_all``: one-shot (``d - 1`` remote
    rows over the wire, then every decode) against the distance-charged
    ring of :func:`modeled_a2a_ring_time`, on per-row sizes."""
    model = model or AlphaBetaModel()
    if axis_size <= 1:
        return ONESHOT
    best = ("oneshot", 1,
            modeled_oneshot_time(model, row_wire_bytes, row_value_bytes,
                                 axis_size))
    for h in hop_chunk_candidates:
        t = modeled_a2a_ring_time(model, row_wire_bytes, row_value_bytes,
                                  axis_size, h)
        if t < best[2]:
            best = ("ring", h, t)
    return TransportConfig(kind=best[0], hop_chunks=best[1])


def transport_crossover_bytes(axis_size: int,
                              model: Optional[AlphaBetaModel] = None,
                              compression_ratio: float = 2.1,
                              lo: float = 1024.0,
                              hi: float = float(1 << 40)) -> float:
    """Smallest shard value size (bytes) at which the ring's modeled time
    beats one-shot, by bisection (``compression_ratio`` maps value bytes
    to wire bytes)."""
    model = model or AlphaBetaModel()

    def ring_wins(value_bytes: float) -> bool:
        wire = value_bytes / compression_ratio
        one = modeled_oneshot_time(model, wire, value_bytes, axis_size)
        ring = min(modeled_ring_time(model, wire, value_bytes, axis_size,
                                     h) for h in HOP_CHUNK_CANDIDATES)
        return ring < one

    if ring_wins(lo):
        return lo
    if not ring_wins(hi):
        return hi
    for _ in range(60):
        mid = math.sqrt(lo * hi)
        if ring_wins(mid):
            hi = mid
        else:
            lo = mid
    return hi
