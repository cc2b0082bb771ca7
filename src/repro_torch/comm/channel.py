"""Channels: a codec bound once (tables + wire config), a transport policy
and, for the collectives, a ``torch.distributed`` process group.

A :class:`Channel` resolves a :class:`ChannelSpec` against a
``CodecRegistry`` at construction — the entry's tables, and its wire
config from the calibrated plan unless one is given — and exposes the
local transforms (``compress`` / ``decompress``, ``compress_codes`` /
``decompress_codes``) and, bound to a process group, the compressed
``reduce_scatter``, ``all_gather``, ``psum`` and ``all_to_all``. The
group is given (``ChannelSpec(group=...)``) or named by a mesh axis
(``ChannelSpec(axis="data" | "model")``), which resolves against the
``launch.mesh.Mesh`` in scope (``use_mesh``): the ``"model"`` axis
carries the MoE expert all-to-all. :func:`open_channels` opens one per
registry name.

The ``"auto"`` transport policy resolves per call: first from the
registry's autotune cache, keyed by ``(scheme_id, axis, payload bucket,
is_reduce)`` where ``axis`` names the bound group (``"data"`` unless the
spec names it, as the reference's launcher names its data axis), then
from the planner's alpha-beta model with any measured link constants
of that axis folded in. :meth:`Channel.autotune` measures this card's
decode rate (:func:`measure_decode_Bps`) and the group's wire rate
(:func:`measure_wire_Bps`, one timed neighbour exchange) and fills both
caches; they ride the registry's JSON, which loads in either package.

Not ported yet, and raising ``NotImplementedError`` naming the ROADMAP
item: the pod axis and the hierarchical transport (queue 1, item 13).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.comm import compressed as comp
from repro_torch.comm import transport as tr
from repro_torch.comm.planner import (AlphaBetaModel, ONESHOT,
                                      TransportConfig, choose_a2a_transport,
                                      choose_transport, clamp_hop_chunks,
                                      payload_wire_bytes)
from repro_torch.core.lut import CodecTables
from repro_torch.core.registry import CodecEntry

#: sentinel transport policy: resolve per call from the payload geometry.
AUTO = "auto"

#: the name a bound process group goes by in the registry's caches when
#: the spec names none: the reference's data-parallel mesh axis.
DATA_AXIS = "data"



def axis_group(axis: str, mesh=None):
    """The process group of mesh axis ``axis`` (``"data"`` or
    ``"model"``) on ``mesh``, or on the mesh in scope
    (``launch.mesh.use_mesh``) when ``mesh`` is None."""
    from repro_torch.launch.mesh import NO_PODS, current_mesh
    if axis == "pod":
        raise NotImplementedError(NO_PODS)
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None:
        raise ValueError(f"ChannelSpec(axis={axis!r}) without a group needs "
                         "a mesh in scope (launch.mesh.use_mesh) or "
                         "ChannelSpec(group=...)")
    return mesh.group(axis)


@dataclasses.dataclass(frozen=True)
class ChannelSpec:
    """Declarative channel binding.

    ``codec``: a registry key (resolved against the registry the channel
    is opened with), a ``CodecEntry``, a bare ``CodecTables`` (requires
    ``cfg``), or ``None`` (the registry's ``"default"``/first entry).
    ``cfg``: explicit ``CommConfig``; optional with an entry.
    ``transport``: ``None``/``"oneshot"``, ``"ring"``, ``"auto"`` or a
    ``TransportConfig``. ``group``: the process group of the collectives
    (``torch.distributed.group.WORLD`` for the default group); ``None``
    binds no group (local transforms only). ``axis``: the bound group's
    name in the registry's caches (default ``"data"``); without a group
    it names a mesh axis (``"data"`` or ``"model"``), whose group comes
    from the mesh in scope when the channel is built.
    ``use_kernels`` / ``enabled`` / ``scale_dtype``: non-plan wire knobs;
    ``None`` keeps the codec's. ``use_kernels`` is kept for the
    reference's JSON and does not pick the route.
    """
    codec: Any = None
    cfg: Optional[comp.CommConfig] = None
    transport: Any = None
    group: Any = None
    axis: Optional[str] = None
    use_kernels: Optional[bool] = None
    enabled: Optional[bool] = None
    scale_dtype: Optional[str] = None

    def cfg_overrides(self) -> Dict[str, Any]:
        return {k: v for k, v in (("use_kernels", self.use_kernels),
                                  ("enabled", self.enabled),
                                  ("scale_dtype", self.scale_dtype))
                if v is not None}


def _resolve_transport_policy(transport):
    if transport is None:
        return ONESHOT
    if isinstance(transport, TransportConfig):
        return transport
    if isinstance(transport, str):
        return AUTO if transport == AUTO else TransportConfig(kind=transport)
    raise TypeError(f"bad transport spec: {transport!r}")


class Channel:
    """An immutable, resolved wire binding (see the module docstring)."""

    def __init__(self, spec: ChannelSpec, registry=None, *,
                 model: Optional[AlphaBetaModel] = None):
        if spec.axis is not None and spec.group is None:
            spec = dataclasses.replace(spec, group=axis_group(spec.axis))
        codec = spec.codec
        entry: Optional[CodecEntry] = None
        if isinstance(codec, CodecEntry):
            entry = codec
        elif isinstance(codec, str):
            if registry is None:
                raise TypeError(f"codec {codec!r} names a registry entry "
                                "but no registry was given")
            entry = registry[codec]
        elif codec is None:
            if registry is None:
                raise TypeError("ChannelSpec.codec is None and no registry "
                                "given")
            entry = registry.get("default")
            if entry is None:
                entries = registry.entries()
                if not entries:
                    raise TypeError("empty codec registry")
                entry = entries[0]
        if entry is not None:
            tables = entry.tables
            cfg = spec.cfg
            if cfg is None:
                cfg = entry.config(**spec.cfg_overrides())
            elif spec.cfg_overrides():
                cfg = dataclasses.replace(cfg, **spec.cfg_overrides())
        elif isinstance(codec, CodecTables):
            if spec.cfg is None:
                raise TypeError("a bare CodecTables needs an explicit "
                                "CommConfig; pass ChannelSpec(cfg=...)")
            tables = codec
            cfg = dataclasses.replace(spec.cfg, **spec.cfg_overrides())
        else:
            raise TypeError(f"bad codec spec: {codec!r}")
        transport = _resolve_transport_policy(spec.transport)
        if transport != AUTO and transport.kind == "hierarchical":
            raise NotImplementedError(tr._HIERARCHICAL)
        for name, value in (("spec", spec), ("registry", registry),
                            ("entry", entry), ("tables", tables),
                            ("cfg", cfg), ("model", model),
                            ("_transport", transport)):
            object.__setattr__(self, name, value)

    def __setattr__(self, name, value):
        raise AttributeError("Channel is immutable")

    def __repr__(self):
        name = self.entry.name if self.entry is not None else "<tables>"
        t = self._transport if self._transport == AUTO \
            else self._transport.kind
        return f"Channel(codec={name!r}, transport={t!r}, cfg={self.cfg})"

    # ---- placement / policy ----------------------------------------------

    @property
    def group(self):
        return self.spec.group

    @property
    def axis(self) -> Optional[str]:
        """The bound group's name in the registry's caches (``None``
        without a group)."""
        if self.spec.group is None:
            return None
        return DATA_AXIS if self.spec.axis is None else self.spec.axis

    @property
    def transport(self):
        """The bound policy: a ``TransportConfig`` or ``"auto"``."""
        return self._transport

    def replace(self, *, model: Optional[AlphaBetaModel] = None,
                **spec_changes) -> "Channel":
        """A new channel with updated spec fields, the same registry, and
        ``model`` or this channel's."""
        return Channel(dataclasses.replace(self.spec, **spec_changes),
                       registry=self.registry, model=model or self.model)

    def _group_size(self) -> int:
        if self.spec.group is None:
            raise ValueError("this channel has no process group bound; "
                             "collectives need ChannelSpec(group=...)")
        return dist.get_world_size(self.spec.group)

    def resolved_transport(self, n_values: int, *, is_reduce: bool = False,
                           axis_size: Optional[int] = None,
                           is_a2a: bool = False) -> TransportConfig:
        """Concrete transport for one collective call on ``n_values``
        f32 values of this rank (one destination row with ``is_a2a``).
        ``"auto"`` asks the registry's autotune cache first, then the
        planner's model with the axis's measured link constants (the
        one-shot reduce-scatter charged its ``d`` accumulate dispatches;
        the all-to-all priced by the distance-charged a2a model, whose
        ring the gather-tuned cache does not describe). Ring hop chunking
        is clamped to tile the per-rank chunk count."""
        d = int(axis_size) if axis_size is not None else self._group_size()
        k = self.cfg.chunk_symbols
        unit = -(-int(n_values) // d) if is_reduce else int(n_values)
        t = self._transport
        if t == AUTO:
            t = None
            if not is_a2a and self.registry is not None \
                    and self.entry is not None:
                t = self.registry.cached_transport(
                    self.entry.scheme_id, self.axis, 4 * unit,
                    is_reduce=is_reduce)
            if t is None:
                wire = payload_wire_bytes(unit, k, self.cfg.capacity_words,
                                          self.cfg.pool_slots_per_1k)
                model = self._linked_model()
                if is_a2a:
                    t = choose_a2a_transport(wire, 4.0 * unit, d,
                                             model=model)
                else:
                    t = choose_transport(
                        wire, 4.0 * unit, d, model=model,
                        n_oneshot_decode_dispatches=d if is_reduce else 1)
        if t.kind == "ring":
            t = dataclasses.replace(t, hop_chunks=clamp_hop_chunks(
                t.hop_chunks, max(1, -(-unit // k))))
        return t

    def _linked_model(self, base: Optional[AlphaBetaModel] = None
                      ) -> AlphaBetaModel:
        """The channel's cost model with the measured link constants of
        its axis (the registry's link cache, :meth:`autotune`) folded
        in."""
        m = base or self.model or AlphaBetaModel()
        if self.registry is None or self.axis is None:
            return m
        e = self.registry.cached_link_constants(self.axis)
        if e is not None:
            m = m.with_link(e["link"], wire_Bps=e["wire_Bps"],
                            alpha_s=e["alpha_s"])
        return m

    # ---- local transforms ----------------------------------------------

    def compress(self, x: torch.Tensor, *, with_hist: bool = False):
        """float [..., M] (M % chunk_symbols == 0) -> (payload, scales
        [, hist])."""
        return comp._compress_values(x, self.tables, self.cfg,
                                     emit_hist=with_hist)

    def decompress(self, payload: comp.WirePayload, scales: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(payload, scales) -> (f32 values, ok)."""
        return comp._decompress_values(payload, scales, self.tables,
                                       self.cfg)

    def compress_codes(self, codes: torch.Tensor) -> comp.WirePayload:
        """uint8 symbols [..., M] -> payload (no quantization)."""
        return comp._compress_codes(codes, self.tables, self.cfg)

    def decompress_codes(self, payload: comp.WirePayload
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """payload -> (uint8 symbols, ok)."""
        return comp._decompress_codes(payload, self.tables, self.cfg)

    def wire_bytes(self, payload: comp.WirePayload,
                   scales: Optional[torch.Tensor] = None) -> int:
        """Wire footprint of a payload (+ scales) in bytes."""
        return comp.wire_bytes(payload, scales)

    def modeled_wire_bytes(self, n_values: int, hop_chunks: int = 1) -> int:
        """Static wire bytes of an ``n_values``-value payload."""
        return payload_wire_bytes(int(n_values), self.cfg.chunk_symbols,
                                  self.cfg.capacity_words,
                                  self.cfg.pool_slots_per_1k,
                                  hop_chunks=hop_chunks)

    # ---- collectives over the bound process group ------------------------

    def all_gather(self, x: torch.Tensor, *, with_hist: bool = False):
        """All-gather this rank's float payload -> ``(gathered f32
        [d * x.numel()], ok)`` in rank order (+ this rank's encoded-symbol
        histogram with ``with_hist``)."""
        t = self.resolved_transport(x.numel())
        flat, n = comp.pad_to_multiple(x, t.hop_chunks
                                       * self.cfg.chunk_symbols)
        out = tr.exchange_all_gather(flat, self.group, self.tables,
                                     self.cfg, t, emit_hist=with_hist)
        vals = out[0][:, :n].reshape(-1)
        return (vals,) + tuple(out[1:])

    def reduce_scatter(self, x: torch.Tensor, *, with_hist: bool = False):
        """Reduce-scatter(sum) -> ``ReduceScatterResult(segment, valid,
        ok)``, the segment padded to the static length (+ the histogram
        of every symbol this rank encoded with ``with_hist``)."""
        d = self._group_size()
        t = self.resolved_transport(x.numel(), is_reduce=True)
        flat, n = comp.pad_to_multiple(
            x, d * t.hop_chunks * self.cfg.chunk_symbols)
        seg = flat.shape[0] // d
        out = tr.exchange_reduce_scatter(flat.reshape(d, seg), self.group,
                                         self.tables, self.cfg, t,
                                         emit_hist=with_hist)
        idx = dist.get_rank(self.group)
        res = comp.ReduceScatterResult(
            segment=out[0], valid=min(max(n - idx * seg, 0), seg),
            ok=out[1])
        return (res, out[2]) if with_hist else res

    def psum(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """All-reduce(sum): the compressed reduce-scatter, then the
        compressed all-gather of the reduced segment (both phases
        quantize; the coding adds no error) -> ``(sum shaped like x,
        ok)``."""
        r = self.reduce_scatter(x)
        full, ok_ag = self.all_gather(r.segment)
        return full[:x.numel()].reshape(x.shape), r.ok & ok_ag

    def all_to_all(self, x: torch.Tensor, *, with_hist: bool = False,
                   with_wire: bool = False):
        """Compressed all-to-all of ``x [d, ...]`` (row j goes to peer j)
        -> ``(received, shaped like x, ok)``, row j from peer j (+ the
        histogram of every symbol this rank encoded with ``with_hist``;
        + the wire bytes of this rank's payload with ``with_wire``)."""
        d = x.shape[0]
        if d != self._group_size():
            raise ValueError(f"all_to_all payload has {d} rows but the "
                             f"group has {self._group_size()} ranks")
        row = x.reshape(d, -1)
        n = row.shape[1]
        t = self.resolved_transport(n, axis_size=d, is_a2a=True)
        pad = (-n) % (t.hop_chunks * self.cfg.chunk_symbols)
        if pad:
            row = F.pad(row, (0, pad))
        out = tr.exchange_all_to_all(row, self.group, self.tables, self.cfg,
                                     t, emit_hist=with_hist,
                                     with_wire=with_wire)
        vals = out[0][:, :n].reshape(x.shape)
        return (vals,) + tuple(out[1:])

    # ---- autotune -------------------------------------------------------

    def autotune(self, payload_bytes: int, *, is_reduce: bool = False,
                 probe_symbols: int = 1 << 15, repeats: int = 3,
                 model: Optional[AlphaBetaModel] = None,
                 axis_link: str = "ici", wire_probe_bytes: int = 1 << 22,
                 device="cuda") -> "Channel":
        """Measure the decode rate on ``device`` (and, over a group of two
        or more, the group's wire rate), pick the
        transport of a ``payload_bytes`` per-rank unit, cache it and
        return the tuned channel.

        The decode probe is :func:`measure_decode_Bps` on a payload of
        this channel's codec (symbols drawn from its calibration
        histogram); the wire probe, :func:`measure_wire_Bps`, lands in
        the registry's link cache as ``axis_link``. Every rank takes the
        group's slowest measurement, so all ranks pick the same
        transport. ``is_reduce`` tunes the reduce-scatter use (the
        one-shot charged a decode dispatch per rank). The choice is
        cached under ``(scheme_id, axis, payload bucket, is_reduce)``,
        where every later ``"auto"`` channel on this registry finds it.
        The returned channel carries the tuned transport and, as its
        ``model``, the measured constants.
        """
        d = self._group_size()
        counts = None if self.entry is None else self.entry.counts
        decode_Bps, _ = measure_decode_Bps(
            self.tables, self.cfg, probe_symbols, counts=counts,
            repeats=repeats, device=device)
        wire_Bps = None
        if d >= 2:
            wire_Bps, _ = measure_wire_Bps(self.group, wire_probe_bytes,
                                           repeats=repeats, device=device)
        if d >= 2:
            rates = torch.tensor(
                [decode_Bps, math.inf if wire_Bps is None else wire_Bps],
                dtype=torch.float64, device=device)
            dist.all_reduce(rates, op=dist.ReduceOp.MIN, group=self.group)
            decode_Bps = float(rates[0])
            if wire_Bps is not None:
                wire_Bps = float(rates[1])
        if wire_Bps is not None and self.registry is not None:
            self.registry.cache_link_constants(self.axis, axis_link,
                                               wire_Bps=wire_Bps)
        base = model or self.model or AlphaBetaModel()
        tuned_model = dataclasses.replace(self._linked_model(base),
                                          decode_Bps=decode_Bps)
        n_values = max(1, int(payload_bytes) // 4)
        t = choose_transport(
            self.modeled_wire_bytes(n_values), float(payload_bytes), d,
            model=tuned_model,
            n_oneshot_decode_dispatches=d if is_reduce else 1)
        if self.registry is not None and self.entry is not None:
            self.registry.cache_transport(
                self.entry.scheme_id, self.axis, int(payload_bytes), t,
                is_reduce=is_reduce)
        return self.replace(transport=t, model=tuned_model)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def decode_probe_payload(tables, cfg, n_symbols: int, *, counts=None,
                         seed: int = 0, device="cuda"):
    """The payload :func:`measure_decode_Bps` decodes: ``n_symbols``
    (rounded down to whole chunks, at least one) symbols drawn from
    ``counts`` (uniform when omitted) exactly as the reference draws
    them, e4m3-decoded to values on ``device`` and compressed (block-32
    re-quantization included) -> ``(payload, scales, m)``."""
    from repro_torch.quant import e4m3
    k = cfg.chunk_symbols
    m = max(1, int(n_symbols) // k) * k
    rng = np.random.default_rng(seed)
    if counts is None:
        counts = np.ones(256, np.float64)
    pmf = np.maximum(np.asarray(counts, np.float64).reshape(256), 0.0)
    pmf = pmf / pmf.sum()
    syms = rng.choice(256, size=m, p=pmf).astype(np.uint8)
    x = e4m3.e4m3_decode(torch.from_numpy(syms)).to(device)
    payload, scales = comp._compress_values(x, tables, cfg)
    return payload, scales, m


def measure_decode_Bps(tables, cfg, n_symbols: int, *, counts=None,
                       repeats: int = 3, seed: int = 0, device="cuda"
                       ) -> Tuple[float, float]:
    """Decode-dequantize throughput on ``device``, in decoded f32 bytes
    per second (the planner's ``decode_Bps``), of the whole value decode
    (K2 on the card, then the escape epilogue) on
    :func:`decode_probe_payload`. One warm call, then the best of
    ``repeats`` calls, each synchronized. Returns ``(decode_Bps,
    seconds_per_call)``."""
    payload, scales, m = decode_probe_payload(
        tables, cfg, n_symbols, counts=counts, seed=seed, device=device)

    def dec():
        return comp._decompress_values(payload, scales, tables, cfg)[0]

    dec()
    _sync(device)
    best = math.inf
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        dec()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return 4.0 * m / best, best


def measure_wire_Bps(group, payload_bytes: int = 1 << 22, *,
                     repeats: int = 3, device="cuda") -> Tuple[float, float]:
    """Per-hop wire rate over ``group``: the best of ``repeats`` timed
    neighbour exchanges (each rank sends ``payload_bytes`` of f32 to rank
    ``i+1`` and receives from ``i-1``), in payload bytes per second per
    rank. Returns ``(wire_Bps, seconds_per_hop)``."""
    d = dist.get_world_size(group)
    if d < 2:
        raise ValueError("a group of one rank has no wire to probe")
    my = dist.get_rank(group)
    n = max(1, int(payload_bytes) // 4)
    x = torch.zeros(n, dtype=torch.float32, device=device)

    def hop():
        _, works = tr._exchange([x], (my + 1) % d, (my - 1) % d, group)
        tr._wait(works)
        _sync(device)

    hop()
    best = math.inf
    for _ in range(max(1, repeats)):
        dist.barrier(group=group)
        t0 = time.perf_counter()
        hop()
        best = min(best, time.perf_counter() - t0)
    return 4.0 * n / best, best


def open_channels(registry, mesh=None, *, axis: Optional[str] = None,
                  group=None, transport=None,
                  use_kernels: Optional[bool] = None) -> Dict[str, Channel]:
    """Open one :class:`Channel` per registry name: ``{name: Channel}``,
    bound to ``group`` when given, else to ``mesh``'s group along
    ``axis`` when both are given (with ``axis`` alone, to the group of
    the mesh in scope); with neither, the channels are local."""
    if group is None and axis is not None and mesh is not None:
        group = axis_group(axis, mesh)
    return {name: Channel(ChannelSpec(codec=name, axis=axis, group=group,
                                      transport=transport,
                                      use_kernels=use_kernels),
                          registry=registry)
            for name in registry.names()}


# --------------------------------------------------------------------------
# ChannelSpec JSON (the reference's manifest form)
# --------------------------------------------------------------------------

def transport_to_json(transport):
    """Transport policy -> JSON-able form (inverse of
    :func:`transport_from_json`)."""
    if transport is None or isinstance(transport, str):
        return transport
    if isinstance(transport, TransportConfig):
        return {"kind": transport.kind, "hop_chunks": transport.hop_chunks}
    raise TypeError(f"bad transport spec: {transport!r}")


def transport_from_json(d):
    if d is None or isinstance(d, str):
        return d
    return TransportConfig(kind=d["kind"],
                           hop_chunks=int(d.get("hop_chunks", 1)))


def spec_to_json(spec: ChannelSpec) -> Dict:
    """Placement and policy fields of a spec as the reference writes them
    (the codec travels in the registry JSON and container headers): a
    bound group is written as its axis name and size."""
    bound = spec.group is not None
    return {
        "transport": transport_to_json(spec.transport),
        "axis": (spec.axis or DATA_AXIS) if bound else spec.axis,
        "axis_size": dist.get_world_size(spec.group) if bound else None,
        "use_kernels": spec.use_kernels,
        "enabled": spec.enabled,
        "scale_dtype": spec.scale_dtype,
    }


def spec_from_json(d: Dict, codec=None, cfg=None, group=None
                   ) -> ChannelSpec:
    """Inverse of :func:`spec_to_json`; the caller supplies the process
    group its axis names (a pod axis is not ported, item 13)."""
    if d.get("pod_axis") is not None:
        raise NotImplementedError(tr._HIERARCHICAL)
    if group is not None and d.get("axis_size") is not None \
            and int(d["axis_size"]) != dist.get_world_size(group):
        raise ValueError(f"spec was written for {d['axis_size']} ranks; "
                         f"the group has {dist.get_world_size(group)}")
    return ChannelSpec(
        codec=codec, cfg=cfg,
        transport=transport_from_json(d.get("transport")),
        group=group, axis=d.get("axis") if group is not None else None,
        use_kernels=d.get("use_kernels"),
        enabled=d.get("enabled"),
        scale_dtype=d.get("scale_dtype"))
