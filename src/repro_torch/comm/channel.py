"""Channels: a codec bound once (tables + wire config), a transport policy
and, for the collectives, a ``torch.distributed`` process group.

A :class:`Channel` resolves a :class:`ChannelSpec` against a
``CodecRegistry`` at construction — the entry's tables, and its wire
config from the calibrated plan unless one is given — and exposes the
local transforms (``compress`` / ``decompress``, ``compress_codes`` /
``decompress_codes``) and, bound to a data-parallel process group
(``ChannelSpec(group=...)``, in place of the reference's mesh axis), the
compressed ``reduce_scatter`` and ``all_gather``. :func:`open_channels`
opens one per registry name.

The ``"auto"`` transport policy resolves per call from the payload's
geometry through the planner's alpha-beta model. Not ported yet, and
raising ``NotImplementedError`` naming the ROADMAP item: mesh axes (the
reference's model axis) and ``psum`` / ``all_to_all`` (queue 1, item 6),
the pod axis and the hierarchical transport (item 13), and the measured
``autotune`` with its registry cache (item 6).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.comm import compressed as comp
from repro_torch.comm import transport as tr
from repro_torch.comm.planner import (AlphaBetaModel, ONESHOT,
                                      TransportConfig, choose_transport,
                                      clamp_hop_chunks, payload_wire_bytes)
from repro_torch.core.lut import CodecTables
from repro_torch.core.registry import CodecEntry

#: sentinel transport policy: resolve per call from the payload geometry.
AUTO = "auto"

_NO_MESH = ("mesh axes are not ported (ROADMAP queue 1, item 6: the model "
            "axis); bind a data-parallel process group with "
            "ChannelSpec(group=...)")


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
    binds no group (local transforms only). ``axis``: a mesh axis (not
    ported). ``use_kernels`` / ``enabled`` / ``scale_dtype``: non-plan
    wire knobs; ``None`` keeps the codec's. ``use_kernels`` is kept for
    the reference's JSON and does not pick the route.
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
        if spec.axis is not None:
            raise NotImplementedError(_NO_MESH)
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
    def transport(self):
        """The bound policy: a ``TransportConfig`` or ``"auto"``."""
        return self._transport

    def _group_size(self) -> int:
        if self.spec.group is None:
            raise ValueError("this channel has no process group bound; "
                             "collectives need ChannelSpec(group=...)")
        return dist.get_world_size(self.spec.group)

    def resolved_transport(self, n_values: int, *,
                           is_reduce: bool = False) -> TransportConfig:
        """Concrete transport for one collective call on ``n_values``
        f32 values of this rank. ``"auto"`` asks the planner's model (the
        one-shot reduce-scatter charged its ``d`` accumulate dispatches);
        ring hop chunking is clamped to tile the per-rank chunk count."""
        d = self._group_size()
        k = self.cfg.chunk_symbols
        unit = -(-int(n_values) // d) if is_reduce else int(n_values)
        t = self._transport
        if t == AUTO:
            wire = payload_wire_bytes(unit, k, self.cfg.capacity_words,
                                      self.cfg.pool_slots_per_1k)
            t = choose_transport(wire, 4.0 * unit, d, model=self.model,
                                 n_oneshot_decode_dispatches=(
                                     d if is_reduce else 1))
        if t.kind == "ring":
            t = dataclasses.replace(t, hop_chunks=clamp_hop_chunks(
                t.hop_chunks, max(1, -(-unit // k))))
        return t

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

    def psum(self, x: torch.Tensor):
        raise NotImplementedError("Channel.psum is not ported: ROADMAP "
                                  "queue 1, item 6")

    def all_to_all(self, x: torch.Tensor):
        raise NotImplementedError("Channel.all_to_all is not ported: "
                                  "ROADMAP queue 1, item 6 (and MoE, "
                                  "item 11)")

    def autotune(self, *args, **kwargs):
        raise NotImplementedError("Channel.autotune is not ported: ROADMAP "
                                  "queue 1, item 6")


def open_channels(registry, mesh=None, *, axis: Optional[str] = None,
                  group=None, transport=None,
                  use_kernels: Optional[bool] = None) -> Dict[str, Channel]:
    """Open one :class:`Channel` per registry name: ``{name: Channel}``,
    bound to ``group`` (a data-parallel process group) when given."""
    if mesh is not None:
        raise NotImplementedError(_NO_MESH)
    return {name: Channel(ChannelSpec(codec=name, axis=axis, group=group,
                                      transport=transport,
                                      use_kernels=use_kernels),
                          registry=registry)
            for name in registry.names()}
