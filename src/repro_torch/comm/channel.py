"""Channels, local part: a codec bound once (tables + wire config) and
the codes transforms it runs.

A :class:`Channel` resolves a :class:`ChannelSpec` against a
``CodecRegistry`` at construction — the entry's tables, and its wire
config from the calibrated plan unless one is given — and exposes
``compress_codes`` / ``decompress_codes``. :func:`open_channels` opens
one per registry name. Transports, mesh axes and the collectives come
with ROADMAP queue 1 item 6; a spec or a call that names a mesh or an
axis raises ``NotImplementedError`` until then.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.comm import compressed as comp
from repro_torch.core.lut import CodecTables
from repro_torch.core.registry import CodecEntry

_NO_MESH = ("mesh-bound channels (transports, axes, collectives) are not "
            "ported yet: ROADMAP queue 1, item 6")


@dataclasses.dataclass(frozen=True)
class ChannelSpec:
    """Declarative channel binding.

    ``codec``: a registry key (resolved against the registry the channel
    is opened with), a ``CodecEntry``, a bare ``CodecTables`` (requires
    ``cfg``), or ``None`` (the registry's ``"default"``/first entry).
    ``cfg``: explicit ``CommConfig``; optional with an entry.
    ``axis``: a mesh axis (not ported). ``use_kernels``: overrides the
    config's field, which is kept for the reference's JSON and does not
    pick the route.
    """
    codec: Any = None
    cfg: Optional[comp.CommConfig] = None
    axis: Optional[str] = None
    use_kernels: Optional[bool] = None

    def cfg_overrides(self) -> Dict[str, Any]:
        return ({} if self.use_kernels is None
                else {"use_kernels": self.use_kernels})


class Channel:
    """An immutable, resolved codec binding (see the module docstring)."""

    def __init__(self, spec: ChannelSpec, registry=None):
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
        for name, value in (("spec", spec), ("registry", registry),
                            ("entry", entry), ("tables", tables),
                            ("cfg", cfg)):
            object.__setattr__(self, name, value)

    def __setattr__(self, name, value):
        raise AttributeError("Channel is immutable")

    def __repr__(self):
        name = self.entry.name if self.entry is not None else "<tables>"
        return f"Channel(codec={name!r}, cfg={self.cfg})"

    def compress_codes(self, codes: torch.Tensor) -> comp.WirePayload:
        """uint8 symbols [..., M] -> payload (no quantization)."""
        return comp._compress_codes(codes, self.tables, self.cfg)

    def decompress_codes(self, payload: comp.WirePayload
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """payload -> (uint8 symbols, ok)."""
        return comp._decompress_codes(payload, self.tables, self.cfg)


def open_channels(registry, mesh=None, *, axis: Optional[str] = None,
                  use_kernels: Optional[bool] = None) -> Dict[str, Channel]:
    """Open one :class:`Channel` per registry name: ``{name: Channel}``."""
    if mesh is not None:
        raise NotImplementedError(_NO_MESH)
    return {name: Channel(ChannelSpec(codec=name, axis=axis,
                                      use_kernels=use_kernels),
                          registry=registry)
            for name in registry.names()}
