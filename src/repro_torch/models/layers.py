"""Shared model layers: RMS norm, rotary embeddings, MLPs, embeddings.

Same math and parameter layout as the reference package's
``models/layers.py``; einsum strings are kept so the two read alike.

Tensor parallelism: given a ``launch.mesh.ModelRow``, :func:`mlp` takes
its weights split over the row (``w_in`` and ``w_gate`` by columns,
``w_out`` by rows, the ``mlp`` dim of :func:`mlp_param_specs`) and sums
the partial outputs over it; :func:`embed` takes a vocab-split table (a
masked lookup of the rank's rows, then the sum) and :func:`unembed` a
vocab-split table or head (each rank's logits, gathered along the
vocab). The caller passes a row only for weights that are split.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import (copy_to_model, gather_from_model,
                                     reduce_from_model)


def keep_whole(path, leaf: torch.Tensor) -> torch.Tensor:
    """The ``keep`` of the init functions that keeps every leaf whole
    (``transformer.init_params``)."""
    return leaf


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dt)


def rope_freqs(head_dim: int, theta: float, fraction: float = 1.0,
               device=None):
    """Inverse frequencies for the rotated sub-dimension."""
    rot = int(head_dim * fraction) // 2 * 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    # a fill on the device, not a copy of a host scalar (which waits)
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                      device=device), exps), rot


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x: [B, S, N, H]; positions: [B, S] int. Rotates the first
    ``fraction`` of head dims; the rest pass through."""
    b, s, n, h = x.shape
    inv, rot = rope_freqs(h, theta, fraction, device=x.device)
    if rot == 0:
        return x
    ang = positions[..., None].float() * inv               # [B, S, rot/2]
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    xr = x[..., :rot].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rotated = torch.stack([r1, r2], dim=-1).reshape(b, s, n, rot)
    return torch.cat([rotated.to(x.dtype), x[..., rot:]], dim=-1)


def _act(name: str):
    """The FFN activation. ``gelu`` is the tanh form, which is what the
    reference's ``jax.nn.gelu`` computes by default (torch's default,
    the erf form, differs by up to 5e-4)."""
    if name == "swiglu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "squared_relu":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(name)


def mlp(params, x: torch.Tensor, activation: str, row=None,
        reduce: bool = True) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D]. SwiGLU gates with ``w_gate``; the other
    activations have no gate. ``row``: the model row the weights are
    split over (None: whole); ``reduce=False`` returns this rank's
    partial output, for a caller that sums it over the row with its
    own."""
    act = _act(activation)
    x = copy_to_model(x, row)
    h = torch.einsum("bsd,df->bsf", x, params["w_in"].to(x.dtype))
    if activation == "swiglu":
        g = torch.einsum("bsd,df->bsf", x, params["w_gate"].to(x.dtype))
        h = act(g) * h
    else:
        h = act(h)
    out = torch.einsum("bsf,fd->bsd", h, params["w_out"].to(x.dtype))
    return reduce_from_model(out, row) if reduce else out


def mlp_param_specs(activation: str):
    specs = {"w_in": ("embed", "mlp"), "w_out": ("mlp", "embed")}
    if activation == "swiglu":
        specs["w_gate"] = ("embed", "mlp")
    return specs


def embed(table: torch.Tensor, tokens: torch.Tensor, row=None
          ) -> torch.Tensor:
    """``table[tokens]``; with ``row``, ``table`` is this rank's block of
    ``table.shape[0]`` rows of the vocab: the tokens outside it look up
    zeros and the sum over the row completes the embedding exactly (one
    non-zero term)."""
    if row is None:
        return table[tokens]
    n = table.shape[0]
    local = tokens - row.index * n
    inside = (local >= 0) & (local < n)
    x = table[torch.where(inside, local, torch.zeros_like(local))]
    x = torch.where(inside[..., None], x, torch.zeros_like(x))
    return reduce_from_model(x, row)


def unembed(table_or_head: torch.Tensor, x: torch.Tensor, tied: bool,
            row=None) -> torch.Tensor:
    """Logits over the whole vocab; with ``row``, ``table_or_head`` is
    this rank's vocab block and the row's logits are gathered."""
    x = copy_to_model(x, row)
    if tied:
        out = torch.einsum("bsd,vd->bsv", x, table_or_head.to(x.dtype))
    else:
        out = torch.einsum("bsd,dv->bsv", x, table_or_head.to(x.dtype))
    return gather_from_model(out, -1, row)
