"""AdamW + LR schedule (the reference's ``training/optimizer.py``).

Two state layouts:
  * tree state (mirrors params) — the baseline step;
  * flat state [seg] — the ZeRO-1 optimizer of the compressed step: each
    data-parallel rank updates its slice of the flat parameter vector.

The schedule and bias-correction scalars are computed on the host in
numpy float32 from the step count, which the state keeps on the host
(an int32 scalar tensor beside moments on any device: reading it waits
for nothing), so the update is the same bit for bit on the CPU and on
the card (every per-element op is a single IEEE
f32 operation, no fused multiply-add). The global gradient norm
accumulates its squares in f64 and is rounded to f32 once, so it does
not depend on the device's summation order either. The reference does
both in f32 under XLA; against it the update agrees to a few f32 ulps.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models.transformer import tree_leaves, tree_map

_F = np.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    moment_dtype: str = "float32"   # bfloat16 halves optimizer memory


def lr_at(cfg: OptConfig, step: int) -> np.float32:
    """Linear warmup + cosine decay to ``min_lr_frac``, in f32."""
    s = _F(step)
    warm = min(s / _F(max(cfg.warmup_steps, 1)), _F(1.0))
    prog = np.clip((s - _F(cfg.warmup_steps))
                   / _F(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   _F(0.0), _F(1.0))
    cos = _F(0.5) * (_F(1.0) + np.cos(_F(np.pi) * prog))
    frac = _F(cfg.min_lr_frac) + (_F(1.0) - _F(cfg.min_lr_frac)) * cos
    return _F(cfg.lr) * warm * frac


def _bias_corrections(cfg: OptConfig, step: int):
    s = _F(step)
    return (_F(1.0) - _F(cfg.b1) ** s, _F(1.0) - _F(cfg.b2) ** s)


def sum_of_squares(t: torch.Tensor) -> torch.Tensor:
    """f64 sum of the squares of ``t``'s values."""
    return torch.sum(torch.square(t.double()))


def global_norm(tree) -> torch.Tensor:
    """f32 scalar: the l2 norm of every leaf's values."""
    sq = torch.stack([sum_of_squares(g) for g in tree_leaves(tree)]).sum()
    return torch.sqrt(sq).float()


def split_global_norm(leaves, leaf_axes, mesh) -> torch.Tensor:
    """f32 scalar: the l2 norm of a tree held in parts over ``mesh``
    (a ``launch.mesh.Mesh``): each of ``leaves`` is this rank's part of a
    leaf split over the mesh axes ``leaf_axes[i]`` (``()``: held whole
    by every rank, counted once; ``("model",)``, ``("data",)`` or both:
    its squares summed over the model row, the data column or every
    rank), the squares summed in f64 in the leaves' order."""
    sq = [sum_of_squares(g) for g in leaves]
    groups = {("model",): mesh.model_group, ("data",): mesh.data_group,
              ("data", "model"): mesh.world_group}
    for axes, group in groups.items():
        idx = [i for i, a in enumerate(leaf_axes) if tuple(a) == axes]
        if idx:
            tot = torch.stack([sq[i] for i in idx])
            dist.all_reduce(tot, group=group)
            for j, i in enumerate(idx):
                sq[i] = tot[j]
    return torch.sqrt(torch.stack(sq).sum()).float()


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """f32 ``min(1, max_norm / max(gnorm, 1e-12))``."""
    return torch.clamp(torch.full_like(gnorm, max_norm)
                       / torch.clamp(gnorm, min=1e-12), max=1.0)


def clip_by_global_norm(tree, max_norm: float, norm=None):
    """Scale ``tree`` to l2 norm at most ``max_norm``; ``norm``: its norm
    when the caller computed it (over several ranks' leaves)."""
    norm = global_norm(tree) if norm is None else norm
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


def _adamw(p, g, m, v, cfg: OptConfig, lr, bc1, bc2):
    """One AdamW update of matching tensors; ``g`` already clipped (f32).
    Returns (new p, new m, new v) in their dtypes. In-place ops act on
    fresh temporaries only (the reference's values, fewer full-size
    buffers alive at once: the flat update runs on a billion values)."""
    m32 = m.float() * _F(cfg.b1)
    m32 += g * (_F(1.0) - _F(cfg.b1))
    v32 = v.float() * _F(cfg.b2)
    v32 += torch.square(g).mul_(_F(1.0) - _F(cfg.b2))
    denom = (v32 / bc2).sqrt_().add_(_F(cfg.eps))
    delta = (m32 / bc1).div_(denom)
    del denom
    if cfg.weight_decay:
        delta += p.float() * _F(cfg.weight_decay)
    new_p = p.float() - delta.mul_(lr)
    return new_p.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)


# ---- tree-state AdamW (the baseline step) ---------------------------------

def _host_step() -> torch.Tensor:
    """A fresh step count: an int32 scalar on the host, whatever device
    the moments are on, so that the update reads it (the f32 schedule
    is computed on the host, bit-equal on every device) without waiting
    for the device."""
    return torch.zeros((), dtype=torch.int32)


def init_state(params, cfg: OptConfig) -> Dict[str, Any]:
    dt = getattr(torch, cfg.moment_dtype)
    return {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                            device=p.device), params),
        "step": _host_step(),
    }


def apply_update(params, grads, state, cfg: OptConfig, gnorm=None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, Any]]:
    """AdamW on the tree; the clip uses ``gnorm`` when given, else the
    norm of ``grads``."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, gnorm)
    step = int(state["step"]) + 1
    lr = lr_at(cfg, step)
    bc1, bc2 = _bias_corrections(cfg, step)
    out = tree_map(lambda p, g, m, v: _adamw(p, g.float(), m, v, cfg, lr,
                                             bc1, bc2),
                   params, grads, state["m"], state["v"])
    new_state = {"m": _pick(out, 1), "v": _pick(out, 2),
                 "step": state["step"] + 1}
    return _pick(out, 0), new_state, {"lr": lr, "grad_norm": gnorm}


def _pick(tree, i: int):
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


# ---- flat-slice AdamW (ZeRO-1, the compressed step) ------------------------

def init_flat_state(seg_len: int, cfg: OptConfig, device) -> Dict[str, Any]:
    dt = getattr(torch, cfg.moment_dtype)
    return {
        "m": torch.zeros((seg_len,), dtype=dt, device=device),
        "v": torch.zeros((seg_len,), dtype=dt, device=device),
        "step": _host_step(),
    }


def apply_flat_update(p_seg, g_seg, state, cfg: OptConfig, gnorm
                      ) -> Tuple[torch.Tensor, Dict[str, Any], np.float32]:
    """AdamW on a flat slice; the clip uses the given global norm."""
    g = g_seg.float() * _clip_scale(gnorm, cfg.grad_clip)
    step = int(state["step"]) + 1
    lr = lr_at(cfg, step)
    bc1, bc2 = _bias_corrections(cfg, step)
    new_p, m, v = _adamw(p_seg, g, state["m"], state["v"], cfg, lr, bc1,
                         bc2)
    return new_p, {"m": m, "v": v, "step": state["step"] + 1}, lr
