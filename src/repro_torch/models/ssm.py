"""State-space and recurrent blocks: Mamba (jamba), sLSTM and mLSTM
(xLSTM).

Same math, parameter layout and op order as the reference package's
``models/ssm.py``. The time recurrence is a plain Python loop over the
sequence with the body of the reference's ``lax.scan``; decode is one
step of it from a carried state. The reference runs no Pallas kernel
here, so neither does the port: a chunk-parallel form of the recurrence
is a performance option, not a port of a kernel.

States are ``NamedTuple`` s of f32 tensors (:data:`STATE_TYPES`); the
paged serving cache moves them whole (:func:`state_snapshot`,
:func:`state_restore`).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def _normal(gen, shape, scale, dtype, device):
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=device).mul_(scale)


def _zeros(like: torch.Tensor, shape) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=like.device)


def _promote(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` in the dtype JAX would promote ``a`` and ``b`` to."""
    return a.to(torch.promote_types(a.dtype, b.dtype))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


# ==========================================================================
# Mamba (selective SSM, mamba-1 style)
# ==========================================================================

class MambaState(NamedTuple):
    ssm: torch.Tensor    # [B, d_inner, N] running SSM state
    conv: torch.Tensor   # [B, K-1, d_inner] conv tail


def mamba_dims(cfg: ModelConfig) -> Tuple[int, int]:
    d_inner = 2 * cfg.d_model
    dt_rank = max(1, cfg.d_model // 16)
    return d_inner, dt_rank


def mamba_param_specs():
    return {
        "in_proj": ("embed", "mlp"),
        "conv_w": ("conv", "mlp"),
        "x_proj": ("mlp", None),
        "dt_proj": (None, "mlp"),
        "A_log": ("mlp", "state"),
        "D": ("mlp",),
        "out_proj": ("mlp", "embed"),
    }


def xlstm_param_specs():
    return {
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "heads", "head_dim"),
        "wv": ("embed", "heads", "head_dim"),
        "w_if": ("embed", "heads"),
        "w_ff": ("embed", "heads"),
        "w_of": ("embed", "heads"),
        "wo": ("heads", "head_dim", "embed"),
    }


def init_mamba(gen: torch.Generator, cfg: ModelConfig, dtype, device,
               lead=()) -> Dict[str, Any]:
    """Random Mamba parameters from ``gen``, each leaf with the leading
    dims ``lead`` (the layer-group stack). ``A_log`` and ``D`` are f32
    whatever ``dtype`` is, as in the reference."""
    d = cfg.d_model
    di, dtr = mamba_dims(cfg)
    n, k = cfg.ssm_state_dim, cfg.conv_kernel
    lead = tuple(lead)
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=device))
    return {
        "in_proj": _normal(gen, lead + (d, 2 * di), d ** -0.5, dtype,
                           device),
        "conv_w": _normal(gen, lead + (k, di), k ** -0.5, dtype, device),
        "x_proj": _normal(gen, lead + (di, dtr + 2 * n), di ** -0.5, dtype,
                          device),
        "dt_proj": _normal(gen, lead + (dtr, di), dtr ** -0.5, dtype,
                           device),
        "A_log": a_log.expand(lead + (di, n)).clone(),
        "D": torch.ones(lead + (di,), dtype=torch.float32, device=device),
        "out_proj": _normal(gen, lead + (di, d), di ** -0.5, dtype, device),
    }


def mamba_block(params, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[MambaState] = None):
    """x: [B, S, D]. Returns (out [B, S, D], new state or None). With
    ``state`` the recurrence continues from it (one token per decode
    step, or a segment)."""
    b, s, d = x.shape
    di, dtr = mamba_dims(cfg)
    n, k = cfg.ssm_state_dim, cfg.conv_kernel

    xz = torch.einsum("bsd,de->bse", x, params["in_proj"].to(x.dtype))
    xi, z = xz[..., :di], xz[..., di:]

    # Depthwise causal conv along time.
    if state is None:
        xc = torch.cat([torch.zeros((b, k - 1, di), dtype=xi.dtype,
                                    device=xi.device), xi], dim=1)
        new_conv_tail = None
    else:
        xc = torch.cat([state.conv.to(xi.dtype), xi], dim=1)
        new_conv_tail = xc[:, -(k - 1):].float()
    conv = sum(xc[:, i:i + s] * params["conv_w"][i][None, None].to(xc.dtype)
               for i in range(k))
    u = F.silu(conv)                                   # [B, S, di]

    # Input-dependent SSM parameters.
    proj = torch.einsum("bse,ec->bsc", u, params["x_proj"].to(u.dtype))
    dt_in, bmat, cmat = (proj[..., :dtr], proj[..., dtr:dtr + n],
                         proj[..., dtr + n:])
    dt_proj = params["dt_proj"]
    dt = _softplus(torch.einsum("bsr,re->bse", _promote(dt_in, dt_proj),
                                _promote(dt_proj, dt_in))).float()
    a = -torch.exp(params["A_log"])                    # [di, N]
    bmat, cmat, uf = bmat.float(), cmat.float(), u.float()

    da = torch.exp(dt[..., None] * a[None, None])      # [B, S, di, N]
    dbu = dt[..., None] * bmat[:, :, None, :] * uf[..., None]

    h = state.ssm if state is not None else _zeros(x, (b, di, n))
    ys = []
    for t in range(s):
        h = h * da[:, t] + dbu[:, t]                   # [B, di, N]
        ys.append(torch.einsum("bdn,bn->bd", h, cmat[:, t]))
    y = torch.stack(ys, dim=1)                         # [B, S, di]
    y = y + uf * params["D"][None, None]
    y = y.to(x.dtype) * F.silu(z)
    out = torch.einsum("bse,ed->bsd", y, params["out_proj"].to(y.dtype))
    if state is None:
        return out, None
    return out, MambaState(ssm=h, conv=new_conv_tail)


def mamba_init_state(like: torch.Tensor, b: int,
                     cfg: ModelConfig) -> MambaState:
    di, _ = mamba_dims(cfg)
    return MambaState(ssm=_zeros(like, (b, di, cfg.ssm_state_dim)),
                      conv=_zeros(like, (b, cfg.conv_kernel - 1, di)))


# ==========================================================================
# xLSTM blocks
# ==========================================================================

class MLSTMState(NamedTuple):
    c: torch.Tensor   # [B, NH, HD, HD] matrix memory
    n: torch.Tensor   # [B, NH, HD] normalizer
    m: torch.Tensor   # [B, NH] log-scale stabilizer


class SLSTMState(NamedTuple):
    c: torch.Tensor   # [B, NH, HD] cell
    n: torch.Tensor   # [B, NH] normalizer, one per head
    m: torch.Tensor   # [B, NH] stabilizer


def _init_qkv_gates(gen: torch.Generator, cfg: ModelConfig, dtype, device,
                    lead=()) -> Dict[str, Any]:
    """Random xLSTM block parameters, each leaf with the leading dims
    ``lead``. The gate projections are f32 whatever ``dtype`` is. ``wo``
    is drawn from the same normals as ``wq`` (reshaped, scaled by
    ``1/sqrt(h * hd)``): the reference draws both from one key."""
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    lead = tuple(lead)
    s = 1.0 / d ** 0.5
    so = 1.0 / (h * hd) ** 0.5
    zq = torch.randn(lead + (d, h, hd), generator=gen, dtype=dtype,
                     device=device)
    p = {"wq": zq * s}
    for name in ("wk", "wv"):
        p[name] = _normal(gen, lead + (d, h, hd), s, dtype, device)
    for name in ("w_if", "w_ff", "w_of"):
        p[name] = _normal(gen, lead + (d, h), s, torch.float32, device)
    p["wo"] = zq.reshape(lead + (h, hd, d)) * so
    return p


init_mlstm = _init_qkv_gates
init_slstm = _init_qkv_gates


def _gates(params, x: torch.Tensor):
    """The input, forget (pre-activation) and output gates, in f32."""
    xf = x.float()
    i_pre = torch.einsum("bsd,dn->bsn", xf, params["w_if"])
    f_pre = torch.einsum("bsd,dn->bsn", xf, params["w_ff"])
    o_gate = torch.sigmoid(torch.einsum("bsd,dn->bsn", xf, params["w_of"]))
    return i_pre, f_pre, o_gate


def mlstm_block(params, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[MLSTMState] = None):
    """mLSTM: matrix-memory LSTM with exponential gating (xLSTM §2.3)."""
    b, s, d = x.shape
    h, hd = cfg.num_heads, cfg.resolved_head_dim

    q = torch.einsum("bsd,dnh->bsnh", x, params["wq"].to(x.dtype)) \
        * hd ** -0.5
    k = torch.einsum("bsd,dnh->bsnh", x, params["wk"].to(x.dtype)) \
        * hd ** -0.5
    v = torch.einsum("bsd,dnh->bsnh", x, params["wv"].to(x.dtype))
    i_pre, f_pre, o_gate = _gates(params, x)

    if state is None:
        c, nrm, m = (_zeros(x, (b, h, hd, hd)), _zeros(x, (b, h, hd)),
                     _zeros(x, (b, h)))
    else:
        c, nrm, m = state
    ys = []
    for t in range(s):
        qt, kt, vt = q[:, t], k[:, t], v[:, t]         # [B, NH, HD]
        it, ft = i_pre[:, t], f_pre[:, t]              # [B, NH]
        m_new = torch.maximum(ft + m, it)              # log-space stabilizer
        i_act = torch.exp(it - m_new)
        f_act = torch.exp(ft + m - m_new)
        # the outer product rounds in the compute dtype, then widens
        c = (f_act[..., None, None] * c
             + i_act[..., None, None]
             * (vt[..., :, None] * kt[..., None, :]).float())
        nrm = f_act[..., None] * nrm + i_act[..., None] * kt.float()
        qf = qt.float()
        y = torch.einsum("bnvk,bnk->bnv", c, qf)
        denom = torch.maximum(
            torch.abs(torch.einsum("bnk,bnk->bn", nrm, qf)),
            torch.exp(-m_new))
        ys.append(y / denom[..., None])
        m = m_new
    y = torch.stack(ys, dim=1)                         # [B, S, NH, HD]
    y = (y * o_gate[..., None]).to(x.dtype)
    out = torch.einsum("bsnh,nhd->bsd", y, params["wo"].to(y.dtype))
    return out, (MLSTMState(c, nrm, m) if state is not None else None)


def mlstm_init_state(like: torch.Tensor, b: int,
                     cfg: ModelConfig) -> MLSTMState:
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    return MLSTMState(c=_zeros(like, (b, h, hd, hd)),
                      n=_zeros(like, (b, h, hd)), m=_zeros(like, (b, h)))


def slstm_block(params, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[SLSTMState] = None):
    """sLSTM: scalar-memory LSTM with exponential gating (xLSTM §2.2),
    the reference's simplified form: recurrence on the cell state only
    (no hidden-to-gate recurrent weights)."""
    b, s, d = x.shape
    h, hd = cfg.num_heads, cfg.resolved_head_dim

    zt = torch.tanh(torch.einsum("bsd,dnh->bsnh", x,
                                 params["wq"].to(x.dtype)))
    i_pre, f_pre, o_gate = _gates(params, x)

    if state is None:
        c, nrm, m = (_zeros(x, (b, h, hd)), _zeros(x, (b, h)),
                     _zeros(x, (b, h)))
    else:
        c, nrm, m = state
    ys = []
    for t in range(s):
        it, ft = i_pre[:, t], f_pre[:, t]
        m_new = torch.maximum(ft + m, it)
        i_act = torch.exp(it - m_new)
        f_act = torch.exp(ft + m - m_new)
        c = f_act[..., None] * c + i_act[..., None] * zt[:, t].float()
        nrm = f_act * nrm + i_act
        ys.append(c / torch.clamp_min(nrm[..., None], 1e-6))
        m = m_new
    y = torch.stack(ys, dim=1)
    y = (y * o_gate[..., None]).to(x.dtype)
    out = torch.einsum("bsnh,nhd->bsd", y, params["wo"].to(y.dtype))
    return out, (SLSTMState(c, nrm, m) if state is not None else None)


def slstm_init_state(like: torch.Tensor, b: int,
                     cfg: ModelConfig) -> SLSTMState:
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    return SLSTMState(c=_zeros(like, (b, h, hd)), n=_zeros(like, (b, h)),
                      m=_zeros(like, (b, h)))


# ==========================================================================
# State snapshot seam (paged serving cache)
# ==========================================================================

#: the SSM decode states the paged cache can snapshot and restore.
STATE_TYPES = (MambaState, MLSTMState, SLSTMState)


def state_snapshot(state) -> Tuple[torch.Tensor, ...]:
    """An SSM decode state's tensors, in field order: what the paged
    serving cache (``repro_torch.serving.kv_cache``) encodes at a block
    boundary. There is no growing sequence dim: the whole carried state
    is the block."""
    if not isinstance(state, STATE_TYPES):
        raise TypeError(f"not an SSM decode state: {type(state).__name__}")
    return tuple(state)


def state_restore(state, arrays):
    """Rebuild a state from :func:`state_snapshot` tensors (the decoded
    wire form), in ``state``'s dtypes and shapes."""
    if not isinstance(state, STATE_TYPES):
        raise TypeError(f"not an SSM decode state: {type(state).__name__}")
    arrays = tuple(arrays)
    if len(arrays) != len(state):
        raise ValueError(f"{type(state).__name__} expects {len(state)} "
                         f"arrays, got {len(arrays)}")
    return type(state)(*(a.to(t.dtype).reshape(t.shape)
                         for a, t in zip(arrays, state)))
