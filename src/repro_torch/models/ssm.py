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

Tensor parallelism (training and decode): given a
``launch.mesh.ModelRow``, each
block takes its leaves as their resolved specs cut them
(:func:`mamba_param_specs`, :func:`xlstm_param_specs`) and finds which
are split from their shapes. The xLSTM blocks split on ``heads``: each
rank runs its heads' projections, gates and recurrence (all per head),
and ``wo``'s partial sums are summed over the row. Mamba splits on its
``mlp`` channels (``d_inner``): ``conv_w``, ``dt_proj``, ``A_log`` and
``D`` per channel, ``x_proj`` on its input rows, so its ``[dt | B | C]``
output is a partial sum that the row sums (and whose cotangent, each
rank's part from its own channels, the row sums back), ``out_proj`` on
its rows, summed likewise. ``in_proj`` is one ``[d, 2 d_inner]`` leaf
read as ``xi | z``, so its contiguous block on rank 0 of a row of 2 is
all of ``xi`` and on rank 1 all of ``z``; the block keeps the spec's cut
(the flat ZeRO-1 vectors follow it) and exchanges activations instead:
each rank's ``xz`` block is all-gathered over the row and each takes its
own channels of both halves. The exchange moves ``B S 2 d_inner`` values
in the compute dtype, where gathering the weight would move ``d 2
d_inner`` in f32: fewer bytes for a data shard of fewer than ``2 d``
tokens (jamba at 4 x 512: 2048 tokens against d 8192). Decode over a
row carries each rank's part of the state: mamba's ``ssm`` / ``conv`` of
its channels, an xLSTM block's of its heads (the ``"mlp"`` and
``"heads"`` dims of ``models.transformer.decode_states_specs``).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import (copy_to_model, gather_from_model,
                                     reduce_from_model)
from repro_torch.models import layers

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
               lead=(), keep=layers.keep_whole) -> Dict[str, Any]:
    """Random Mamba parameters from ``gen``, each leaf with the leading
    dims ``lead`` (the layer-group stack), passed through ``keep(path,
    leaf)`` as soon as it is made (``transformer.init_params``). ``A_log``
    and ``D`` are f32 whatever ``dtype`` is, as in the reference."""
    d = cfg.d_model
    di, dtr = mamba_dims(cfg)
    n, k = cfg.ssm_state_dim, cfg.conv_kernel
    lead = tuple(lead)
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=device))
    return {
        "in_proj": keep(("in_proj",), _normal(
            gen, lead + (d, 2 * di), d ** -0.5, dtype, device)),
        "conv_w": keep(("conv_w",), _normal(gen, lead + (k, di), k ** -0.5,
                                            dtype, device)),
        "x_proj": keep(("x_proj",), _normal(
            gen, lead + (di, dtr + 2 * n), di ** -0.5, dtype, device)),
        "dt_proj": keep(("dt_proj",), _normal(
            gen, lead + (dtr, di), dtr ** -0.5, dtype, device)),
        "A_log": keep(("A_log",), a_log.expand(lead + (di, n)).clone()),
        "D": keep(("D",), torch.ones(lead + (di,), dtype=torch.float32,
                                     device=device)),
        "out_proj": keep(("out_proj",), _normal(
            gen, lead + (di, d), di ** -0.5, dtype, device)),
    }


def mamba_block(params, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[MambaState] = None, row=None):
    """x: [B, S, D]. Returns (out [B, S, D], new state or None). With
    ``state`` the recurrence continues from it (one token per decode
    step, or a segment). ``row``: the model row the leaves may be split
    over (module docstring)."""
    b, s, d = x.shape
    di, dtr = mamba_dims(cfg)
    n, k = cfg.ssm_state_dim, cfg.conv_kernel
    in_split = row is not None and params["in_proj"].shape[-1] != 2 * di
    ch_split = row is not None and params["conv_w"].shape[-1] != di

    xz = torch.einsum("bsd,de->bse", copy_to_model(x, row) if in_split
                      else x, params["in_proj"].to(x.dtype))
    lo, dl = 0, di
    if in_split:        # xi | z: gather the row's blocks, keep my channels
        xz = copy_to_model(gather_from_model(xz, -1, row), row)
        if ch_split:
            dl = di // row.size
            lo = row.index * dl
    xi, z = xz[..., lo:lo + dl], xz[..., di + lo:di + lo + dl]

    # Depthwise causal conv along time.
    if state is None:
        xc = torch.cat([torch.zeros((b, k - 1, dl), dtype=xi.dtype,
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
    if ch_split:        # my channels' part; each rank's cotangent summed
        proj = copy_to_model(reduce_from_model(proj, row), row)
    dt_in, bmat, cmat = (proj[..., :dtr], proj[..., dtr:dtr + n],
                         proj[..., dtr + n:])
    dt_proj = params["dt_proj"]
    dt = _softplus(torch.einsum("bsr,re->bse", _promote(dt_in, dt_proj),
                                _promote(dt_proj, dt_in))).float()
    a = -torch.exp(params["A_log"])                    # [di, N]
    bmat, cmat, uf = bmat.float(), cmat.float(), u.float()

    da = torch.exp(dt[..., None] * a[None, None])      # [B, S, di, N]
    dbu = dt[..., None] * bmat[:, :, None, :] * uf[..., None]

    h = state.ssm if state is not None else _zeros(x, (b, dl, n))
    ys = []
    for t in range(s):
        h = h * da[:, t] + dbu[:, t]                   # [B, di, N]
        ys.append(torch.einsum("bdn,bn->bd", h, cmat[:, t]))
    y = torch.stack(ys, dim=1)                         # [B, S, di]
    y = y + uf * params["D"][None, None]
    y = y.to(x.dtype) * F.silu(z)
    out = torch.einsum("bse,ed->bsd", y, params["out_proj"].to(y.dtype))
    if ch_split:
        out = reduce_from_model(out, row)
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
                    lead=(), keep=layers.keep_whole) -> Dict[str, Any]:
    """Random xLSTM block parameters, each leaf with the leading dims
    ``lead``, passed through ``keep(path, leaf)`` as soon as it is made.
    The gate projections are f32 whatever ``dtype`` is. ``wo`` is drawn
    from the same normals as ``wq`` (reshaped, scaled by
    ``1/sqrt(h * hd)``): the reference draws both from one key."""
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    lead = tuple(lead)
    s = 1.0 / d ** 0.5
    so = 1.0 / (h * hd) ** 0.5
    zq = torch.randn(lead + (d, h, hd), generator=gen, dtype=dtype,
                     device=device)
    p = {"wq": keep(("wq",), zq * s)}
    for name in ("wk", "wv"):
        p[name] = keep((name,), _normal(gen, lead + (d, h, hd), s, dtype,
                                        device))
    for name in ("w_if", "w_ff", "w_of"):
        p[name] = keep((name,), _normal(gen, lead + (d, h), s,
                                        torch.float32, device))
    p["wo"] = keep(("wo",), zq.reshape(lead + (h, hd, d)) * so)
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


def _heads_split(params, x, cfg: ModelConfig, row):
    """An xLSTM block's heads here and its input: over a row that splits
    the heads, this rank's heads and ``x`` through ``copy_to_model``
    (its projections are this rank's part of the input's gradient)."""
    h = params["wq"].shape[-2]
    if row is None or h == cfg.num_heads:
        return h, x, None
    return h, copy_to_model(x, row), row


def mlstm_block(params, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[MLSTMState] = None, row=None):
    """mLSTM: matrix-memory LSTM with exponential gating (xLSTM §2.3).
    ``row``: the model row the heads may be split over (module
    docstring)."""
    b, s, d = x.shape
    hd = cfg.resolved_head_dim
    h, x, row = _heads_split(params, x, cfg, row)

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
    out = reduce_from_model(out, row)
    return out, (MLSTMState(c, nrm, m) if state is not None else None)


def mlstm_init_state(like: torch.Tensor, b: int,
                     cfg: ModelConfig) -> MLSTMState:
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    return MLSTMState(c=_zeros(like, (b, h, hd, hd)),
                      n=_zeros(like, (b, h, hd)), m=_zeros(like, (b, h)))


def slstm_block(params, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[SLSTMState] = None, row=None):
    """sLSTM: scalar-memory LSTM with exponential gating (xLSTM §2.2),
    the reference's simplified form: recurrence on the cell state only
    (no hidden-to-gate recurrent weights). ``row`` as
    :func:`mlstm_block`."""
    b, s, d = x.shape
    hd = cfg.resolved_head_dim
    h, x, row = _heads_split(params, x, cfg, row)

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
    out = reduce_from_model(out, row)
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
