"""Mixture-of-Experts FFN: shared + routed experts, top-k routing with
capacity, scatter/gather dispatch (the reference's ``models/moe.py``).

Three dispatch implementations (``MoEConfig.impl``, validated against
:data:`SUPPORTED_IMPLS`):

  * ``"gspmd"``: dispatch is a scatter/gather and a batched matmul over
    the expert dim (``torch.bmm``).
  * ``"grouped_local"``: the same math over ``dispatch_groups`` token
    groups, capacity per (group, expert) (see :func:`_moe_grouped`).
  * ``"shardmap_a2a"``: expert parallelism over the model axis of the
    :class:`~repro_torch.launch.mesh.Mesh` in scope. The tokens a model
    row holds are cut over it, each rank routes its piece, and the pieces
    cross the row to the ranks holding their experts through an
    all-to-all, raw or as QLC containers (the paper's technique on the
    routed-token wire). Routing and capacity drops are bit-identical to
    ``"gspmd"`` on the same tokens: each rank reconstructs the
    arrival-order positions from an int32 counts all-gather (see
    :func:`_moe_shardmap_a2a`).

Over a model row (``launch.mesh.ModelRow``) the leaves are this rank's
blocks as their resolved specs cut them (``convert.shard_params``): the
router by expert columns and each expert's weights by experts where the
experts divide the row, else the router whole and every expert's hidden
(``mlp``) dim split; the shared experts by their ``mlp`` dim. The gspmd
and grouped impls route with the whole router (gathered over the row,
so every rank routes alike, bit for bit as one rank does), run their
part of the experts, and sum the row once; see :func:`moe_block`.

A decode step over a row routes the step's ``B`` tokens, the same on
every rank, alike on every rank; ``shardmap_a2a`` cuts them over the row
as in training, and runs ``gspmd``'s dispatch where it cannot
(:func:`_uncut`: fewer tokens than ranks, as the engine's prefill of
one token of one sequence).

Where the reference's ``moe_block`` sees the whole batch (the baseline
step, jitted over the data axes), each port rank holds one shard of it:
under :func:`batch_over` the impls take their capacity from the global
token count and their positions from the same counts all-gather, so
every impl computes the reference's function.

The compressed wire is opened by binding ``moe/dispatch`` /
``moe/combine`` channels (:data:`MOE_DISPATCH` / :data:`MOE_COMBINE`,
calibrated by ``repro_torch.comm.calibrate.calibrate_moe_entries``) with
:func:`bind_moe_channels`. Without bound channels the all-to-all runs
uncompressed (``dist.all_to_all_single``). The bindings are read on the
caller's thread when the layer stack starts (:func:`moe_scope`) and
travel with it, so a layer recomputed by activation checkpointing (on
the autograd engine's thread) sees the same wire.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import types
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.launch.mesh import (copy_to_model, current_mesh,
                                     gather_from_model, model_row,
                                     reduce_from_model)
from repro_torch.models import layers

#: Registry / channel names of the expert-dispatch wire codecs.
MOE_DISPATCH = "moe/dispatch"
MOE_COMBINE = "moe/combine"

#: ``MoEConfig.impl`` values :func:`moe_block` accepts.
SUPPORTED_IMPLS = ("gspmd", "grouped_local", "shardmap_a2a")

#: the routed experts' leaves of an MoE FFN (leading dim: experts).
EXPERT_LEAVES = ("w_in", "w_gate", "w_out")

def _normal(gen, shape, scale, dtype, device):
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=device).mul_(scale)


def init_moe(generator: torch.Generator, cfg: ModelConfig, dtype,
             device="cuda", lead=(), keep=layers.keep_whole) -> Dict[str, Any]:
    """Random MoE FFN parameters from ``generator`` on ``device``, each
    leaf with the leading dims ``lead`` (the layer-group stack), passed
    through ``keep(path, leaf)`` as soon as it is drawn
    (``transformer.init_params``)."""
    m = cfg.moe
    d = cfg.d_model
    s_in = 1.0 / d ** 0.5
    s_out = 1.0 / m.d_expert ** 0.5
    lead = tuple(lead)
    p = {
        "router": keep(("router",), _normal(
            generator, lead + (d, m.num_experts), s_in, torch.float32,
            device)),
        "w_in": keep(("w_in",), _normal(
            generator, lead + (m.num_experts, d, m.d_expert), s_in, dtype,
            device)),
        "w_gate": keep(("w_gate",), _normal(
            generator, lead + (m.num_experts, d, m.d_expert), s_in, dtype,
            device)),
        "w_out": keep(("w_out",), _normal(
            generator, lead + (m.num_experts, m.d_expert, d), s_out, dtype,
            device)),
    }
    if m.num_shared_experts:
        ff = m.num_shared_experts * m.d_expert
        p["shared"] = {
            "w_in": keep(("shared", "w_in"), _normal(
                generator, lead + (d, ff), s_in, dtype, device)),
            "w_out": keep(("shared", "w_out"), _normal(
                generator, lead + (ff, d), 1.0 / ff ** 0.5, dtype, device)),
            "w_gate": keep(("shared", "w_gate"), _normal(
                generator, lead + (d, ff), s_in, dtype, device)),
        }
    return p


def moe_param_specs(cfg: ModelConfig):
    specs = {
        "router": ("embed", "expert"),
        "w_in": ("expert", "embed", "mlp"),
        "w_gate": ("expert", "embed", "mlp"),
        "w_out": ("expert", "mlp", "embed"),
    }
    if cfg.moe and cfg.moe.num_shared_experts:
        specs["shared"] = {"w_in": ("embed", "mlp"), "w_out": ("mlp", "embed"),
                           "w_gate": ("embed", "mlp")}
    return specs


# --------------------------------------------------------------------------
# Routing (ONE router matmul, shared by dispatch and the aux loss)
# --------------------------------------------------------------------------

def _router_weight(params, m: MoEConfig, row=None, summed: bool = False
                   ) -> torch.Tensor:
    """The whole router [D, E]: this rank's leaf, or, where the row splits
    it by expert columns, the row's blocks gathered. The gather's backward
    slices the cotangent, which is right where every rank of the row
    computes the same one; ``summed`` (each rank routes its own tokens)
    first sums it over the row."""
    r = params["router"]
    if row is None or r.shape[-1] == m.num_experts:
        return r
    r = gather_from_model(r, -1, row)
    return copy_to_model(r, row) if summed else r


def _router_logits(params, x_flat: torch.Tensor, m: MoEConfig, row=None,
                   summed: bool = False) -> torch.Tensor:
    """x_flat: [N, D] -> router logits [N, E] (f32), one einsum with the
    whole router (:func:`_router_weight`)."""
    return torch.einsum("nd,de->ne", x_flat.float(),
                        _router_weight(params, m, row, summed))


def _route(params, x_flat: torch.Tensor, m: MoEConfig, row=None,
           summed: bool = False):
    """x_flat: [N, D] -> (expert_idx [N,k], gates [N,k], probs [N,E]).

    The top-k is a stable descending sort: among equal logits the lower
    expert index comes first, as ``jax.lax.top_k`` orders them."""
    logits = _router_logits(params, x_flat, m, row, summed)
    srt, order = torch.sort(logits, dim=-1, descending=True, stable=True)
    top, idx = srt[:, :m.top_k], order[:, :m.top_k]
    gates = torch.softmax(top, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    return idx, gates, probs


def aux_load_balance_loss(probs: torch.Tensor, idx: torch.Tensor,
                          m: MoEConfig) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss from the routing
    artifacts of :func:`_route`."""
    onehot = F.one_hot(idx, m.num_experts).float().sum(1)
    frac_tokens = onehot.mean(0)
    frac_probs = probs.float().mean(0)
    return m.num_experts * torch.sum(frac_tokens * frac_probs)


# --------------------------------------------------------------------------
# Shared dispatch-plan / FFN helpers
# --------------------------------------------------------------------------

def _capacity(n_tokens: int, m: MoEConfig) -> int:
    """Static per-expert buffer capacity for ``n_tokens`` routed tokens."""
    return max(1, int(n_tokens * m.top_k * m.capacity_factor
                      // m.num_experts))


def _positions_in_expert(flat_e: torch.Tensor, num_experts: int
                         ) -> torch.Tensor:
    """Arrival-order position of each assignment within its expert
    (pre-capacity): ``flat_e [A]`` -> ``pos [A]`` (int64). Every impl
    derives its capacity drops from this one primitive."""
    onehot = F.one_hot(flat_e, num_experts)
    pos_in_e = torch.cumsum(onehot, dim=0) - onehot
    return torch.gather(pos_in_e, 1, flat_e[:, None])[:, 0]


def _expert_counts(flat_e: torch.Tensor, num_experts: int) -> torch.Tensor:
    """int32 [E]: assignments per expert."""
    return F.one_hot(flat_e, num_experts).sum(0).to(torch.int32)


def _gather_counts(counts: torch.Tensor, group) -> torch.Tensor:
    """int32 [R, E]: every rank's ``counts`` of ``group``, in rank order
    (no gradient; the values never cross)."""
    from repro_torch.comm.transport import all_gather_flat
    r = dist.get_world_size(group)
    if r == 1:
        return counts[None]
    out = torch.empty(r * counts.numel(), dtype=counts.dtype,
                      device=counts.device)
    all_gather_flat(out, counts.contiguous(), group=group)
    return out.reshape((r,) + tuple(counts.shape))


def global_positions(flat_e: torch.Tensor, num_experts: int, group):
    """Arrival-order positions of this rank's assignments in the batch
    made of the token shards of ``group``'s ranks in rank order:
    ``pos_local + offset``, the offset being the assignments to the same
    expert on lower ranks, from an int32 counts all-gather. Returns
    ``(pos_global [A], pos_local [A], counts [R, E], offsets [R, E])``;
    ``pos_global`` is what :func:`_positions_in_expert` gives on the
    whole batch."""
    pos_local = _positions_in_expert(flat_e, num_experts)
    g = _gather_counts(_expert_counts(flat_e, num_experts), group)
    offsets = torch.cumsum(g, dim=0, dtype=torch.int64) - g
    off_me = offsets[dist.get_rank(group)]
    return off_me[flat_e] + pos_local, pos_local, g, offsets


def _expert_ffn(buf: torch.Tensor, w_in, w_gate, w_out) -> torch.Tensor:
    """Row-wise swiglu expert FFN on a buffer ``[E, C, D]``. No biases,
    so all-zero rows (padding, other ranks' slots) map to exactly zero —
    the property the expert-parallel path relies on."""
    h = torch.bmm(buf, w_in.to(buf.dtype))
    g = torch.bmm(buf, w_gate.to(buf.dtype))
    h = F.silu(g) * h
    return torch.bmm(h, w_out.to(buf.dtype))


def _scatter_rows(src: torch.Tensor, slot: torch.Tensor, n_rows: int
                  ) -> torch.Tensor:
    """``zeros[n_rows, D].at[slot].set(src, mode="drop")``: slots equal
    to ``n_rows`` (the drop slot) are discarded. Kept slots are distinct,
    so each kept row is written once."""
    buf = src.new_zeros((n_rows + 1, src.shape[-1]))
    return buf.index_copy(0, slot, src)[:n_rows]


def _take_rows(rows: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """``rows[slot]`` where ``slot == len(rows)`` (the drop slot) reads a
    zero row: the reference's ``where(keep, take(...), 0)``."""
    pad = rows.new_zeros((1, rows.shape[-1]))
    return torch.cat([rows, pad])[slot]


def _sum_topk(weighted: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """``zeros[n, D].at[repeat(arange(n), k)].add(weighted)`` in the
    scatter's order, ``((0 + w_0) + w_1) + ...``: no atomics, so the
    same bits on every run and device."""
    w = weighted.reshape(n, k, -1)
    out = w.new_zeros((n, w.shape[-1]))
    for j in range(k):
        out = out + w[:, j]
    return out


def _repeat_tokens(x_flat: torch.Tensor, k: int) -> torch.Tensor:
    """``x_flat[repeat(arange(n), k)]`` as a view (its gradient sums the
    k copies without a scatter)."""
    n, d = x_flat.shape
    return x_flat[:, None].expand(n, k, d).reshape(n * k, d)


# --------------------------------------------------------------------------
# Channel binding, batch scope and traffic capture
# --------------------------------------------------------------------------

_MOE_CTX = threading.local()


@dataclasses.dataclass(frozen=True)
class MoEScope:
    """What an MoE layer reads besides its inputs, taken on the caller's
    thread (:func:`moe_scope`): the bound channels, the mesh in scope,
    the group whose ranks' token shards make the batch
    (:func:`batch_over`; None: this rank's tokens are the batch) and the
    capture and record lists."""
    channels: Optional[Dict[str, Any]] = None
    mesh: Any = None
    batch_group: Any = None
    capture: Optional[list] = None
    routing: Optional[list] = None
    wire: Optional[dict] = None


def moe_scope() -> MoEScope:
    """The MoE bindings of this thread."""
    return MoEScope(channels=getattr(_MOE_CTX, "channels", None),
                    mesh=current_mesh(),
                    batch_group=getattr(_MOE_CTX, "batch_group", None),
                    capture=getattr(_MOE_CTX, "capture", None),
                    routing=getattr(_MOE_CTX, "routing", None),
                    wire=getattr(_MOE_CTX, "wire", None))


@contextlib.contextmanager
def _bound(attr: str, value):
    old = getattr(_MOE_CTX, attr, None)
    setattr(_MOE_CTX, attr, value)
    try:
        yield value
    finally:
        setattr(_MOE_CTX, attr, old)


def bind_moe_channels(channels):
    """Bind the expert-dispatch wire channels for ``shardmap_a2a``:
    ``channels`` maps :data:`MOE_DISPATCH` / :data:`MOE_COMBINE` to
    :class:`~repro_torch.comm.channel.Channel` objects bound to the model
    axis (``None`` unbinds). Enter this around the forward and backward
    pass; the step builders in ``repro_torch.training.train_step`` do it
    for their ``moe_channels`` argument. ``AdaptiveChannel`` wrappers
    (:func:`adaptive_moe_channels`) work unchanged: each call reads the
    codec the wrapper holds at that moment."""
    return _bound("channels", channels)


def bound_moe_channels():
    """The currently bound ``{name: Channel}`` map, or ``None``."""
    return getattr(_MOE_CTX, "channels", None)


def adaptive_moe_channels(controller, channels):
    """Wrap a ``{name: Channel}`` expert-wire map for codec hot-swap.

    Each channel is registered with the
    :class:`repro_torch.adaptive.AdaptiveController` under its registry
    name (:data:`MOE_DISPATCH` / :data:`MOE_COMBINE`), so a
    drift-triggered ``register_revision`` rebinds the map in place; a
    step rebuilt afterwards (or any later call) puts the new codec on the
    wire."""
    return {name: controller.wrap(ch, name=name)
            for name, ch in channels.items()}


def batch_over(group):
    """Declare that the batch an MoE layer sees is the token shards of
    ``group``'s ranks, in rank order (the baseline step's global batch):
    capacity and arrival positions are then those of the whole batch."""
    return _bound("batch_group", group)


def capture_moe_traffic(out_list: list):
    """Capture each MoE layer's ``(params, x)`` at :func:`moe_block`
    entry into ``out_list``: the calibration hook
    ``repro_torch.comm.calibrate.calibrate_moe_entries`` uses to see the
    routed-token traffic."""
    return _bound("capture", out_list)


def capture_moe_routing(out_list: list):
    """Record each MoE layer's routing into ``out_list``: a dict with the
    ``impl``, this rank's ``idx`` [N, k] and ``keep`` [N * k] (the
    assignments that survive the capacity drop), in token order."""
    return _bound("routing", out_list)


def record_moe_wire(out: dict):
    """Record, per channel name, the last compressed all-to-all's
    payload: ``out[name] = (wire bytes, values)`` of this rank's send
    buffer (:meth:`Channel.all_to_all` with ``with_wire=True``)."""
    return _bound("wire", out)


def dispatch_traffic(params, x: torch.Tensor, cfg: ModelConfig):
    """The per-layer expert-wire traffic: ``(dispatch buffer [E, C, D],
    combine buffer [E, C, D])`` of one MoE layer on input ``x`` — the
    token values entering / leaving the expert all-to-all. The gspmd
    dispatch math on ``x`` as the whole batch; calibration input."""
    m = cfg.moe
    b, s, d = x.shape
    n = b * s
    x_flat = x.reshape(n, d)
    idx, _gates, _probs = _route(params, x_flat, m)
    capacity = _capacity(n, m)
    flat_e = idx.reshape(-1)
    pos = _positions_in_expert(flat_e, m.num_experts)
    keep = pos < capacity
    slot = torch.where(keep, flat_e * capacity
                       + torch.clamp(pos, max=capacity - 1),
                       m.num_experts * capacity)
    buf = _scatter_rows(_repeat_tokens(x_flat, m.top_k), slot,
                        m.num_experts * capacity)
    buf = buf.reshape(m.num_experts, capacity, d)
    out_e = _expert_ffn(buf, params["w_in"], params["w_gate"],
                        params["w_out"])
    return buf, out_e


# --------------------------------------------------------------------------
# Dispatch implementations
# --------------------------------------------------------------------------

def _expert_split(params, m: MoEConfig, row) -> Optional[str]:
    """How the routed experts' leaves are cut over ``row``: ``"expert"``
    (this rank's block of whole experts), ``"mlp"`` (every expert, its
    block of the hidden dim) or None (whole)."""
    if row is None:
        return None
    w = params["w_in"]
    if w.shape[-3] != m.num_experts:
        return "expert"
    return "mlp" if w.shape[-1] != m.d_expert else None


def _experts_over_row(buf: torch.Tensor, params, split: Optional[str],
                      row) -> torch.Tensor:
    """``buf [E, C, D]`` -> the expert outputs ``[E, C, D]``: whole, or
    this rank's part of them, which the row sums: its experts' rows
    (zeros for the others') under ``"expert"``, every expert's partial
    sum over its hidden block under ``"mlp"``."""
    w_in, w_gate, w_out = params["w_in"], params["w_gate"], params["w_out"]
    if split != "expert":
        return _expert_ffn(buf, w_in, w_gate, w_out)
    el = w_in.shape[-3]
    lo = row.index * el
    out = _expert_ffn(buf[lo:lo + el], w_in, w_gate, w_out)
    return F.pad(out, (0, 0, 0, 0, lo, buf.shape[0] - lo - el))


def _finish(params, x: torch.Tensor, m: MoEConfig, routed: torch.Tensor,
            partial: bool, row) -> torch.Tensor:
    """The routed output ``routed [N, D]`` (this rank's part, which the
    row sums, when ``partial``) plus the shared experts' (``mlp``-split
    over the row when their leaves are), the row summed once."""
    n, d = routed.shape
    shared, sh_partial = None, False
    if m.num_shared_experts:
        sh = params["shared"]
        sh_partial = row is not None and \
            sh["w_out"].shape[-2] != m.num_shared_experts * m.d_expert
        shared = layers.mlp(sh, x, "swiglu", row if sh_partial else None,
                            reduce=False).reshape(n, d)
    if partial and sh_partial:
        return reduce_from_model(routed + shared, row)
    if partial:
        routed = reduce_from_model(routed, row)
    elif sh_partial:
        shared = reduce_from_model(shared, row)
    return routed if shared is None else routed + shared


def _world(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _uncut(x: torch.Tensor, scope: MoEScope) -> bool:
    """Whether ``shardmap_a2a`` meets a row's tokens it cannot cut into
    one piece a rank: a serving step of fewer tokens than the model row
    has ranks, or not a multiple of them (the engine's prefill feeds one
    token of one sequence at a time). The layer then runs ``gspmd``'s
    dispatch over the row, the same function on the same tokens
    (``shardmap_a2a``'s routing and drops are ``gspmd``'s): its ranks'
    expert blocks on every token, summed over the row."""
    mesh = scope.mesh
    return (mesh is not None and scope.batch_group is None
            and x.shape[0] * x.shape[1] % mesh.model != 0)


def moe_block(params, x: torch.Tensor, cfg: ModelConfig,
              scope: Optional[MoEScope] = None, row=None) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D]. Capacity-bounded top-k dispatch.
    ``scope``: the bindings to use (default: this thread's); ``row``: the
    model row the leaves may be split over (default: the mesh's in
    scope, ``launch.mesh.model_row``).

    Over a row, ``x`` is the same on every rank. ``gspmd`` and
    ``grouped_local`` route every token with the whole router on every
    rank, each rank runs its part of the experts (:func:`_expert_split`)
    on the same dispatch buffer, and the gate-weighted combine of its
    part is summed over the row with the shared experts' part in one
    all-reduce. The gates enter the combine through ``copy_to_model``:
    their cotangent, each rank's part of it, is summed, so the router's
    backward is the same on every rank (and a whole router's gradient
    stays bit-identical over the row). The row's partial sums add a
    token's top-k outputs in another order than one rank does (each
    rank's own experts first); the per-assignment rows could be summed
    over the row first to keep one rank's order exactly, at ``top_k``
    times the all-reduce's bytes: not done, the order moves the output
    within f32 rounding."""
    impl = cfg.moe.impl
    if impl not in SUPPORTED_IMPLS:
        raise ValueError(
            f"unknown MoEConfig.impl {impl!r}; supported impls are "
            f"{SUPPORTED_IMPLS}")
    scope = moe_scope() if scope is None else scope
    if row is None:
        row = model_row(scope.mesh)
    if scope.capture is not None:
        scope.capture.append((params, x))
    if impl == "grouped_local":
        return _moe_grouped(params, x, cfg, scope, row)
    if impl == "shardmap_a2a" and not _uncut(x, scope):
        return _moe_shardmap_a2a(params, x, cfg, scope, row)
    m = cfg.moe
    b, s, d = x.shape
    n = b * s
    x_flat = x.reshape(n, d)
    split = _expert_split(params, m, row)

    idx, gates, _probs = _route(params, x_flat, m, row)  # [N,k], [N,k]
    flat_e = idx.reshape(-1)                            # [N*k]
    group = scope.batch_group
    capacity = _capacity(n * _world(group), m)
    if _world(group) > 1:
        pos = global_positions(flat_e, m.num_experts, group)[0]
    else:
        pos = _positions_in_expert(flat_e, m.num_experts)
    keep = pos < capacity
    slot = flat_e * capacity + torch.clamp(pos, max=capacity - 1)
    slot = torch.where(keep, slot, m.num_experts * capacity)  # drop slot
    if scope.routing is not None:
        scope.routing.append({"impl": impl, "idx": idx, "keep": keep})

    if split:
        x_flat, gates = copy_to_model(x_flat, row), copy_to_model(gates, row)
    buf = _scatter_rows(_repeat_tokens(x_flat, m.top_k), slot,
                        m.num_experts * capacity)
    out_e = _experts_over_row(buf.reshape(m.num_experts, capacity, d),
                              params, split, row)
    gathered = _take_rows(out_e.reshape(m.num_experts * capacity, d), slot)
    weighted = gathered * gates.reshape(-1)[:, None].to(x.dtype)
    out = _sum_topk(weighted, n, m.top_k)
    return _finish(params, x, m, out, split is not None, row).reshape(b, s, d)


def _moe_grouped(params, x: torch.Tensor, cfg: ModelConfig,
                 scope: MoEScope, row) -> torch.Tensor:
    """Grouped-local dispatch: tokens split into ``dispatch_groups``
    contiguous groups, capacity per (group, expert), scatters and
    gathers inside a group. Under :func:`batch_over` the groups are
    those of the whole batch: this rank's tokens are the batch's
    ``[r * n_local, (r + 1) * n_local)``, and it takes part in the groups
    they touch. A group may straddle ranks: an assignment's position in
    its group is its exclusive count among this rank's assignments of
    the same group and expert plus those of lower ranks, from one int32
    all-gather of the ``[groups, experts]`` counts (the per-group form of
    :func:`global_positions`; none where every rank holds whole groups),
    so the kept assignments are those of the whole batch's groups. The
    expert FFN runs on this rank's rows of each touched group's buffer
    (zero rows elsewhere), as ``gspmd`` does under :func:`batch_over`.
    Over a model row as :func:`moe_block`."""
    m = cfg.moe
    b, s, d = x.shape
    n_local = b * s
    group = scope.batch_group
    ranks = _world(group)
    n = n_local * ranks
    g = min(m.dispatch_groups, n)
    while n % g:
        g -= 1
    ng = n // g
    lo = (dist.get_rank(group) if ranks > 1 else 0) * n_local
    j0 = lo // ng                                   # first touched group
    t = (lo + n_local - 1) // ng - j0 + 1           # groups touched
    x_flat = x.reshape(n_local, d)
    e, k = m.num_experts, m.top_k
    split = _expert_split(params, m, row)

    idx, gates, _probs = _route(params, x_flat, m, row)  # [N,k]
    capacity = _capacity(ng, m)
    flat_e = idx.reshape(-1)
    # each assignment's touched group, in token order
    tg = ((lo + torch.arange(n_local, device=x.device)) // ng
          - j0).repeat_interleave(k)
    # per-expert running counts, less those before each group's first
    # assignment here: positions within (group, expert)
    onehot = F.one_hot(flat_e, e)
    incl = torch.cumsum(onehot, dim=0)
    edges = [min(max(0, (j0 + i) * ng - lo), n_local) * k
             for i in range(t + 1)]
    at_edge = torch.cat([incl.new_zeros((1, e)), incl])[edges]  # [t+1, E]
    pos = (torch.gather(incl - onehot, 1, flat_e[:, None])[:, 0]
           - at_edge[:-1][tg, flat_e])
    if n_local % ng:                                    # groups straddle
        counts = torch.zeros((g, e), dtype=torch.int32, device=x.device)
        counts[j0:j0 + t] = (at_edge[1:] - at_edge[:-1]).to(torch.int32)
        every = _gather_counts(counts.reshape(-1), group).reshape(
            ranks, g, e)
        below = every[:dist.get_rank(group)].sum(0, dtype=torch.int64)
        pos = pos + below[j0:j0 + t][tg, flat_e]
    keep = pos < capacity
    slot = flat_e * capacity + torch.clamp(pos, max=capacity - 1)
    slot = torch.where(keep, slot, e * capacity)
    if scope.routing is not None:
        scope.routing.append({"impl": "grouped_local", "idx": idx,
                              "keep": keep})
    if split:
        x_flat, gates = copy_to_model(x_flat, row), copy_to_model(gates, row)
    # One buffer of t blocks of E*C rows and a drop row each.
    at = tg * (e * capacity + 1) + slot
    bufs = _scatter_rows(_repeat_tokens(x_flat, k), at,
                         t * (e * capacity + 1))
    bufs = bufs.reshape(t, e * capacity + 1, d)[:, :e * capacity]
    # [t, E, C, D] -> [E, t*C, D]: one matmul per expert over every group.
    per_e = bufs.reshape(t, e, capacity, d).transpose(0, 1).reshape(
        e, t * capacity, d)
    out_e = _experts_over_row(per_e, params, split, row)
    out_e = out_e.reshape(e, t, capacity, d).transpose(0, 1).reshape(
        t, e * capacity, d)
    gathered = torch.cat([out_e, out_e.new_zeros((t, 1, d))], dim=1)
    gathered = gathered.reshape(-1, d)[at]
    weighted = gathered * gates.reshape(-1)[:, None].to(x.dtype)
    out = _sum_topk(weighted, n_local, k)
    return _finish(params, x, m, out, split is not None,
                   row).reshape(b, s, d)


# --------------------------------------------------------------------------
# Expert-parallel all-to-all dispatch
# --------------------------------------------------------------------------

def shardmap_a2a_geometry(cfg: ModelConfig, n_tokens: int, mesh) -> dict:
    """Static per-rank a2a payload geometry of one MoE layer.

    Returns ``{"ng", "capacity", "c_send", "row_values", "axis_size"}``:
    each rank's all-to-all moves ``axis_size`` rows of ``row_values``
    values (per direction, per layer) for ``ng`` local tokens of the
    ``n_tokens`` of the whole batch.
    """
    m = cfg.moe
    dm = int(mesh.shape["model"])
    dp = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            dp *= int(mesh.shape[a])
    shards = dp * dm
    if n_tokens % shards:
        raise ValueError(
            f"shardmap_a2a needs the token count ({n_tokens}) divisible "
            f"by the token shards (dp*model = {shards})")
    if m.num_experts % dm:
        raise ValueError(
            f"shardmap_a2a needs num_experts ({m.num_experts}) divisible "
            f"by the model axis ({dm})")
    ng = n_tokens // shards
    capacity = _capacity(n_tokens, m)
    # top_k experts are distinct per token, so a rank sends at most
    # min(ng, capacity) rows to any one expert — the static send bound.
    c_send = min(ng, capacity)
    return {"ng": ng, "capacity": capacity, "c_send": c_send,
            "row_values": (m.num_experts // dm) * c_send * cfg.d_model,
            "axis_size": dm}


def row_geometry(cfg: ModelConfig, n_row: int, pieces: int, model: int
                 ) -> dict:
    """:func:`shardmap_a2a_geometry` of a layer whose model row holds
    ``n_row`` tokens, cut into ``model`` pieces, in a batch of ``pieces``
    pieces (``model`` of them: the compressed step's, the row's shard;
    the world's: the baseline step's whole batch)."""
    return shardmap_a2a_geometry(
        cfg, n_row * pieces // model, types.SimpleNamespace(
            axis_names=("data", "model"),
            shape={"data": pieces // model, "model": model}))


def _all_to_all(v: torch.Tensor, group) -> torch.Tensor:
    """Row j of ``v [d, ...]`` to rank j of ``group``; row j of the
    result from rank j."""
    v = v.contiguous()
    out = torch.empty_like(v)
    dist.all_to_all_single(out, v, group=group)
    return out


class _RawA2A(torch.autograd.Function):
    """The raw all-to-all over a group; it is its own transpose."""

    @staticmethod
    def forward(ctx, v, group):
        ctx.group = group
        return _all_to_all(v, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _ChannelA2A(torch.autograd.Function):
    """The compressed all-to-all, straight-through: forward moves the
    values as QLC containers (``Channel.all_to_all``: K1 encode, K2
    decode on the card), lossless on the e4m3 symbols; the encode has no
    gradient, so the backward moves the cotangent through the raw
    all-to-all (the reference's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, v, ch, name, wire):
        ctx.group = ch.group
        vals, _ok, nbytes = ch.all_to_all(v, with_wire=True)
        if wire is not None:
            wire[name] = (nbytes, v.numel())
        return vals.to(v.dtype)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None, None, None


def _a2a(scope: MoEScope, name: str, group):
    if scope.channels is None:
        return lambda v: _RawA2A.apply(v, group)
    ch = scope.channels[name]
    return lambda v: _ChannelA2A.apply(v, ch, name, scope.wire)


def _moe_shardmap_a2a(params, x: torch.Tensor, cfg: ModelConfig,
                      scope: MoEScope, row) -> torch.Tensor:
    """Expert-parallel dispatch over the mesh in scope.

    ``x`` is what this rank's model row holds (the same on each of its
    ``dm`` ranks): its ``n`` tokens are cut into ``dm`` contiguous pieces
    and rank ``m`` of the row takes piece ``m``, as the reference's
    ``token_axes`` cut the tokens with the model axis innermost. Its
    ``w_in``/``w_gate``/``w_out`` are the ``el`` experts of its model
    index; the router, split by expert columns like them, is gathered
    over the row (the reference's ``in_specs`` replicate it). The batch
    is the pieces of the row, or under :func:`batch_over` (the baseline
    step, the data column declared) the pieces of every row, in world
    rank order. Per rank:

    1. route the local ``ng`` tokens;
    2. all-gather the per-expert assignment COUNTS (int32) over the
       batch's pieces and prefix-sum them: ``offset[e] + pos_local`` is
       gspmd's position on the same batch, so ``keep = pos_global <
       capacity`` reproduces its capacity drops bit for bit, and each
       rank's kept assignments are a prefix of its local arrival order,
       so send slots pack contiguously;
    3. all-to-all the packed ``[dm, el, c_send, D]`` send buffer over the
       model row — raw, or as QLC containers through the bound channels;
    4. scatter the received rows at their global positions (disjoint
       across sources), run the local experts' FFN (zero rows stay
       zero), gather the same positions back and reverse the all-to-all;
    5. combine with the gate weights on the local tokens, and gather the
       row's pieces back into the ``n`` tokens; the shared experts run on
       ``x`` as in :func:`moe_block`.
    """
    m = cfg.moe
    mesh = scope.mesh
    if mesh is None or "model" not in getattr(mesh, "axis_names", ()):
        raise ValueError(
            "moe.impl='shardmap_a2a' needs a mesh with a 'model' axis in "
            "scope (repro_torch.launch.mesh.use_mesh)")
    b, s, d = x.shape
    n = b * s
    dm = mesh.model
    pieces = mesh.world_group if scope.batch_group is not None \
        else mesh.model_group
    n_pieces = _world(pieces)
    geo = row_geometry(cfg, n, n_pieces, dm)
    ng, capacity, c_send = geo["ng"], geo["capacity"], geo["c_send"]
    e, k = m.num_experts, m.top_k
    el = e // dm                                   # local experts
    dispatch_a2a = _a2a(scope, MOE_DISPATCH, mesh.model_group)
    combine_a2a = _a2a(scope, MOE_COMBINE, mesh.model_group)

    x_flat = x.reshape(n, d)
    xl = x_flat
    if dm > 1:   # each rank's piece: the row sums the input's cotangent
        xl = copy_to_model(x_flat, row).narrow(0, row.index * ng, ng)
    idx, gates, _probs = _route(params, xl, m, row, summed=True)
    flat_e = idx.reshape(-1)                       # [ng*k]
    pos_global, pos_local, g, offsets = global_positions(flat_e, e, pieces)
    keep = pos_global < capacity
    if scope.routing is not None:
        scope.routing.append({"impl": "shardmap_a2a", "idx": idx,
                              "keep": keep})

    # Pack kept assignments: their local positions are a prefix per
    # expert, so pos_local IS the send slot.
    slot = flat_e * c_send + torch.clamp(pos_local, max=c_send - 1)
    slot = torch.where(keep, slot, e * c_send)
    sbuf = _scatter_rows(_repeat_tokens(xl, k), slot, e * c_send)
    recv = dispatch_a2a(sbuf.reshape(dm, el, c_send, d))

    # Each source's global positions for MY experts, from the counts
    # gather (my model-row peers are the pieces [base, base + dm)).
    me = dist.get_rank(pieces)
    base, my_model = (me // dm) * dm, me % dm
    off_grp = offsets[base:base + dm, my_model * el:(my_model + 1) * el]
    cnt_grp = g[base:base + dm, my_model * el:(my_model + 1) * el]
    kept_grp = torch.minimum(torch.clamp(capacity - off_grp, min=0),
                             cnt_grp.long())
    s_idx = torch.arange(c_send, device=x.device)[None, None, :]
    valid = s_idx < kept_grp[:, :, None]           # [dm, el, c_send]
    e_idx = torch.arange(el, device=x.device)[None, :, None]
    rpos = torch.where(valid, e_idx * capacity + off_grp[:, :, None] + s_idx,
                       el * capacity).reshape(-1)  # drop slot
    rbuf = _scatter_rows(recv.reshape(-1, d).to(x.dtype), rpos,
                         el * capacity)
    out_local = _expert_ffn(rbuf.reshape(el, capacity, d), params["w_in"],
                            params["w_gate"], params["w_out"])

    # Gather the same positions back and reverse the exchange.
    gathered = _take_rows(out_local.reshape(el * capacity, d), rpos)
    back = combine_a2a(gathered.reshape(dm, el, c_send, d))
    comb = _take_rows(back.reshape(e * c_send, d).to(x.dtype), slot)
    weighted = comb * gates.reshape(-1)[:, None].to(x.dtype)
    out = gather_from_model(_sum_topk(weighted, ng, k), 0, row)
    return _finish(params, x, m, out, False, row).reshape(b, s, d)
