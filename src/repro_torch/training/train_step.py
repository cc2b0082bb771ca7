"""Train steps over ``torch.distributed`` process groups.

Two implementations, as in the reference:

* **baseline** — each rank computes the gradients of its slice of the
  global batch; a dense f32 all-reduce averages them across ranks (none
  with one rank); AdamW on the whole parameter tree. Over a
  ``launch.mesh.Mesh`` (``data x model``) with a model axis above 1 the
  model is tensor-parallel, whatever its blocks: each rank holds its
  local tree (``convert.shard_params``), the batch is split over the
  data axis (a model row shares its shard; ``shardmap_a2a`` cuts it
  over the row inside each MoE layer), gradients are averaged over the
  data column, and the clip norm sums the split leaves' squares over the
  model row and counts the replicated ones once. Under rules that cut
  parameters by FSDP (``parallel.sharding.make_rules()``) the step is
  ZeRO-3: each rank holds its ``data x model`` block of every FSDP leaf,
  a layer group's blocks are gathered over the data column as it runs
  (``models.apply_stack``), their gradients come back reduce-scattered,
  and the clip norm sums each leaf's squares over the ranks that split
  it.

* **compressed** — the paper's technique: each rank flattens its local
  gradients, a QLC-compressed reduce-scatter (K1 encode, then K2
  decode and accumulate) leaves it its segment of the summed flat
  gradient, the mean and the exact global gradient norm follow, a ZeRO-1
  AdamW updates the rank's segment of the flat parameter vector, and a
  compressed all-gather (K1, then K2) brings every rank the updated
  parameters. The wire is lossless relative to the e4m3-quantized
  values; if an escape pool overflows (``ok`` False) the trainer redoes
  the step through the baseline step (:func:`make_zero1_fallback`).

Flat vectors follow the reference's pytree order (dict keys sorted), so
a ZeRO-1 state moves between the packages element for element. Over a
``data x model`` mesh the compressed step is the reference's stage 2:
rank ``(d, m)`` flattens its local tree (the leaves' local blocks, each
row-major) into its model index's flat vector, the wire runs over its
data column, and its ZeRO-1 state is the ``[d, m]`` row of the
reference's ``[data, model, seg]`` state. The global norm weighs each
entry as the reference's ``weight_vec`` does (1 on a split leaf,
``1 / model`` on a replicated one, 0 on the padding; :func:`weight_vec`)
and sums over the world. Every block kind runs tensor-parallel there:
attention and dense FFNs, MoE FFNs under each dispatch impl, and the
recurrent blocks (``models.moe``, ``models.ssm``).

Where the reference's MoE layers see the whole batch (its baseline step,
jitted over the data axes), the baseline step declares the batch's ranks
(``moe.batch_over``: the data column), and each rank's MoE layers take
their capacity and arrival positions from the whole batch; the
compressed step's stage 1 sees the data shard in the reference, and the
row's shard here.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.comm.channel import Channel, ChannelSpec
from repro_torch.comm.compressed import CommConfig
from repro_torch.comm.transport import all_gather_flat
from repro_torch.configs.base import ModelConfig
from repro_torch.core.registry import CodecRegistry
from repro_torch.launch.mesh import current_mesh, use_mesh
from repro_torch.models import moe, next_token_loss
from repro_torch.models.transformer import (leaf_grads, pytree_leaves,
                                            pytree_unflatten, tree_map)
from repro_torch.parallel import sharding
from repro_torch.training import optimizer as opt

GRAD_TYPE = "grads"      # registry key for the gradient reduce-scatter
PARAM_TYPE = "params"    # registry key for the parameter all-gather

_NO_PODS = ("the pod axis and the hierarchical wire are not ported: "
            "ROADMAP queue 1, item 13")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The reference's ``comm_mode`` is the choice of step builder here,
    and its ``batch_axes`` the process group."""
    microbatches: int = 1


def _world(group) -> Tuple[int, int]:
    return dist.get_world_size(group), dist.get_rank(group)


def local_batch(batch: Dict[str, Any], group, device,
                n_micro: int = 1) -> Dict[str, Any]:
    """This rank's rows of a global batch, as tensors on ``device``: its
    contiguous slice (as the reference shards the batch's first dim over
    its data axes; over a mesh ``group`` is its world, so rank-major).
    With ``n_micro > 1`` the global batch is first cut into ``n_micro``
    contiguous microbatches, as the reference's baseline step cuts it,
    and the rank's rows are its slice of each, in microbatch order, so
    that cutting them into ``n_micro`` contiguous runs gives the rank's
    shard of every global microbatch."""
    d, r = _world(group)
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if t.shape[0] % (d * n_micro):
            raise ValueError(f"global batch {t.shape[0]} not divisible by "
                             f"{n_micro} microbatches over {d} ranks")
        n = t.shape[0] // (d * n_micro)
        rows = t.reshape((n_micro, d, n) + tuple(t.shape[1:]))[:, r]
        out[k] = rows.reshape((n_micro * n,) + tuple(t.shape[1:])).to(device)
    return out


def _value_and_grad(params, model_cfg: ModelConfig, batch):
    live = [p.detach().requires_grad_(True) for p in pytree_leaves(params)]
    loss = next_token_loss(pytree_unflatten(params, live), model_cfg,
                           batch["tokens"], batch["labels"],
                           batch.get("prefix_emb"))
    return loss.detach(), pytree_unflatten(params, leaf_grads(loss, live))


def _microbatched_grads(params, model_cfg: ModelConfig, batch,
                        n_micro: int):
    """Gradient accumulation over ``n_micro`` microbatches (f32 sums,
    then times 1/n_micro, as the reference's scan)."""
    if n_micro == 1:
        return _value_and_grad(params, model_cfg, batch)
    b = next(iter(batch.values())).shape[0]
    if b % n_micro:
        raise ValueError(f"local batch {b} not divisible by {n_micro} "
                         "microbatches")
    n = b // n_micro
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
    loss_acc = torch.zeros((), dtype=torch.float32,
                           device=pytree_leaves(params)[0].device)
    for i in range(n_micro):
        mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
        loss, g = _value_and_grad(params, model_cfg, mb)
        acc = tree_map(lambda a, x: a + x.float(), acc, g)
        loss_acc = loss_acc + loss
    inv = 1.0 / n_micro
    return loss_acc * inv, tree_map(lambda g: g * inv, acc)


def _mean_over(t: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``, divided by the group's size."""
    d, _ = _world(group)
    if d > 1:
        t = t.clone()
        dist.all_reduce(t, group=group)
        t = t / d
    return t


@contextlib.contextmanager
def _moe_bindings(mesh, moe_channels, batch_group=None):
    """The MoE layers' bindings around a forward and backward pass."""
    with use_mesh(mesh), moe.bind_moe_channels(moe_channels), \
            moe.batch_over(batch_group):
        yield


def _step_mesh(model_cfg: ModelConfig, mesh):
    """The mesh a step runs over: ``mesh``, else the one in scope. An
    expert-parallel MoE needs one whose model axis divides its experts
    (the reference's ``shardmap_a2a_geometry`` refuses the others)."""
    mesh = current_mesh() if mesh is None else mesh
    m = model_cfg.moe
    if m is None or m.impl != "shardmap_a2a":
        return mesh
    if mesh is None:
        raise ValueError("moe.impl='shardmap_a2a' needs a mesh with a "
                         "'model' axis (mesh=..., or launch.mesh.use_mesh "
                         "around the step's construction)")
    if m.num_experts % mesh.model:
        raise ValueError(
            f"shardmap_a2a needs num_experts ({m.num_experts}) divisible "
            f"by the model axis ({mesh.model})")
    return mesh


# --------------------------------------------------------------------------
# Baseline step
# --------------------------------------------------------------------------

def _leaf_axes(model_cfg: ModelConfig, mesh) -> List[Tuple[str, ...]]:
    """Per parameter leaf in pytree order: the mesh axes above 1 that
    split it under the rules in scope (``"data"`` for an FSDP dim,
    ``"model"`` for a model dim), in mesh order."""
    return [tuple(axis for axis, d in zip(("data", "model"), dims)
                  if d is not None)
            for dims in pytree_leaves(sharding.leaf_dims(
                model_cfg, mesh.data, mesh.model, split=True))]


def _tp_mesh(mesh) -> bool:
    """Whether a step over ``mesh`` runs tensor-parallel."""
    return mesh is not None and mesh.model > 1


def make_baseline_step(model_cfg: ModelConfig, opt_cfg: opt.OptConfig,
                       train_cfg: TrainConfig, *, group=None, mesh=None,
                       moe_channels=None) -> Callable:
    """``train_step(params, opt_state, batch)`` with a dense f32 gradient
    all-reduce. ``batch`` is the global batch (numpy or tensors).

    Over ``group`` (default: the default process group) every leaf is
    averaged over the group. Over ``mesh`` (default: the mesh in scope,
    if any) with a model axis above 1, the model runs tensor-parallel on
    this rank's local tree (``params`` and the state cut by
    ``convert.shard_params``), the batch split over the data axis (see
    the module docstring for the gradients and the clip norm). Over a
    mesh the batch's ranks are its data column. ``moe_channels``
    (``{moe.MOE_DISPATCH: Channel, moe.MOE_COMBINE: Channel}`` on the
    model axis) puts the expert all-to-all on the compressed wire; the
    gradient wire stays dense. MoE layers see the whole batch, as in the
    reference. With ``train_cfg.microbatches > 1`` microbatch *i* on a
    rank is its shard of the global batch's microbatch *i*, as the
    reference splits it (:func:`local_batch`).

    The step runs under the sharding rules in scope at its construction.
    Where they cut parameters by FSDP (``parallel.sharding.make_rules()``)
    over a mesh, the step is ZeRO-3: ``params`` and the state hold each
    FSDP leaf as the rank's ``data x model`` block (``convert.
    shard_params`` with the data cut), each layer group's blocks are
    gathered over the data column as it runs and again in the backward
    pass (``models.apply_stack``), an FSDP leaf's gradient arrives
    reduce-scattered and averaged over the column from the gathers'
    backward, the other leaves' are averaged over the column as without
    FSDP, and the clip norm sums each leaf's squares over the ranks that
    split it (``optimizer.split_global_norm``)."""
    mesh = _step_mesh(model_cfg, mesh)
    rules = sharding.get_rules()
    tp = _tp_mesh(mesh)
    if mesh is not None:
        group = mesh.world_group
    group = dist.group.WORLD if group is None else group
    batch_group = mesh.data_group if mesh is not None else group
    fsdp = mesh is not None and sharding.fsdp_params(rules)
    axes = (_leaf_axes(model_cfg, mesh) if tp or fsdp else None)
    gathered = None
    if fsdp:
        gathered = [d is not None for d in pytree_leaves(
            sharding.fsdp_dims(model_cfg, mesh))]
    split_norm = tp or (axes is not None and any(axes))

    def reduce_grads(grads):
        """Mean gradient tree and, with leaves split over the mesh, the
        global norm of it (else None: the tree's own)."""
        if axes is not None:
            leaves = [g.float() if gathered is not None and gathered[i]
                      else _mean_over(g.float(), mesh.data_group)
                      for i, g in enumerate(pytree_leaves(grads))]
            return (pytree_unflatten(grads, leaves),
                    opt.split_global_norm(leaves, axes, mesh)
                    if split_norm else None)
        return tree_map(lambda g: _mean_over(g.float(), group), grads), None

    def train_step(params, opt_state, batch):
        dev = pytree_leaves(params)[0].device
        with _moe_bindings(mesh, moe_channels, batch_group), \
                sharding.use_rules(rules):
            loss, grads = _microbatched_grads(
                params, model_cfg,
                local_batch(batch, batch_group, dev,
                            train_cfg.microbatches),
                train_cfg.microbatches)
        grads, gnorm = reduce_grads(grads)
        new_params, new_state, info = opt.apply_update(
            params, grads, opt_state, opt_cfg, gnorm=gnorm)
        metrics = {"loss": _mean_over(loss, batch_group),
                   "ok": torch.ones((), dtype=torch.bool, device=dev),
                   **info}
        return new_params, new_state, metrics

    return train_step


# --------------------------------------------------------------------------
# Compressed step
# --------------------------------------------------------------------------

def step_channels(codec, comm_cfg: CommConfig = None, *, group=None,
                  transport=None, transport_model=None,
                  grad_key: str = GRAD_TYPE, param_key: str = PARAM_TYPE
                  ) -> Tuple[Channel, Channel, CommConfig]:
    """Open the compressed step's two channels over ``group``: the
    gradient reduce-scatter and the parameter all-gather.

    ``codec`` is a bare ``CodecTables`` (with ``comm_cfg``) or a
    ``CodecRegistry`` holding ``grad_key`` and optionally ``param_key``
    (default: the grad entry); ``comm_cfg`` then overrides the non-plan
    knobs (``enabled``, ``use_kernels``, ``scale_dtype``). ``transport``
    is ``None`` (one-shot), a ``TransportConfig`` or str for both, or a
    dict with ``grad_key`` / ``param_key`` entries. Returns
    ``(rs_channel, ag_channel, rs_cfg)`` (the reference returns one map
    per data-parallel mesh axis; here there is one group)."""
    group = dist.group.WORLD if group is None else group
    if isinstance(transport, dict):
        rs_t, ag_t = transport.get(grad_key), transport.get(param_key)
    else:
        rs_t = ag_t = transport
    if isinstance(codec, CodecRegistry):
        g = codec.get(grad_key)
        if g is None:
            raise KeyError(f"registry has no {grad_key!r} entry; have "
                           f"{codec.names()}")
        p = codec.get(param_key, default=g)
        overrides = {}
        if comm_cfg is not None:
            overrides = dict(enabled=comm_cfg.enabled,
                             use_kernels=comm_cfg.use_kernels,
                             scale_dtype=comm_cfg.scale_dtype)
        rs_codec, ag_codec = g, p
        rs_cfg, ag_cfg = g.config(**overrides), p.config(**overrides)
        registry = codec
    else:
        if comm_cfg is None:
            raise TypeError("bare CodecTables needs an explicit CommConfig")
        rs_codec = ag_codec = codec
        rs_cfg = ag_cfg = comm_cfg
        registry = None
    if rs_cfg.chunk_symbols != ag_cfg.chunk_symbols:
        raise ValueError("grad and param codecs must share chunk_symbols, "
                         f"got {rs_cfg.chunk_symbols} vs "
                         f"{ag_cfg.chunk_symbols}")
    rs = Channel(ChannelSpec(codec=rs_codec, cfg=rs_cfg, transport=rs_t,
                             group=group), registry=registry,
                 model=transport_model)
    ag = Channel(ChannelSpec(codec=ag_codec, cfg=ag_cfg, transport=ag_t,
                             group=group), registry=registry,
                 model=transport_model)
    return rs, ag, rs_cfg


class FlatGeometry(NamedTuple):
    """The flat parameter vector of one model rank: ``n_local`` real
    entries (its local leaves), padded to ``n_padded`` (a multiple of
    data ranks x chunk), ``seg`` per data rank; ``runs``: ``(length,
    weight)`` of consecutive real entries that the global norm weighs
    alike (:func:`weight_vec`)."""
    n_local: int
    n_padded: int
    seg: int
    runs: Tuple[Tuple[int, float], ...]


def flat_geometry(params, group_size: int, comm_cfg: CommConfig,
                  model_cfg: ModelConfig = None, mesh=None) -> FlatGeometry:
    """The reference's ``flat_geometry`` for ``params``, this rank's local
    tree, over ``group_size`` data ranks. With ``model_cfg`` and a
    ``mesh``, a leaf replicated over its model axis weighs ``1 / model``;
    else every real entry weighs 1."""
    sizes = [p.numel() for p in pytree_leaves(params)]
    n_local = sum(sizes)
    unit = group_size * comm_cfg.chunk_symbols
    n_padded = -(-n_local // unit) * unit
    if mesh is None or model_cfg is None:
        runs = ((n_local, 1.0),)
    else:
        specs = pytree_leaves(sharding.param_pspecs(model_cfg, mesh))
        merged: List[List] = []
        for n, spec in zip(sizes, specs):
            w = 1.0 / sharding.replication_factor(spec, mesh)
            if merged and merged[-1][1] == w:
                merged[-1][0] += n
            else:
                merged.append([n, w])
        runs = tuple((n, w) for n, w in merged)
    return FlatGeometry(n_local, n_padded, n_padded // group_size, runs)


def weight_vec(geom: FlatGeometry):
    """The reference's ``weight_vec``: f32 numpy [n_padded], each real
    entry's weight in the global norm, 0 on the padding."""
    return np.concatenate(
        [np.full(n, w, np.float32) for n, w in geom.runs]
        + [np.zeros(geom.n_padded - geom.n_local, np.float32)])


def _weighted_squares(seg: torch.Tensor, geom: FlatGeometry, start: int
                      ) -> torch.Tensor:
    """f64 sum over ``seg``, the flat entries ``[start, start + len)``, of
    each real entry's weight times its square."""
    if len(geom.runs) == 1 and geom.runs[0][1] == 1.0:
        return opt.sum_of_squares(seg)
    total = torch.zeros((), dtype=torch.float64, device=seg.device)
    off = 0
    for n, w in geom.runs:
        lo, hi = max(off, start), min(off + n, start + seg.numel())
        if lo < hi:
            total = total + w * opt.sum_of_squares(seg[lo - start:hi - start])
        off += n
    return total


def _flatten_local(tree, n_padded: int) -> torch.Tensor:
    """Leaves in pytree order -> one f32 vector, zero-padded to
    ``n_padded``."""
    leaves = pytree_leaves(tree)
    out = torch.zeros(n_padded, dtype=torch.float32,
                      device=leaves[0].device)
    off = 0
    for leaf in leaves:
        n = leaf.numel()
        out[off:off + n] = leaf.reshape(-1)
        off += n
    return out


def _flat_slice(tree, start: int, length: int) -> torch.Tensor:
    """``_flatten_local(tree, ...)[start:start + length]`` without the
    whole vector."""
    leaves = pytree_leaves(tree)
    out = torch.zeros(length, dtype=torch.float32, device=leaves[0].device)
    off = 0
    for leaf in leaves:
        n = leaf.numel()
        lo, hi = max(off, start), min(off + n, start + length)
        if lo < hi:
            out[lo - start:hi - start] = leaf.reshape(-1)[lo - off:hi - off]
        off += n
    return out


def _unflatten_local(flat: torch.Tensor, like) -> Any:
    """Inverse of :func:`_flatten_local`: leaves shaped and typed like
    ``like``'s."""
    out: List[torch.Tensor] = []
    off = 0
    for leaf in pytree_leaves(like):
        n = leaf.numel()
        out.append(flat[off:off + n].reshape(leaf.shape).to(leaf.dtype))
        off += n
    return pytree_unflatten(like, out)


def _all_ok(ok: torch.Tensor, group) -> torch.Tensor:
    """True on every rank iff ``ok`` is True on every rank."""
    bad = (~ok).to(torch.int32).reshape(1)
    dist.all_reduce(bad, group=group)
    return bad[0] == 0


def _group_telemetry(ghist, phist, ok_rs, ok_ag, group) -> Dict[str, Any]:
    """The telemetry metrics of one step, summed over ``group`` in one
    int32 all-reduce: both wires' symbol histograms and the number of
    ranks whose reduce-scatter / all-gather escape pool overflowed."""
    flags = torch.stack([~ok_rs, ~ok_ag]).to(torch.int32)
    buf = torch.cat([ghist.to(torch.int32), phist.to(torch.int32), flags])
    dist.all_reduce(buf, group=group)
    return {"adapt/grads_hist": buf[:256], "adapt/params_hist": buf[256:512],
            "adapt/grads_overflow": buf[512], "adapt/params_overflow":
            buf[513]}


def make_compressed_step(model_cfg: ModelConfig, opt_cfg: opt.OptConfig,
                         train_cfg: TrainConfig, group, tables,
                         comm_cfg: CommConfig = None, *,
                         grad_key: str = GRAD_TYPE,
                         param_key: str = PARAM_TYPE,
                         transport=None, transport_model=None,
                         hierarchical_wire: bool = False,
                         moe_channels=None, mesh=None,
                         telemetry: bool = False) -> Callable:
    """``train_step(params, flat_opt_state, batch)`` for compressed mode
    over ``group`` (``None``: the default group), the data-parallel
    group.

    Over ``mesh`` (default: the one in scope) with a model axis above 1,
    the model runs the reference's 2-D step, whatever its blocks:
    ``params`` is this rank's local tree (``convert.shard_params``), the
    wire runs over its data column (``mesh.data_group``, which replaces
    ``group``), the batch is split over the data axis, and
    ``flat_opt_state`` is this rank's ``[seg]`` of the ``[data, model,
    seg]`` state (:func:`init_compressed_opt_state` over the data
    column). MoE layers dispatch the row's data shard (the reference's
    stage 1 sees the data shard): ``gspmd`` and ``grouped_local`` on
    every rank of the row, ``shardmap_a2a`` cut over the row, its
    all-to-all on ``moe_channels`` when given.

    ``tables`` is a ``CodecTables`` (with ``comm_cfg``) or a
    ``CodecRegistry`` (``grad_key`` codec on the reduce-scatter,
    ``param_key`` on the all-gather); ``transport`` as in
    :func:`step_channels`. The returned function carries ``stage1``
    (``(params, batch) -> (loss, grads)``, the rank's gradients),
    ``stage2`` (``(params, grads, flat_opt) -> (params, flat_opt,
    metrics)``, the wire and the update), ``channels`` (the RS and AG
    channels), ``group`` (theirs) and ``geometry``.

    ``telemetry=True`` adds the symbol histograms of the gradient and
    parameter wires, summed over every rank, to the metrics
    (``"adapt/grads_hist"`` / ``"adapt/params_hist"``, int32 [256]; K1
    counts them beside its encode, ``emit_hist``), and the number of
    ranks whose escape pool overflowed on each wire
    (``"adapt/grads_overflow"`` / ``"adapt/params_overflow"``): the
    inputs of ``repro_torch.adaptive.TrainingAdapter``. The payloads are
    untouched, so a telemetry step is bit-identical to a plain one.

    Its parameters are cut over the model axis alone, whatever the rules
    in scope (``parallel.sharding.tp_only``: the reference's compressed
    step resolves them without its FSDP overrides)."""
    if hierarchical_wire:
        raise NotImplementedError(_NO_PODS)
    rules = sharding.tp_only(sharding.get_rules())
    mesh = _step_mesh(model_cfg, mesh)
    tp = _tp_mesh(mesh)
    group = mesh.data_group if tp else (
        dist.group.WORLD if group is None else group)
    world_group = mesh.world_group if tp else group
    rs_ch, ag_ch, rs_cfg = step_channels(
        tables, comm_cfg, group=group, transport=transport,
        transport_model=transport_model, grad_key=grad_key,
        param_key=param_key)
    d, rank = _world(group)
    geom: Dict[str, FlatGeometry] = {}

    def geometry(params) -> FlatGeometry:
        if "g" not in geom:
            geom["g"] = flat_geometry(params, d, rs_cfg, model_cfg,
                                      mesh if tp else None)
        return geom["g"]

    def stage1(params, batch):
        # The reference's stage 1 cuts its microbatches from the rank's
        # own data shard, so here the shard comes first too.
        dev = pytree_leaves(params)[0].device
        with _moe_bindings(mesh, moe_channels), sharding.use_rules(rules):
            return _microbatched_grads(params, model_cfg,
                                       local_batch(batch, group, dev),
                                       train_cfg.microbatches)

    def stage2(params, grads, flat_opt):
        g = geometry(params)
        g_flat = _flatten_local(grads, g.n_padded)
        del grads
        if telemetry:
            r, ghist = rs_ch.reduce_scatter(g_flat, with_hist=True)
        else:
            r = rs_ch.reduce_scatter(g_flat)
        del g_flat
        valid, ok_rs = r.valid, r.ok
        seg = r.segment / d                              # mean over ranks
        del r
        sq = _weighted_squares(seg[:valid], g, rank * g.seg).reshape(1)
        dist.all_reduce(sq, group=world_group)
        gnorm = torch.sqrt(sq[0]).float()
        p_seg = _flat_slice(params, rank * g.seg, g.seg)
        new_seg, new_opt, lr = opt.apply_flat_update(p_seg, seg, flat_opt,
                                                     opt_cfg, gnorm)
        del seg, p_seg
        metrics = {"grad_norm": gnorm, "lr": lr}
        if telemetry:
            full, ok_ag, phist = ag_ch.all_gather(new_seg, with_hist=True)
            metrics.update(_group_telemetry(ghist, phist, ok_rs, ok_ag,
                                            world_group))
            ok = (metrics["adapt/grads_overflow"]
                  + metrics["adapt/params_overflow"]) == 0
        else:
            full, ok_ag = ag_ch.all_gather(new_seg)
            ok = _all_ok(ok_rs & ok_ag, world_group)
        new_params = _unflatten_local(full, params)
        return new_params, new_opt, {"ok": ok, **metrics}

    def train_step(params, flat_opt, batch):
        loss, grads = stage1(params, batch)
        new_params, new_opt, metrics = stage2(params, grads, flat_opt)
        return new_params, new_opt, {"loss": _mean_over(loss, group),
                                     **metrics}

    train_step.stage1 = stage1
    train_step.stage2 = stage2
    train_step.channels = (rs_ch, ag_ch)
    train_step.group = group
    train_step.geometry = geometry
    return train_step


def init_compressed_opt_state(params, group, comm_cfg,
                              opt_cfg: opt.OptConfig) -> Dict[str, Any]:
    """This rank's ZeRO-1 state: ``m``, ``v`` of its segment and
    ``step``. ``comm_cfg``: a ``CommConfig`` or the ``CodecRegistry``
    given to :func:`make_compressed_step` (geometry from its grad
    entry). Over a ``data x model`` mesh, ``params`` is the rank's local
    tree and ``group`` its data column (``mesh.data_group``): the state
    is then its ``[seg]`` of the reference's ``[data, model, seg]``."""
    group = dist.group.WORLD if group is None else group
    if isinstance(comm_cfg, CodecRegistry):
        comm_cfg = comm_cfg[GRAD_TYPE].config()
    g = flat_geometry(params, dist.get_world_size(group), comm_cfg)
    return opt.init_flat_state(g.seg, opt_cfg,
                               pytree_leaves(params)[0].device)


def make_zero1_fallback(baseline_step: Callable, compressed_step: Callable,
                        group=None) -> Callable:
    """The trainer's retry for a compressed step whose wire overflowed:
    the baseline step on the ZeRO-1 state. Each rank's ``m``/``v``
    segments are all-gathered (dense f32) over ``group`` (default: the
    compressed step's, its data column over a mesh) into trees, the
    baseline step runs, and each rank keeps its segment of the new
    moments. ``baseline_step`` is built under TP-only rules
    (``parallel.sharding.tp_only``), the compressed step's layout."""
    group = compressed_step.group if group is None else group
    d, rank = _world(group)

    def gather(seg: torch.Tensor) -> torch.Tensor:
        if d == 1:
            return seg
        full = torch.empty(d * seg.numel(), dtype=seg.dtype,
                           device=seg.device)
        all_gather_flat(full, seg.contiguous(), group=group)
        return full

    def step(params, flat_opt, batch):
        g = compressed_step.geometry(params)
        tree_state = {k: tree_map(lambda t: t.to(flat_opt[k].dtype),
                                  _unflatten_local(gather(flat_opt[k]),
                                                   params))
                      for k in ("m", "v")}
        tree_state["step"] = flat_opt["step"]
        new_params, new_state, metrics = baseline_step(params, tree_state,
                                                       batch)
        new_flat = {k: _flat_slice(new_state[k], rank * g.seg, g.seg).to(
            flat_opt[k].dtype) for k in ("m", "v")}
        new_flat["step"] = new_state["step"]
        return new_params, new_flat, metrics

    return step
