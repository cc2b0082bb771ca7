"""Process groups and the 2-D rank layout: the port's counterpart of the
reference's ``("data", "model")`` device mesh (``repro.launch.mesh``,
``repro.parallel.sharding.use_mesh``).

The world is laid out as ``(data, model)`` with model innermost: world
rank ``r = d * model + m``, the order of the reference's
``Mesh(devices.reshape(dp, dm), ("data", "model"))``. :class:`Mesh`
carries both sizes and this rank's two process groups: its model row
(the ranks ``[d * model, (d + 1) * model)``) and its data column (the
ranks that share its model index). Over the model row every layer is
split as ``parallel.sharding``'s rules resolve its leaves (tensor
parallelism: heads, KV heads, ``mlp``, ``vocab``, and an MoE's experts,
with their all-to-all under ``shardmap_a2a``); over the data column the
batch and the compressed step's ZeRO-1 segments. The model-row
collectives inside autograd are :func:`copy_to_model`,
:func:`reduce_from_model` and :func:`gather_from_model`, each over a
:class:`ModelRow` that the layer stack reads once on the caller's thread
(:func:`model_row`), so a recomputed layer sees the same one. The
``"pod"`` axis for multi-node waits for ROADMAP queue 1, item 13.
:func:`use_mesh` puts a mesh in scope for the code that reads it
(:func:`current_mesh`). Host decisions that read rank-local numbers
are agreed over the mesh or one of its axes (:func:`mesh_max`,
:func:`mesh_all`), so that every rank takes the same branch. Under
sharding rules that put ``kv_seq`` on ``data``, ``model`` or both a
decode step's KV caches hold a range of positions on each rank of the
column, the row or the mesh (:func:`kv_seq_shard`).

NCCL on the card, a world of one included, with gloo beside it for CPU
tensors (backend ``"cpu:gloo,cuda:nccl"``: each collective goes to the
backend of its tensors' device, so one process can run a step on the
card and its CPU twin); gloo alone on the CPU. Nothing on
the machine tells a program of a cluster, so the caller gives the
rendezvous address (``tcp://localhost:<port>``), the world size and the
rank; :func:`free_port` finds a port on this host.
"""
from __future__ import annotations

import contextlib
import dataclasses
import socket
import threading
from typing import Any, Iterator, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

NO_PODS = "the pod axis is not ported: ROADMAP queue 1, item 13 (multi-node)"


#: Ports a one-rank world tries in turn when the one it chose was taken.
_PORT_ATTEMPTS = 5


def free_port() -> int:
    """A TCP port on localhost that is free right now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def backend_for(device) -> str:
    return ("cpu:gloo,cuda:nccl" if torch.device(device).type == "cuda"
            else "gloo")


def init_data_parallel(device, *, rank: int = 0, world_size: int = 1,
                       init_method: Optional[str] = None) -> bool:
    """Join (or create) the default process group for ``device``'s
    backend. Returns True when this call created it (the caller then
    tears it down), False when one was already initialized."""
    if dist.is_initialized():
        need = "nccl" if torch.device(device).type == "cuda" else "gloo"
        if need not in dist.get_backend():
            raise RuntimeError(f"a {dist.get_backend()} process group is "
                               f"initialized; {device} needs {need}")
        return False
    if world_size > 1 and init_method is None:
        raise ValueError("a world of several ranks needs their common "
                         "init_method (tcp://localhost:<port>)")
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else rank % torch.cuda.device_count())
    for attempt in range(_PORT_ATTEMPTS):
        try:
            dist.init_process_group(
                backend_for(dev),
                init_method=init_method or f"tcp://localhost:{free_port()}",
                world_size=world_size, rank=rank)
            return True
        except RuntimeError as e:
            # a port that was free when chosen can be taken by another
            # process before the store listens on it: choose again
            if init_method is not None or "EADDRINUSE" not in str(e) \
                    or attempt == _PORT_ATTEMPTS - 1:
                raise


def teardown_data_parallel():
    if dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def data_parallel(device, *, rank: int = 0, world_size: int = 1,
                  init_method: Optional[str] = None) -> Iterator[object]:
    """Context with the default process group up; yields it
    (``dist.group.WORLD``) and tears it down on exit if it created it."""
    created = init_data_parallel(device, rank=rank, world_size=world_size,
                                 init_method=init_method)
    try:
        yield dist.group.WORLD
    finally:
        if created:
            teardown_data_parallel()


# --------------------------------------------------------------------------
# The (data, model) layout
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``data x model`` layout of the world's ranks (model innermost)
    and this rank's place in it: ``rank`` is its world rank, and
    ``data_group`` / ``model_group`` the process groups of its data
    column and model row (``world_group`` holds every rank)."""
    data: int
    model: int
    rank: int
    world_group: Any
    data_group: Any
    model_group: Any

    axis_names: Tuple[str, ...] = ("data", "model")

    @property
    def shape(self) -> dict:
        """Axis sizes by name, as the reference's ``Mesh.shape``."""
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def coords(self) -> Tuple[int, int]:
        """This rank's ``(data, model)`` index."""
        return divmod(self.rank, self.model)

    def group(self, axis: str):
        """The process group of this rank along ``axis``."""
        if axis == "data":
            return self.data_group
        if axis == "model":
            return self.model_group
        if axis == "pod":
            raise NotImplementedError(NO_PODS)
        raise ValueError(f"unknown mesh axis {axis!r}; the port's mesh has "
                         f"{self.axis_names}")


def make_test_mesh(*, model: int = 2, pods: int = 1) -> Mesh:
    """The reference's small mesh over the ranks that exist:
    ``model = min(model, world)``, ``data = world // model``. Every rank
    of the default group calls this, since each creates every row's and
    column's process group, in the same order. A group that would hold
    every rank is the default group itself."""
    if int(pods) > 1:
        raise NotImplementedError(NO_PODS)
    group = dist.group.WORLD
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    model = max(1, min(int(model), world))
    data = world // model
    if data * model != world:
        raise ValueError(f"{world} ranks cannot be laid out as data x "
                         f"model = {data} x {model}")

    def subgroup(ranks):
        if len(ranks) == world:
            return group
        return dist.new_group(ranks)

    rows = [subgroup([d * model + m for m in range(model)])
            for d in range(data)]
    cols = [subgroup([d * model + m for d in range(data)])
            for m in range(model)]
    d_me, m_me = divmod(rank, model)
    return Mesh(data=data, model=model, rank=rank, world_group=group,
                data_group=cols[m_me], model_group=rows[d_me])


def make_production_mesh(*, multi_pod: bool = False,
                         pods: int = None) -> Mesh:
    """The reference's single-pod layout, 16 data x 16 model ranks (the
    world must hold 256); a pod axis is not ported."""
    if multi_pod or (pods is not None and int(pods) > 1):
        raise NotImplementedError(NO_PODS)
    world = dist.get_world_size()
    if world != 256:
        raise ValueError(f"the production layout needs 256 ranks, the "
                         f"world has {world}")
    return make_test_mesh(model=16)


_SCOPE = threading.local()


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """Put ``mesh`` in scope for this thread (:func:`current_mesh`)."""
    old = getattr(_SCOPE, "mesh", None)
    _SCOPE.mesh = mesh
    try:
        yield mesh
    finally:
        _SCOPE.mesh = old


def current_mesh() -> Optional[Mesh]:
    """The mesh :func:`use_mesh` put in scope on this thread, or None."""
    return getattr(_SCOPE, "mesh", None)


# --------------------------------------------------------------------------
# Model-row collectives inside autograd
# --------------------------------------------------------------------------

class ModelRow(NamedTuple):
    """This rank's model row: its process group, its size and this
    rank's index in it."""
    group: Any
    size: int
    index: int


def model_row(mesh: Optional[Mesh] = None) -> Optional[ModelRow]:
    """The model row of ``mesh`` (default: the mesh in scope) that the
    layers split over, or None: no mesh, or a model axis of 1."""
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None or mesh.model == 1:
        return None
    return ModelRow(mesh.model_group, mesh.model, mesh.coords[1])


# --------------------------------------------------------------------------
# FSDP: parameter blocks gathered over the data column
# --------------------------------------------------------------------------

class DataColumn(NamedTuple):
    """This rank's data column, over which FSDP parameter blocks are
    gathered: its process group, its size and this rank's index in it."""
    group: Any
    size: int
    index: int


def fsdp_column(mesh: Optional[Mesh] = None) -> Optional[DataColumn]:
    """The data column of ``mesh`` (default: the mesh in scope) that
    parameter blocks are gathered over, where the sharding rules in scope
    cut parameters by FSDP (``parallel.sharding.fsdp_params``), else
    None. A column of one is a column all the same: it gathers over one
    rank, on the same path."""
    from repro_torch.parallel.sharding import fsdp_params
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None or not fsdp_params():
        return None
    return DataColumn(mesh.data_group, mesh.data, mesh.coords[0])


#: FSDP collectives issued in this process since the last reset
#: (:func:`reset_fsdp_counts`): ``"gathers"`` (a leaf's blocks gathered
#: over the column, forward or again for the backward pass) and
#: ``"reduce_scatters"`` (a gathered leaf's gradient).
FSDP_COUNTS = {"gathers": 0, "reduce_scatters": 0}


def reset_fsdp_counts():
    for k in FSDP_COUNTS:
        FSDP_COUNTS[k] = 0


def gather_blocks(x: torch.Tensor, dim: int, col: DataColumn
                  ) -> torch.Tensor:
    """The column's blocks of ``x`` concatenated along ``dim`` in rank
    order, outside autograd (counted in :data:`FSDP_COUNTS`): one
    all-gather along dim 0, which is the result for ``dim`` 0 and is
    copied into it for another dim."""
    from repro_torch.comm.transport import all_gather_flat
    FSDP_COUNTS["gathers"] += 1
    x = x.contiguous()
    shape = list(x.shape)
    out = torch.empty([col.size * shape[0]] + shape[1:], dtype=x.dtype,
                      device=x.device)
    all_gather_flat(out, x, group=col.group)
    if dim == 0:
        return out
    shape[dim] *= col.size
    return out.view([col.size] + list(x.shape)).movedim(0, dim).reshape(
        shape)


#: ``reduce_scatter_tensor`` under the name newer releases give it.
_reduce_scatter_flat = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


class _GatherFromData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, col):
        ctx.dim, ctx.col = dim, col
        return gather_blocks(x, dim, col)

    @staticmethod
    def backward(ctx, g):
        FSDP_COUNTS["reduce_scatters"] += 1
        col, dim = ctx.col, ctx.dim
        full = g.movedim(dim, 0).contiguous()
        out = torch.empty((full.shape[0] // col.size,) + full.shape[1:],
                          dtype=full.dtype, device=full.device)
        _reduce_scatter_flat(out, full, group=col.group)
        if col.size > 1:
            out = out / col.size
        return out.movedim(0, dim).contiguous(), None, None


def gather_from_data(x: torch.Tensor, dim: int, col: Optional[DataColumn]
                     ) -> torch.Tensor:
    """The data column's blocks of a parameter concatenated along ``dim``
    in rank order forward; backward, the gradient reduce-scattered over
    the column and divided by its size (the mean over the batch's ranks,
    as the baseline step averages the other leaves), so this rank's
    block of the mean gradient. ``col`` None: ``x`` itself."""
    if col is None:
        return x
    return _GatherFromData.apply(x, dim % x.dim(), col)


# --------------------------------------------------------------------------
# The KV cache's sequence shard
# --------------------------------------------------------------------------

class SeqShard(NamedTuple):
    """This rank's shard of a KV cache's sequence, as the sharding rules
    in scope put ``kv_seq`` on the mesh: over ``"data"`` (the data
    column), ``"model"`` (the model row) or ``("data", "model")`` (every
    rank, in the PartitionSpec's row-major order: index ``d * model +
    m``). ``group`` holds the shard's ranks, ``size`` their number, and
    this rank's ``index`` holds positions ``[index * S, (index + 1) *
    S)`` of a cache of ``S`` local positions; ``axes`` are the mesh axes
    it spans. A shard over the model axis holds every KV head of its
    positions; one over the data column alone the heads its row's cut
    gives it."""
    group: Any
    size: int
    index: int
    axes: Tuple[str, ...] = ("data",)

    @property
    def over_model(self) -> bool:
        return "model" in self.axes


def kv_seq_shard(mesh: Optional[Mesh] = None) -> Optional[SeqShard]:
    """The sequence shard of a decode step's KV caches on ``mesh``
    (default: the mesh in scope), as the sharding rules in scope
    (``parallel.sharding.get_rules``) resolve ``kv_seq`` beside
    ``batch``, or None: no mesh, or ``kv_seq`` on no axis
    (``make_rules(decode_seq_shard=True)`` puts it on ``data``;
    ``parallel.sharding.decode_rules``, the reference's, on ``model`` or
    on ``("data", "model")``). Axes of size 1 give a shard of one rank,
    which runs the split decode and paging over its whole range."""
    from repro_torch.parallel.sharding import get_rules
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None:
        return None
    entry = get_rules().spec(("batch", "kv_seq"), mesh=mesh)[1]
    axes = () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))
    if not axes:
        return None
    d, m = mesh.coords
    if axes == ("data",):
        return SeqShard(mesh.data_group, mesh.data, d, axes)
    if axes == ("model",):
        return SeqShard(mesh.model_group, mesh.model, m, axes)
    if axes == ("data", "model"):
        return SeqShard(mesh.world_group, mesh.size, mesh.rank, axes)
    raise ValueError(f"kv_seq over {axes!r}: a KV cache's sequence splits "
                     "over 'data', 'model' or ('data', 'model'), in that "
                     "order")


def row_mesh(mesh: Mesh) -> Mesh:
    """The ``1 x model`` mesh of this rank's model row alone, a world of
    its own: its model group is the row's, and each rank is a data
    column of one. Every rank of ``mesh`` calls this, in the same order,
    since each creates every rank's one-rank group."""
    ones = [dist.new_group([r]) for r in range(mesh.size)]
    return Mesh(data=1, model=mesh.model, rank=mesh.coords[1],
                world_group=mesh.model_group, data_group=ones[mesh.rank],
                model_group=mesh.model_group)


# --------------------------------------------------------------------------
# Host decisions agreed over the mesh
# --------------------------------------------------------------------------

def _mesh_reduce(value: float, op, mesh: Optional[Mesh],
                 axis: Optional[str]) -> float:
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None:
        return value
    if axis is None:
        group, size = mesh.world_group, mesh.size
    else:
        group, size = mesh.group(axis), mesh.shape[axis]
    if size == 1:
        return value
    t = torch.tensor([value], dtype=torch.float64)
    dist.all_reduce(t, op=op, group=group)
    return float(t.item())


def mesh_max(x: float, mesh: Optional[Mesh] = None,
             axis: Optional[str] = None) -> float:
    """The largest ``x`` over the ranks of ``mesh`` (default: the mesh
    in scope) along ``axis`` (``"model"``: the model row, ``"data"``:
    the data column, None: every rank of the mesh); ``x`` itself with no
    mesh or an axis of 1. A host-side collective (a CPU tensor, gloo),
    outside autograd: every rank of the group must call it, in the same
    order."""
    return _mesh_reduce(float(x), dist.ReduceOp.MAX, mesh, axis)


def mesh_all(b: bool, mesh: Optional[Mesh] = None,
             axis: Optional[str] = None) -> bool:
    """Whether ``b`` holds on every rank of ``mesh`` along ``axis``, as
    :func:`mesh_max`. A host branch on rank-local data (a pool's bytes,
    a rank's own error) goes through this, so that every rank takes the
    same branch: a rank that branched alone would deadlock the others'
    next collective."""
    return _mesh_reduce(1.0 if b else 0.0, dist.ReduceOp.MIN, mesh, axis) > 0


def _all_reduce(t: torch.Tensor, row: ModelRow) -> torch.Tensor:
    t = t.contiguous().clone()
    dist.all_reduce(t, group=row.group)
    return t


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, row):
        ctx.row = row
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.row), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, row):
        return _all_reduce(x, row)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, row):
        ctx.dim, ctx.row, ctx.n = dim, row, x.shape[dim]
        parts: List[torch.Tensor] = [torch.empty_like(x)
                                     for _ in range(row.size)]
        dist.all_gather(parts, x.contiguous(), group=row.group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.row.index * ctx.n, ctx.n)
                .contiguous(), None, None)


def copy_to_model(x: torch.Tensor, row: Optional[ModelRow]) -> torch.Tensor:
    """Identity forward; the cotangent summed over the model row
    backward: the input of a layer whose weights are split, each rank's
    part of the gradient completed by the others'."""
    if row is None or row.size == 1:
        return x
    return _CopyToModel.apply(x, row)


def reduce_from_model(x: torch.Tensor, row: Optional[ModelRow]
                      ) -> torch.Tensor:
    """Sum over the model row forward (every rank gets the same bits);
    identity backward: the output of a layer whose contraction dim is
    split."""
    if row is None or row.size == 1:
        return x
    return _ReduceFromModel.apply(x, row)


def gather_from_model(x: torch.Tensor, dim: int, row: Optional[ModelRow]
                      ) -> torch.Tensor:
    """The model row's blocks concatenated along ``dim`` in rank order
    forward; this rank's block of the cotangent backward, which is right
    where the gathered tensor's cotangent is the same on every rank of
    the row (what follows runs alike on all of them)."""
    if row is None or row.size == 1:
        return x
    return _GatherFromModel.apply(x, dim % x.dim(), row)
