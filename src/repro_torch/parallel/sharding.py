"""Logical-axis sharding rules: the reference's
``repro.parallel.sharding`` rule table and its resolution, for the
port's ``data x model`` layout (``launch.mesh.Mesh``).

Every parameter dimension has a logical name (``models.param_specs``);
the rule table maps each name to mesh axes. A resolved spec is a plain
tuple with one entry per dim: ``None`` (the dim is whole on every rank),
an axis name, or a tuple of them. Resolution is the reference's
``ShardingRules._resolve``: axes absent from the mesh drop out, a mesh
axis serves at most one dim of a spec (the first dim that asks for it
wins), and only the longest prefix of the axes whose sizes multiply to a
divisor of the dim is kept, so 56 heads on a 16-way model axis stay
whole instead of failing.

The port resolves specs against a ``launch.mesh.Mesh`` (or any object
with its ``axis_names`` and ``shape``): sizes ``data`` and ``model``,
and no ``pod`` axis (ROADMAP queue 1, item 13). Parameters resolve with
the parameter overrides of the rules in scope: under ``make_rules()``
(FSDP, the reference's ``FSDP_PARAM_OVERRIDES``) every leaf's
``"embed"`` dim is cut over the data column as well
(:func:`data_dim`), and the steps gather it over the column where a
layer group uses it (``launch.mesh.gather_from_data``). The reference's
``logical_constraint``, ``shard_map_compat`` and ``block_axes`` steer
XLA's GSPMD partitioner and have no counterpart here: the port's layers
run the model axis themselves (``launch.mesh.copy_to_model`` and its
siblings) on the local blocks that :func:`local_shape` describes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]

#: The reference's default rules: batch over pod and data; heads, KV
#: heads, mlp, experts and vocab over model; "fsdp" dims (ZeRO-3) over
#: pod and data.
DEFAULT_RULES: Dict[str, MeshAxes] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "expert": "model",
    "vocab": "model",
    "fsdp": ("pod", "data"),
    "layers": None,
    "kv_seq": None,
    "state": None,
    "conv": None,
    "blocks32": None,
}

#: The reference's FSDP parameter overrides (``make_rules(fsdp_params=
#: True)``): a parameter's ``"embed"`` dim over the data axes (ZeRO-3).
#: The compressed step resolves parameters without them (:func:`tp_only`),
#: as the reference's does.
FSDP_PARAM_OVERRIDES: Dict[str, MeshAxes] = {
    "embed": ("pod", "data"),
}


@dataclasses.dataclass
class ShardingRules:
    """Rules for activations plus parameter-dim overrides."""
    rules: Dict[str, MeshAxes]
    param_overrides: Dict[str, MeshAxes] = dataclasses.field(
        default_factory=dict)

    def _resolve(self, name: Optional[str], dim: Optional[int], mesh,
                 param: bool, used: set) -> MeshAxes:
        if name is None:
            return None
        ax = (self.param_overrides.get(name, self.rules.get(name))
              if param else self.rules.get(name))
        if ax is None:
            return None
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        if mesh is not None:
            axes = tuple(a for a in axes if a in mesh.axis_names)
        axes = tuple(a for a in axes if a not in used)
        if dim is not None and mesh is not None:
            kept, prod = [], 1
            for a in axes:
                size = mesh.shape[a]
                if dim % (prod * size):
                    break
                kept.append(a)
                prod *= size
            axes = tuple(kept)
        if not axes:
            return None
        used.update(axes)
        return axes[0] if len(axes) == 1 else axes

    def spec(self, logical_axes: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None, param: bool = False,
             mesh=None) -> Tuple[MeshAxes, ...]:
        """The resolved spec of a tensor with these logical axes (and,
        for the divisibility rule, this shape) on ``mesh`` (default: the
        mesh in scope, ``launch.mesh.current_mesh``)."""
        if mesh is None:
            from repro_torch.launch.mesh import current_mesh
            mesh = current_mesh()
        dims = list(shape) if shape is not None else [None] * len(
            logical_axes)
        used: set = set()
        return tuple(self._resolve(name, d, mesh, param, used)
                     for name, d in zip(logical_axes, dims))


_STATE = threading.local()


def set_rules(rules: Optional[ShardingRules]):
    _STATE.rules = rules


def get_rules() -> ShardingRules:
    r = getattr(_STATE, "rules", None)
    return r if r is not None else ShardingRules(dict(DEFAULT_RULES))


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    """Put ``rules`` in scope for this thread (:func:`get_rules`), and
    the previous ones back on exit."""
    old = getattr(_STATE, "rules", None)
    set_rules(rules)
    try:
        yield rules
    finally:
        set_rules(old)


def make_rules(fsdp_params: bool = True, decode_seq_shard: bool = False,
               extra: Optional[Dict[str, MeshAxes]] = None
               ) -> ShardingRules:
    rules = dict(DEFAULT_RULES)
    if decode_seq_shard:
        rules["kv_seq"] = ("data",)
        rules["batch"] = None
    if extra:
        rules.update(extra)
    return ShardingRules(
        rules=rules,
        param_overrides=dict(FSDP_PARAM_OVERRIDES) if fsdp_params else {})


def tp_only(rules: ShardingRules) -> ShardingRules:
    """``rules`` without parameter overrides: the parameters cut over the
    model axis alone (the reference's compressed step,
    ``_manual_param_specs``)."""
    return ShardingRules(rules=dict(rules.rules))


def fsdp_params(rules: Optional[ShardingRules] = None) -> bool:
    """Whether ``rules`` (default: the rules in scope) cut parameters over
    the data axis (FSDP)."""
    rules = get_rules() if rules is None else rules
    return any("data" in _axes_of(ax)
               for ax in rules.param_overrides.values())


def decode_rules(cfg, global_batch: int, mesh) -> ShardingRules:
    """The reference's sharding rules for a decode of ``global_batch``
    sequences of ``cfg`` on ``mesh`` (its ``launch/dryrun.py``
    ``cell_rules`` for a decode cell): the parameters cut by FSDP unless
    ``cfg.serve_params_tp_only``; where the KV heads do not divide the
    model axis, the KV cache's sequence over ``model``; at a batch of 1,
    over ``("data", "model")`` with the batch whole."""
    extra: Dict[str, MeshAxes] = {}
    if cfg.num_kv_heads % mesh.shape["model"]:
        extra["kv_seq"] = "model"
    if global_batch == 1:
        extra["kv_seq"] = ("data", "model")
        extra["batch"] = None
    return make_rules(fsdp_params=not cfg.serve_params_tp_only, extra=extra)


# --------------------------------------------------------------------------
# Parameter layouts
# --------------------------------------------------------------------------

def _axes_of(entry: MeshAxes) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(shape: Sequence[int], pspec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of a tensor of ``shape`` laid out
    by the resolved ``pspec``."""
    return tuple(d // math.prod(mesh.shape[a] for a in _axes_of(e))
                 for d, e in zip(shape, tuple(pspec)
                                 + (None,) * (len(shape) - len(pspec))))


def local_numel(shape: Sequence[int], pspec, mesh) -> int:
    """The reference's ``_local_numel``: elements of one rank's block."""
    return math.prod(local_shape(shape, pspec, mesh))


def replication_factor(pspec, mesh, model_axes=("model",)) -> int:
    """The reference's ``_replication_factor``: how many ranks of the
    model axes hold the same block (1 for a leaf split over them)."""
    used = {a for e in tuple(pspec) for a in _axes_of(e)}
    return math.prod(mesh.shape[a] for a in model_axes
                     if a in mesh.axis_names and a not in used)


def _axis_dim(pspec, axis: str) -> Optional[int]:
    for i, e in enumerate(tuple(pspec)):
        if axis in _axes_of(e):
            if e != axis:
                raise NotImplementedError(
                    f"spec {pspec}: a dim split over several mesh axes is "
                    "not ported (pods: ROADMAP queue 1, item 13)")
            return i
    return None


def model_dim(pspec) -> Optional[int]:
    """The dim of a resolved spec that the model axis splits, or None."""
    return _axis_dim(pspec, "model")


def data_dim(pspec) -> Optional[int]:
    """The dim of a resolved spec that the data axis splits (a
    parameter's FSDP dim), or None."""
    return _axis_dim(pspec, "data")


def param_pspecs(cfg, mesh, shapes=None, specs=None):
    """The resolved spec of every parameter leaf of ``cfg`` on ``mesh``
    under the rules in scope, with their parameter overrides (the
    reference's ``rules.spec(..., param=True)``: under ``make_rules()``
    the FSDP dims over ``data``; under :func:`tp_only` rules, as the
    reference's compressed step resolves them), in the parameter tree's
    layout. ``shapes``: the tree of global leaf shapes (default:
    :func:`param_shapes`); ``specs``: the logical axes of a subtree and
    ``shapes`` its shapes (default: the whole model's,
    ``models.param_specs``)."""
    if specs is None:
        from repro_torch.models.transformer import param_specs
        specs = param_specs(cfg)
    shapes = param_shapes(cfg) if shapes is None else shapes
    return _resolve_tree(get_rules(), specs, shapes, mesh)


def _resolve_tree(rules: ShardingRules, specs, shapes, mesh):
    if isinstance(specs, dict):
        return {k: _resolve_tree(rules, specs[k], shapes[k], mesh)
                for k in specs}
    return rules.spec(specs, shape=shapes, mesh=mesh, param=True)


def _rules_key(rules: ShardingRules):
    return (tuple(sorted(rules.rules.items())),
            tuple(sorted(rules.param_overrides.items())))


def _layout(data: int, model: int):
    """A ``data x model`` mesh without process groups: the sizes a spec
    resolves against."""
    from repro_torch.launch.mesh import Mesh
    return Mesh(data=data, model=model, rank=0, world_group=None,
                data_group=None, model_group=None)


def _dims_of(pspec) -> Tuple[Optional[int], Optional[int]]:
    return data_dim(pspec), model_dim(pspec)


@functools.lru_cache(maxsize=64)
def _leaf_dims(cfg, data: int, model: int, key):
    with use_rules(ShardingRules(dict(key[0]), dict(key[1]))):
        return _map_specs(_dims_of, param_pspecs(cfg, _layout(data, model)))


def _map_specs(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return fn(tree)


def leaf_dims(cfg, data: int, model: int, *, shapes=None, specs=None,
              split: bool = False):
    """Every parameter leaf's ``(data dim, model dim)`` on a ``data x
    model`` layout under the rules in scope (:func:`data_dim`, its FSDP
    dim, and :func:`model_dim` of its resolved spec), in the parameter
    tree's layout: the one resolver that the cuts, the gathers, the
    clip norm and the calibration counts read. ``split``: only the dims
    the layout splits (an axis of 1 splits none). ``shapes`` /
    ``specs``: a subtree's, as :func:`param_pspecs`; the whole model's
    are cached per config, layout and rules."""
    if shapes is None and specs is None:
        dims = _leaf_dims(cfg, data, model, _rules_key(get_rules()))
    else:
        dims = _map_specs(_dims_of, param_pspecs(
            cfg, _layout(data, model), shapes, specs))
    if not split:
        return dims
    return _map_specs(lambda d: (d[0] if data > 1 else None,
                                 d[1] if model > 1 else None), dims)


def fsdp_dims(cfg, mesh):
    """Every parameter leaf's FSDP dim on ``mesh`` under the rules in
    scope (None: the data column holds it whole), in the parameter
    tree's layout (:func:`leaf_dims`)."""
    return _map_specs(lambda d: d[0], leaf_dims(cfg, mesh.data, mesh.model))


def param_shapes(cfg):
    """The global shape of every parameter leaf of ``cfg`` (a tree of
    tuples), with nothing allocated."""
    from repro_torch.models.transformer import init_params, tree_map
    return tree_map(lambda t: tuple(t.shape), init_params(cfg, None, "meta"))
