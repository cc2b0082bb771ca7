"""Model assembly: parameter init, the training forward and loss, and,
for serving, decode states and the one-token decode step over the
layer-group stack.

Parameters are a plain dict tree in the reference's layout: layer
groups are stacked along a leading group dim, e.g.
``params["groups"]["l0"]["mixer"]["wq"]`` has shape ``[G, d, h, hd]``.
That stacked leaf is the weight wire's unit. Every block kind is
ported, for training and for decoding: attention (sliding-window and
padded-head variants included) with a dense FFN of any activation
(``w_gate`` only for swiglu) or an MoE FFN (``models.moe``), and the
recurrent mamba, sLSTM and mLSTM blocks (``models.ssm``), whose decode
states are ``NamedTuple`` s in the same stacked layout.

:func:`param_specs` gives every leaf's logical axes, as the reference's
(``"layers"`` before each stacked leaf). Over a mesh in scope whose
model axis is above 1, the training forward takes each
rank's local tree (``convert.shard_params``: every leaf cut as its
resolved spec says) and runs the model row's collectives inside its
layers (``models.layers``, ``models.attention``, ``models.moe``,
``models.ssm``): every block kind, dense, MoE and recurrent. So does
:func:`decode_step`, on the rank's part of the decode states
(:func:`decode_states_specs`, :func:`init_decode_states` with the row),
the embedding summed over the row and the logits gathered: every rank
of the row returns the same logits.

Under sharding rules in scope that cut parameters by FSDP
(``parallel.sharding.make_rules()``; ``launch.mesh.fsdp_column``) the
tree holds each FSDP leaf as the rank's ``data x model`` block
(``convert.shard_params`` with the data cut): :func:`apply_stack`
gathers a layer group's blocks over the data column right before the
group runs and drops them after it (inside the group's checkpoint, which
FSDP puts on every group whatever ``cfg.remat`` says, so the backward
pass gathers them again), the gathers' backward reduce-scatters the
gradients, and the embedding, the head and the final norm are gathered
where they are read. A weight wire under FSDP holds each compressed leaf's model-block
wire cut by chunks over the column, opened a group at a time through
the column (``GroupWireCodec.open_group_sharded``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import (current_mesh, fsdp_column,
                                     gather_from_data, kv_seq_shard,
                                     model_row)
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe, ssm


def resolve_device(device) -> torch.device:
    """The device an entry point allocates on. ``"cuda"`` without a card
    raises: entry points never fall back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but no CUDA device is available; pass "
            "device='cpu' explicitly to run the plain versions on the CPU")
    return dev


def tree_map(fn: Callable, tree, *rest):
    """Map over dict / NamedTuple / tuple trees with tensor leaves."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else tuple(vals)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def pytree_leaves(tree) -> list:
    """Leaves of a dict tree in the reference's pytree order (each dict's
    keys sorted, as ``jax.tree.leaves`` flattens): the order of the flat
    gradient and parameter vectors, so flat state moves between the two
    packages element for element."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in pytree_leaves(tree[k])]
    return [tree]


def _unflatten_at(node, leaves: list, pos: int):
    """The subtree shaped like ``node`` from ``leaves[pos:]`` and the
    position after it."""
    if not isinstance(node, dict):
        return leaves[pos], pos + 1
    built = {}
    for k in sorted(node):
        built[k], pos = _unflatten_at(node[k], leaves, pos)
    return {k: built[k] for k in node}, pos


def pytree_unflatten(like, leaves) -> Any:
    """Inverse of :func:`pytree_leaves`: ``leaves`` in that order placed
    into a dict tree shaped like ``like``."""
    return _unflatten_at(like, list(leaves), 0)[0]


def leaf_grads(loss: torch.Tensor, leaves) -> list:
    """``d loss / d leaf`` for each of ``leaves``; zeros for a leaf the
    loss does not reach (the sLSTM block's ``wk`` and ``wv``), as
    ``jax.grad`` gives."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for g, p in zip(grads, leaves)]


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------

def _normal(gen, shape, scale, dtype, device):
    t = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return t.mul_(scale)


def _under(keep, *prefix):
    """``keep`` for the subtree at ``prefix``."""
    return lambda path, t: keep(prefix + tuple(path), t)


def _init_mixer(gen, kind: str, cfg: ModelConfig, g: int, dtype, device,
                keep=layers.keep_whole):
    if kind == "mamba":
        return ssm.init_mamba(gen, cfg, dtype, device, lead=(g,), keep=keep)
    if kind == "mlstm":
        return ssm.init_mlstm(gen, cfg, dtype, device, lead=(g,), keep=keep)
    if kind == "slstm":
        return ssm.init_slstm(gen, cfg, dtype, device, lead=(g,), keep=keep)
    if kind != "attention":
        raise ValueError(kind)
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    s = 1.0 / d ** 0.5
    so = 1.0 / (h * hd) ** 0.5
    hp = attn.padded_heads(cfg)
    # zero pad slices of wq / wo, frozen at use: the unpadded function
    wq = _normal(gen, (g, d, h, hd), s, dtype, device)
    if hp != h:
        wq = torch.cat([wq, wq.new_zeros((g, d, hp - h, hd))], dim=2)
    p = {"wq": keep(("wq",), wq)}
    del wq
    for name in ("wk", "wv"):
        p[name] = keep((name,), _normal(gen, (g, d, kv, hd), s, dtype,
                                        device))
    wo = _normal(gen, (g, h, hd, d), so, dtype, device)
    if hp != h:
        wo = torch.cat([wo, wo.new_zeros((g, hp - h, hd, d))], dim=1)
    p["wo"] = keep(("wo",), wo)
    return p


def _init_block(gen, kind: str, cfg: ModelConfig, idx_in_group: int,
                g: int, dtype, device, keep=layers.keep_whole
                ) -> Dict[str, Any]:
    """One block's parameters, stacked over ``g`` groups. A block whose
    FFN kind is ``"none"`` (the xLSTM blocks, any block of a ``d_ff``
    0 config) has no ``norm2`` and no ``ffn``, as in the reference."""
    d = cfg.d_model
    p: Dict[str, Any] = {
        "norm1": keep(("norm1",), torch.ones((g, d), dtype=dtype,
                                             device=device)),
        "mixer": _init_mixer(gen, kind, cfg, g, dtype, device,
                             _under(keep, "mixer")),
    }
    fk = cfg.ffn_kind(idx_in_group)
    if fk != "none":
        p["norm2"] = keep(("norm2",), torch.ones((g, d), dtype=dtype,
                                                 device=device))
    if fk == "moe":
        p["ffn"] = moe.init_moe(gen, cfg, dtype, device, lead=(g,),
                                keep=_under(keep, "ffn"))
    elif fk == "dense":
        ff = cfg.d_ff
        p["ffn"] = {
            "w_in": keep(("ffn", "w_in"), _normal(
                gen, (g, d, ff), 1.0 / d ** 0.5, dtype, device)),
            "w_out": keep(("ffn", "w_out"), _normal(
                gen, (g, ff, d), 1.0 / ff ** 0.5, dtype, device)),
        }
        if cfg.activation == "swiglu":
            p["ffn"]["w_gate"] = keep(("ffn", "w_gate"), _normal(
                gen, (g, d, ff), 1.0 / d ** 0.5, dtype, device))
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", keep=layers.keep_whole) -> Dict[str, Any]:
    """Random parameters on ``device`` from ``generator`` (which must
    live on that device), in the reference's tree layout. ``keep(path,
    leaf) -> leaf``, when given, takes each leaf as soon as it is drawn
    (``path``: its keys from the root), before the next is drawn: the
    same numbers come from the generator, and a ``keep`` that returns a
    block of each (``convert.init_local_params``) never holds more than
    one whole leaf."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)
    kinds = cfg.layer_kinds()
    n_groups = cfg.num_layers // len(kinds)
    if n_groups * len(kinds) != cfg.num_layers:
        raise ValueError(f"{cfg.name}: num_layers {cfg.num_layers} not "
                         f"divisible by period {len(kinds)}")
    d, v = cfg.d_model, cfg.vocab_size
    params = {
        "embed": keep(("embed",), _normal(generator, (v, d), 1.0 / d ** 0.5,
                                          dtype, dev)),
        "final_norm": keep(("final_norm",), torch.ones((d,), dtype=dtype,
                                                       device=dev)),
        "groups": {f"l{i}": _init_block(generator, kind, cfg, i, n_groups,
                                        dtype, dev,
                                        _under(keep, "groups", f"l{i}"))
                   for i, kind in enumerate(kinds)},
    }
    if not cfg.tie_embeddings:
        params["head"] = keep(("head",), _normal(generator, (d, v),
                                                 d ** -0.5, dtype, dev))
    return params


def _block_specs(kind: str, cfg: ModelConfig, idx_in_group: int):
    p: Dict[str, Any] = {"norm1": ("embed",)}
    if kind == "attention":
        p["mixer"] = attn.attention_param_specs()
    elif kind == "mamba":
        p["mixer"] = ssm.mamba_param_specs()
    else:
        p["mixer"] = ssm.xlstm_param_specs()
    fk = cfg.ffn_kind(idx_in_group)
    if fk != "none":
        p["norm2"] = ("embed",)
        if fk == "moe":
            p["ffn"] = moe.moe_param_specs(cfg)
        else:
            p["ffn"] = layers.mlp_param_specs(cfg.activation)
    return p


def _stacked(specs):
    """``"layers"`` before every leaf spec of a dict of specs."""
    if isinstance(specs, dict):
        return {k: _stacked(v) for k, v in specs.items()}
    return ("layers",) + tuple(specs)


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The logical axes of every parameter leaf (tuples of names), in the
    parameter tree's layout: the reference's ``param_specs``."""
    group = {f"l{i}": _block_specs(kind, cfg, i)
             for i, kind in enumerate(cfg.layer_kinds())}
    specs = {
        "embed": ("vocab", "embed"),
        "final_norm": ("embed",),
        "groups": _stacked(group),
    }
    if not cfg.tie_embeddings:
        specs["head"] = ("embed", "vocab")
    return specs


# --------------------------------------------------------------------------
# Decode
# --------------------------------------------------------------------------

def decode_states_specs(cfg: ModelConfig):
    """The logical axes of every decode-state leaf (the reference's
    ``decode_states_specs``): per layer slot of a group, its state type
    with a tuple of axis names per field, the leading (group) dim
    unnamed. Over a model row a KV cache holds the rank's ``kv_heads``
    (or, under a ``kv_seq`` rule over ``model``, its range of
    positions), a mamba state its ``mlp`` channels and an xLSTM state
    its ``heads``."""
    def one(kind):
        if kind == "attention":
            return attn.KVCache(
                k=(None, "batch", "kv_seq", "kv_heads", "head_dim"),
                v=(None, "batch", "kv_seq", "kv_heads", "head_dim"),
                length=(None, "batch"))
        if kind == "mamba":
            return ssm.MambaState(ssm=(None, "batch", "mlp", "state"),
                                  conv=(None, "batch", "conv", "mlp"))
        if kind == "mlstm":
            return ssm.MLSTMState(c=(None, "batch", "heads", None, None),
                                  n=(None, "batch", "heads", "head_dim"),
                                  m=(None, "batch", "heads"))
        if kind == "slstm":
            return ssm.SLSTMState(c=(None, "batch", "heads", "head_dim"),
                                  n=(None, "batch", "heads"),
                                  m=(None, "batch", "heads"))
        raise ValueError(kind)

    return {f"l{i}": one(kind) for i, kind in enumerate(cfg.layer_kinds())}


def _whole_decode_states(cfg: ModelConfig, batch: int, max_len: int,
                         device):
    """The whole model's fresh decode states on ``device`` (``"meta"``
    for their shapes and dtypes alone), stacked over groups."""
    kinds = cfg.layer_kinds()
    n_groups = cfg.num_layers // len(kinds)
    dtype = getattr(torch, cfg.dtype)
    like = torch.zeros((1,), device=device)
    init_state = {"mamba": ssm.mamba_init_state,
                  "mlstm": ssm.mlstm_init_state,
                  "slstm": ssm.slstm_init_state}
    group = {}
    for i, kind in enumerate(kinds):
        if kind == "attention":
            group[f"l{i}"] = attn.KVCache.init(
                batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim,
                dtype, device)
        else:
            group[f"l{i}"] = init_state[kind](like, batch, cfg)
    return tree_map(
        lambda a: a[None].expand((n_groups,) + tuple(a.shape)).clone(),
        group)


def _seq_dim(resolved, axis: str) -> Optional[int]:
    """The dim of a resolved spec whose entry holds mesh ``axis``."""
    for d, e in enumerate(resolved):
        if e is not None and axis in ((e,) if isinstance(e, str) else e):
            return d
    return None


def decode_state_cut(cfg: ModelConfig, index: int, size: int, shapes):
    """How rank ``index`` of a model row of ``size`` holds each decode-state
    leaf of the whole ``shapes`` (a tree of stacked shapes, as
    :func:`init_decode_states` makes them): per leaf ``(dim, start,
    count)``, the rank's ``count`` entries of ``dim`` from ``start``, or
    None for a leaf it holds whole. A leaf is cut as its spec
    (:func:`decode_states_specs`) resolves on the row under the sharding
    rules in scope. A KV cache whose ``kv_seq`` resolves onto ``model``
    (the reference's ``kv_seq -> model`` or ``("data", "model")``) holds
    the rank's range of positions of every KV head; any other holds, of
    the whole sequence, ``attention.decode_kv_heads``: the spec's block
    where the KV heads divide the row, else the heads the rank's query
    heads read."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel import sharding
    layout = Mesh(data=1, model=size, rank=0, world_group=None,
                  data_group=None, model_group=None)
    rules = sharding.get_rules()
    specs = decode_states_specs(cfg)
    out = {}
    for key, st in specs.items():
        fields = []
        for name, spec in zip(st._fields, st):
            shape = getattr(shapes[key], name)
            resolved = rules.spec(spec, shape=shape, mesh=layout)
            dim = _seq_dim(resolved, "model")
            kv = isinstance(st, attn.KVCache) and name != "length"
            if size == 1 or (dim is None and not kv):
                fields.append(None)
            elif kv and dim != spec.index("kv_seq"):
                heads = attn.decode_kv_heads(cfg, index, size)
                fields.append((spec.index("kv_heads"), heads[0], len(heads)))
            else:
                n = shape[dim] // size
                fields.append((dim, index * n, n))
        out[key] = type(st)(*fields)
    return out


def decode_state_data_cut(cfg: ModelConfig, index: int, size: int, shapes):
    """How rank ``index`` of a data column of ``size`` holds each
    decode-state leaf of the whole ``shapes``, as the sharding rules in
    scope resolve its spec (:func:`decode_states_specs`) on a ``size x
    1`` layout: per leaf ``(dim, start, count)``, the contiguous block of
    the dim whose entry holds ``data`` (the batch under the default
    rules, a KV cache's sequence under ``make_rules(decode_seq_shard=
    True)`` or the reference's ``kv_seq -> ("data", "model")``, which
    :func:`decode_state_cut` then cuts again over the row), or None for
    a leaf the column holds whole."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel import sharding
    layout = Mesh(data=size, model=1, rank=0, world_group=None,
                  data_group=None, model_group=None)
    rules = sharding.get_rules()
    out = {}
    for key, st in decode_states_specs(cfg).items():
        fields = []
        for name, spec in zip(st._fields, st):
            shape = getattr(shapes[key], name)
            dim = _seq_dim(rules.spec(spec, shape=shape, mesh=layout),
                           "data")
            if size == 1 or dim is None:
                fields.append(None)
            else:
                n = shape[dim] // size
                fields.append((dim, index * n, n))
        out[key] = type(st)(*fields)
    return out


def init_decode_states(cfg: ModelConfig, batch: int, max_len: int,
                       device="cuda", row=None):
    """Fresh per-layer decode states, stacked over groups; over a model
    ``row`` (a ``launch.mesh.ModelRow``), the rank's part of each as the
    sharding rules in scope cut it (:func:`decode_state_cut`): where
    they put ``kv_seq`` on ``model``, a KV cache's ``max_len / row.size``
    positions of every KV head."""
    dev = resolve_device(device)
    if row is None or row.size == 1:
        return _whole_decode_states(cfg, batch, max_len, dev)
    meta = _whole_decode_states(cfg, batch, max_len, "meta")
    shapes = tree_map(lambda a: tuple(a.shape), meta)
    cut = decode_state_cut(cfg, row.index, row.size, shapes)
    out = {}
    for key, st in meta.items():
        fields = []
        for a, c in zip(st, cut[key]):
            shape = list(a.shape)
            if c is not None:
                shape[c[0]] = c[2]
            fields.append(torch.zeros(shape, dtype=a.dtype, device=dev))
        out[key] = type(st)(*fields)
    return out


_SSM_BLOCKS = {"mamba": ssm.mamba_block, "mlstm": ssm.mlstm_block,
               "slstm": ssm.slstm_block}


def _apply_block(p, kind: str, x, positions, cfg: ModelConfig, state,
                 scope=None, row=None, shard=None):
    h = layers.rms_norm(x, p["norm1"], cfg.norm_eps)
    if kind == "attention":
        out, new_state = attn.attention_block(p["mixer"], h, cfg, positions,
                                              cache=state, row=row,
                                              shard=shard)
    elif kind in _SSM_BLOCKS:
        out, new_state = _SSM_BLOCKS[kind](p["mixer"], h, cfg, state=state,
                                           row=row)
    else:
        raise ValueError(kind)
    x = x + out
    if "ffn" in p:
        h2 = layers.rms_norm(x, p["norm2"], cfg.norm_eps)
        if "router" in p["ffn"]:
            f = moe.moe_block(p["ffn"], h2, cfg, scope, row)
        else:
            split = row is not None and p["ffn"]["w_out"].shape[-2] \
                != cfg.d_ff
            f = layers.mlp(p["ffn"], h2, cfg.activation,
                           row if split else None)
        x = x + f
    return x, new_state


def _gather_group(pg, dims, col, shift: int = 0):
    """``pg`` with each tensor leaf that has an FSDP dim in ``dims`` (the
    stacked tree's, ``shift`` leading dims indexed away) gathered over
    the column ``col``; a wired leaf, or one the column holds whole, as
    it is."""
    if isinstance(dims, dict):
        return {k: _gather_group(pg[k], dims[k], col, shift) for k in pg}
    if dims is None or not isinstance(pg, torch.Tensor):
        return pg
    return gather_from_data(pg, dims - shift, col)


def _apply_group(pg, x, positions, cfg: ModelConfig, scope, row, col=None,
                 dims=None):
    """One layer group of the training forward; over an FSDP column its
    blocks are gathered first."""
    if col is not None:
        pg = _gather_group(pg, dims, col, 1)
    for i, kind in enumerate(cfg.layer_kinds()):
        x, _ = _apply_block(pg[f"l{i}"], kind, x, positions, cfg, None,
                            scope, row)
    return x


def _fsdp_state(cfg: ModelConfig):
    """The FSDP column and every leaf's FSDP dim (``parallel.sharding.
    fsdp_dims``) under the mesh and rules in scope, or ``(None, None)``."""
    col = fsdp_column()
    if col is None:
        return None, None
    from repro_torch.parallel.sharding import fsdp_dims
    return col, fsdp_dims(cfg, current_mesh())


def apply_stack(params, x, positions, cfg: ModelConfig, states=None,
                weight_codec=None):
    """Run every layer group in order. ``states=None`` (training): the
    whole sequence through each group, each group recomputed in the
    backward pass when ``cfg.remat`` is not ``"none"``, or under FSDP
    whatever ``cfg.remat`` says (a per-group
    ``torch.utils.checkpoint``; ``"dots"``, which keeps the matmul
    outputs in the reference, recomputes the whole group here, with the
    same values). Returns (x, None). With decode states, each group runs
    against its states; with ``weight_codec`` the group params arrive in
    wire form and each group's wire is opened inside the loop, right
    before its layers. Returns (x, new_states). MoE layers read their
    bindings (``moe.moe_scope``) once, here on the caller's thread, so a
    recomputed group sees the same ones; in a decode step the ``B``
    tokens of the step are an MoE layer's batch, its capacity theirs.
    Over a mesh in scope with a model axis above 1 both branches run
    ``params``, this rank's local tree, over its model row
    (``launch.mesh.model_row``, read here likewise), and a decode step's
    ``states`` are the rank's part of them (:func:`init_decode_states`
    with the row). Under sharding rules in scope that put ``kv_seq`` on
    mesh axes (``launch.mesh.kv_seq_shard``: the data column, the model
    row or the whole mesh, a shard of one rank on axes of 1) a decode
    step's KV caches hold the rank's range of positions, and each
    attention layer combines the shard's partial attentions. Under rules
    that cut parameters by FSDP each group's blocks are gathered over
    the data column before it runs (module docstring), and a wire's
    chunk shards opened over the column."""
    groups = params["groups"]
    kinds = cfg.layer_kinds()
    n_groups = tree_leaves(groups)[0].shape[0]
    scope = moe.moe_scope() if cfg.moe is not None else None
    row = model_row()
    col, dims = _fsdp_state(cfg)
    gdims = dims["groups"] if col is not None else None
    if states is None:
        # under FSDP every group is recomputed, so that the backward pass
        # gathers its blocks again instead of keeping them
        remat = (cfg.remat != "none" or col is not None) \
            and torch.is_grad_enabled()
        for g in range(n_groups):
            pg = tree_map(lambda a: a[g], groups)
            if remat:
                x = torch.utils.checkpoint.checkpoint(
                    _apply_group, pg, x, positions, cfg, scope, row, col,
                    gdims, use_reentrant=False)
            else:
                x = _apply_group(pg, x, positions, cfg, scope, row, col,
                                 gdims)
        return x, None
    shard = kv_seq_shard()
    outs = []
    for g in range(n_groups):
        pg = tree_map(lambda a: a[g], groups)
        if col is not None:
            pg = _gather_group(pg, gdims, col, 1)
        if weight_codec is not None:
            pg = (weight_codec.open_group(pg) if col is None
                  else weight_codec.open_group_sharded(pg, group=col.group))
        sg = tree_map(lambda a: a[g], states)
        new_sg = {}
        for i, kind in enumerate(kinds):
            x, new_sg[f"l{i}"] = _apply_block(pg[f"l{i}"], kind, x,
                                              positions, cfg, sg[f"l{i}"],
                                              scope, row, shard)
        outs.append(new_sg)
    new_states = tree_map(lambda *xs: torch.stack(xs), *outs)
    return x, new_states


def _top(params, key: str, cfg: ModelConfig) -> torch.Tensor:
    """Top-level leaf ``key`` (the embedding, the head, the final norm)
    as the layers read it: gathered over the FSDP column where the rules
    in scope cut it."""
    col, dims = _fsdp_state(cfg)
    if col is None or dims[key] is None:
        return params[key]
    return gather_from_data(params[key], dims[key], col)


def _vocab_row(table: torch.Tensor, dim: int, cfg: ModelConfig):
    """The model row ``table`` (the embedding, or the head) is split over
    along its vocab ``dim``, or None when it is whole."""
    row = model_row()
    return row if row is not None and table.shape[dim] != cfg.vocab_size \
        else None


def _head(params, cfg: ModelConfig):
    """The unembedding weight and the row its vocab is split over."""
    if cfg.tie_embeddings:
        table = _top(params, "embed", cfg)
        return table, _vocab_row(table, 0, cfg)
    table = _top(params, "head", cfg)
    return table, _vocab_row(table, 1, cfg)


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    table = _top(params, "embed", cfg)
    return layers.embed(table, tokens, _vocab_row(table, 0, cfg)).to(
        getattr(torch, cfg.dtype))


def _hidden(params, cfg: ModelConfig, tokens: torch.Tensor,
            prefix_emb: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    dtype = getattr(torch, cfg.dtype)
    x = _embed(params, cfg, tokens)
    if prefix_emb is not None:
        x = torch.cat([prefix_emb.to(dtype), x], dim=1)
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
    x, _ = apply_stack(params, x, positions, cfg, states=None)
    return layers.rms_norm(x, _top(params, "final_norm", cfg), cfg.norm_eps)


def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            prefix_emb: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens: [B, St] -> logits [B, St(+P), V]; ``prefix_emb`` [B, P, D]
    is prepended to the token embeddings. Over a model row whose vocab is
    split, each rank's logits are gathered: every rank returns the whole
    [B, St(+P), V]."""
    x = _hidden(params, cfg, tokens, prefix_emb, positions)
    head, row = _head(params, cfg)
    return layers.unembed(head, x, cfg.tie_embeddings, row)


def prefill_logits(params, cfg: ModelConfig, tokens: torch.Tensor,
                   prefix_emb: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Inference prefill: logits of the last position only, [B, 1, V]
    (the [B, S, V] logits are never made); over a model row whose vocab
    is split, gathered as :func:`forward` gathers them."""
    x = _hidden(params, cfg, tokens, prefix_emb)
    head, row = _head(params, cfg)
    return layers.unembed(head, x[:, -1:], cfg.tie_embeddings, row)


def next_token_loss(params, cfg: ModelConfig, tokens: torch.Tensor,
                    labels: torch.Tensor,
                    prefix_emb: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Mean next-token cross entropy (f32). labels: [B, St] aligned to
    tokens (label t = token t+1); prefix positions carry no loss.

    Over a model row the logits are gathered along the vocab
    (:func:`forward`) and the f32 ``log_softmax`` runs on the whole
    vocab, on every rank alike, rather than a vocab-parallel cross
    entropy: the loss is then the same function as the reference's, in
    the same order, and its cotangent the same on every rank of the row,
    so the gather's backward is a slice and the replicated leaves'
    gradients stay bit-identical over the row. It costs each rank the
    whole [B, S, V] f32 logits (131 MB for phi3-mini at 2 x 512). Against
    the reference the loss agrees to rtol 1e-5 (the split matmuls sum in
    another order)."""
    logits = forward(params, cfg, tokens, prefix_emb)
    if prefix_emb is not None:
        logits = logits[:, prefix_emb.shape[1]:]
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return -ll.mean()


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, states,
                positions: torch.Tensor, weight_codec=None):
    """Decode. tokens: [B, S]; positions: [B, S] absolute. S is 1 in the
    engine; an attention stack also takes S tokens at once, written into
    the cache together.

    Over a mesh in scope with a model axis above 1, ``params`` is the
    rank's local tree and ``states`` its part of the decode states: the
    embedding is summed over the row and the logits gathered along the
    vocab, so every rank of the row returns the same [B, S, V], bit for
    bit. Returns (logits [B, S, V], new_states).
    """
    x = _embed(params, cfg, tokens)
    x, new_states = apply_stack(params, x, positions, cfg, states,
                                weight_codec=weight_codec)
    x = layers.rms_norm(x, _top(params, "final_norm", cfg), cfg.norm_eps)
    head, row = _head(params, cfg)
    return layers.unembed(head, x, cfg.tie_embeddings, row), new_states
