"""State from the reference package, as numpy arrays, into the port:
parameters into the port's tree (same keys, shapes and dtypes, so both
packages compute the same function on the same weights), a wired
(compressed-weight) tree and its manifest in both directions
(:func:`wire_from_numpy`, :func:`wire_to_numpy`), the flat ZeRO-1
optimizer state into one rank's slice, and a model's tree cut to one
model rank's tensor-parallel blocks (and, under FSDP rules, each block
cut again over the data column) and put back together
(:func:`shard_params`, :func:`gather_params`, each leaf's split dims
:func:`leaf_model_dims`, :func:`leaf_data_dims`), or drawn a leaf at
a time straight into them (:func:`init_local_params`), and the decode
states cut to a model rank's part and joined back
(:func:`shard_decode_states`, :func:`gather_decode_states`)."""
from __future__ import annotations

import json

import numpy as np
import torch

from repro_torch.models.transformer import init_params, resolve_device


def params_from_numpy(tree, device="cuda"):
    """Nested dict of array-likes -> same dict of tensors on ``device``,
    dtypes kept."""
    dev = resolve_device(device)
    return _map_dict(lambda a, _: torch.from_numpy(np.array(a)).to(dev),
                     tree)


def _map_dict(fn, node, key=None):
    """``fn(leaf, its key)`` over a nested dict, the structure kept."""
    if isinstance(node, dict):
        return {k: _map_dict(fn, v, k) for k, v in node.items()}
    return fn(node, key)


def _tensor_from_numpy(a, dev) -> torch.Tensor:
    """One array -> a tensor with the same bits: uint32 as int32 bit
    patterns, bfloat16 (numpy's extension dtype) through its 16 bits."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)) \
            .view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def wire_from_numpy(wired, manifest, device="cuda"):
    """The reference's wired tree (``compress_params_for_serving``'s
    output as array-likes) and its ``serving_manifest`` -> the port's
    wired tree on ``device`` and its ``GroupWireCodec``: words go from
    uint32 to int32 bit patterns, u8 codes and bf16 scales keep their
    bits, dense leaves their dtypes; the manifest is carried as JSON."""
    from repro_torch.serving.engine import codec_from_manifest
    dev = resolve_device(device)
    return (_map_dict(lambda a, _: _tensor_from_numpy(a, dev), wired),
            codec_from_manifest(json.loads(json.dumps(manifest))))


def wire_to_numpy(wired, wire_codec):
    """Inverse of :func:`wire_from_numpy`: the port's wired tree and codec
    -> numpy arrays in the reference's dtypes (uint32 words, u8 codes,
    bfloat16 scales through ``ml_dtypes``, the dtype the reference's
    arrays carry) and the JSON manifest the reference's
    ``codec_from_manifest`` opens."""
    import ml_dtypes

    def to_numpy(node, key):
        t = node.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        a = t.numpy()
        return a.view(np.uint32) if key == "words" else a

    return (_map_dict(to_numpy, wired),
            json.loads(json.dumps(wire_codec.manifest())))


def flat_opt_state_from_numpy(state, rank: int = 0, device="cuda"):
    """The reference's global ZeRO-1 state (``m`` / ``v`` laid out
    ``[*data_axes, model, seg]``, ``step`` a scalar) -> the flat state
    ``{"m": [seg], "v": [seg], "step": []}`` of world rank ``rank``,
    ``m`` and ``v`` on ``device`` and ``step`` on the host (as
    ``training.optimizer`` keeps it): the row ``[d, m]`` of rank ``d *
    model + m``, in
    row-major order of the mesh's axes, the order of the reference's
    segments and of ``launch.mesh``'s ranks."""
    dev = resolve_device(device)
    out = {}
    for k in ("m", "v"):
        a = np.array(state[k])
        out[k] = torch.from_numpy(
            np.ascontiguousarray(a.reshape(-1, a.shape[-1])[rank])).to(dev)
    out["step"] = torch.tensor(int(np.array(state["step"])),
                               dtype=torch.int32)
    return out


def _cut_dims(cfg, data_size: int, model_size: int, shapes=None,
              specs=None):
    """Per leaf, ``(data dim, model dim)``: the dims a ``data_size x
    model_size`` layout splits under the rules in scope
    (``parallel.sharding.leaf_dims``; the data dim None without FSDP
    overrides, or where the column does not divide the leaf's FSDP
    dim); ``specs`` / ``shapes``: a subtree's."""
    from repro_torch.parallel import sharding
    return sharding.leaf_dims(cfg, data_size, model_size, shapes=shapes,
                              specs=specs, split=True)


def _zip_dict(fn, tree, other):
    """``fn(leaf, other's leaf)`` over a nested dict and one of the same
    keys."""
    if isinstance(tree, dict):
        return {k: _zip_dict(fn, v, other[k]) for k, v in tree.items()}
    return fn(tree, other)


def _cut(t, dims, model_index: int, model_size: int, data_index: int,
         data_size: int):
    """Rank ``(data_index, model_index)``'s block of ``t``, copied once
    (a leaf's model block is never made whole beside it)."""
    idx = [slice(None)] * len(t.shape)
    for dim, i, size in ((dims[1], model_index, model_size),
                         (dims[0], data_index, data_size)):
        if dim is not None:
            n = t.shape[dim] // size
            idx[dim] = slice(i * n, (i + 1) * n)
    if isinstance(t, torch.Tensor):
        return t[tuple(idx)].clone()
    return np.ascontiguousarray(np.asarray(t)[tuple(idx)])


def shard_params(params, cfg, model_index: int, model_size: int,
                 specs=None, data_index: int = 0, data_size: int = 1):
    """The local tree of model rank ``model_index`` of ``model_size``: each
    leaf of ``params`` (a whole tree: the reference's numpy parameters or
    the port's tensors) cut to the contiguous block that the reference's
    stage 2 gives that rank, ``[m * n / M, (m + 1) * n / M)`` along the dim
    its spec puts on the model axis; a leaf whose spec keeps it whole is
    returned as it is. Every block kind is cut by its resolved specs: an
    MoE's experts by experts where they divide the axis (else each
    expert's ``mlp`` dim) and its router by expert columns, mamba's
    ``mlp`` channels, xLSTM's heads. ``specs``: the logical axes when
    ``params`` is a subtree (one MoE FFN: ``models.moe.moe_param_specs``).
    With ``data_size`` above 1, under rules in scope that cut parameters
    by FSDP (``parallel.sharding.make_rules()``), each such leaf's model
    block is cut again along its FSDP dim: data rank ``data_index``'s
    block, so rank ``(d, m)`` holds its ``d x m`` block. Tensors in,
    tensors out (new storage for a cut leaf); numpy in, numpy out.
    Identity for a ``1 x 1`` layout."""
    if model_size == 1 and data_size == 1:
        return params
    shapes = (None if specs is None
              else _map_dict(lambda t, _: tuple(t.shape), params))
    return _zip_dict(lambda t, dims: t if dims == (None, None)
                     else _cut(t, dims, model_index, model_size, data_index,
                               data_size),
                     params, _cut_dims(cfg, data_size, model_size, shapes,
                                       specs))


def init_local_params(cfg, generator, device, model_index: int,
                      model_size: int, data_index: int = 0,
                      data_size: int = 1):
    """``shard_params(init_params(cfg, generator, device), cfg,
    model_index, model_size, data_index=data_index, data_size=
    data_size)``, bit for bit, without the whole tree: each leaf is cut
    to the rank's block as soon as it is drawn (``init_params(keep=
    ...)``), so the peak is the largest whole leaf beside the blocks kept
    so far."""
    if model_size == 1 and data_size == 1:
        return init_params(cfg, generator, device)
    dims = _cut_dims(cfg, data_size, model_size)

    def keep(path, t):
        d = dims
        for key in path:
            d = d[key]
        return t if d == (None, None) else _cut(
            t, d, model_index, model_size, data_index, data_size)
    return init_params(cfg, generator, device, keep=keep)


def whole_leaf_shapes(cfg, under: str = ""):
    """Every parameter leaf's whole shape by its path (``"a/b/c"``, the
    weight wire's leaf names), with nothing allocated; ``under``: only
    the leaves of that subtree (``"groups"``), by their paths in it."""
    from repro_torch.parallel.sharding import param_shapes
    return _under(_by_path(param_shapes(cfg)), under)


def _under(by_path, under: str):
    if not under:
        return by_path
    pre = under + "/"
    return {k[len(pre):]: v for k, v in by_path.items()
            if k.startswith(pre)}


def leaf_model_dims(cfg, model_size: int):
    """Every parameter leaf's path (``"a/b/c"``) -> the dim that a model
    axis of ``model_size`` splits, as :func:`shard_params` cuts it (None:
    kept whole)."""
    return {k: v[1] for k, v in _by_path(_cut_dims(
        cfg, 1, model_size)).items()}


def leaf_data_dims(cfg, data_size: int, model_size: int = 1,
                   under: str = ""):
    """Every parameter leaf's path -> the dim that a data column of
    ``data_size`` splits under the rules in scope (its FSDP dim), as
    :func:`shard_params` cuts it (None: kept whole over the column);
    ``under`` as :func:`whole_leaf_shapes`."""
    return _under({k: v[0] for k, v in _by_path(_cut_dims(
        cfg, data_size, model_size)).items()}, under)


def _by_path(tree, prefix: str = "", out=None):
    """A nested dict -> ``{"a/b/c": leaf}``."""
    out = {} if out is None else out
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            _by_path(v, key, out)
        else:
            out[key] = v
    return out


def gather_params(local_trees, cfg, data_size: int = 1):
    """Inverse of :func:`shard_params`: the local trees of ranks ``0 ..
    D * M - 1`` (rank ``d * M + m`` holding block ``(d, m)``, ``D`` =
    ``data_size``; tensors or numpy) -> the whole tree; a whole leaf is
    rank 0's."""
    model = len(local_trees) // data_size
    if model * data_size != len(local_trees):
        raise ValueError(f"{len(local_trees)} local trees are not "
                         f"{data_size} data ranks' rows")
    if model == 1 and data_size == 1:
        return local_trees[0]
    dims = _cut_dims(cfg, data_size, model)
    rows = [_gather_node(local_trees[d * model:(d + 1) * model], dims, 1)
            for d in range(data_size)]
    return _gather_node(rows, dims, 0)


def _gather_node(nodes, dims, which: int):
    if isinstance(dims, dict):
        return {k: _gather_node([n[k] for n in nodes], dims[k], which)
                for k in nodes[0]}
    dim = dims[which]
    if dim is None or len(nodes) == 1:
        return nodes[0]
    if isinstance(nodes[0], torch.Tensor):
        return torch.cat(nodes, dim=dim)
    return np.concatenate([np.asarray(n) for n in nodes], axis=dim)


def _state_shapes(states):
    from repro_torch.models.transformer import tree_map
    return tree_map(lambda a: tuple(a.shape), states)


def _whole_state_shapes(local, cfg):
    """The whole decode states' shapes from one rank's part: its batch,
    and its KV caches' length."""
    from repro_torch.models.transformer import _whole_decode_states
    leaves = [a for st in local.values() for a in st]
    batch = leaves[0].shape[1]
    max_len = next((st.k.shape[2] for st in local.values()
                    if hasattr(st, "k")), 1)
    return _state_shapes(_whole_decode_states(cfg, batch, max_len, "meta"))


def _cut_states(states, cut):
    out = {}
    for key, st in states.items():
        fields = []
        for a, c in zip(st, cut[key]):
            if c is None:
                fields.append(a)
            elif isinstance(a, torch.Tensor):
                fields.append(a.narrow(c[0], c[1], c[2]).clone())
            else:
                fields.append(np.ascontiguousarray(np.take(
                    np.asarray(a), np.arange(c[1], c[1] + c[2]), c[0])))
        out[key] = type(st)(*fields)
    return out


def shard_decode_states(states, cfg, model_index: int, model_size: int,
                        data_index: int = 0, data_size: int = 1):
    """The part of the whole decode ``states`` (tensors or numpy, as
    ``models.init_decode_states`` stacks them) that rank ``model_index``
    of a model row of ``model_size`` holds: each leaf cut as
    ``models.transformer.decode_state_cut`` says (the resolved
    ``decode_states_specs``; a KV cache's ``kv_heads`` as
    ``attention.decode_kv_heads``). With ``data_size`` above 1, first
    the block of data index ``data_index`` of the dim the rules in scope
    put on ``data`` (``decode_state_data_cut``: the batch by default, a
    KV cache's sequence under ``make_rules(decode_seq_shard=True)``).
    Identity for a ``1 x 1`` layout."""
    from repro_torch.models.transformer import (decode_state_cut,
                                                decode_state_data_cut)
    if data_size > 1:
        states = _cut_states(states, decode_state_data_cut(
            cfg, data_index, data_size, _state_shapes(states)))
    if model_size == 1:
        return states
    return _cut_states(states, decode_state_cut(
        cfg, model_index, model_size, _state_shapes(states)))


def gather_decode_states(local_states, cfg):
    """Inverse of :func:`shard_decode_states`: the parts of ranks ``0 ..
    M-1`` of a model row -> the whole decode states, each entry of a cut
    dim from the first rank that holds it (a KV head that several ranks'
    query heads read is held by each of them); a whole leaf is rank
    0's."""
    from repro_torch.models.transformer import decode_state_cut
    size = len(local_states)
    if size == 1:
        return local_states[0]
    first = local_states[0]
    whole = _whole_state_shapes(first, cfg)
    cuts = [decode_state_cut(cfg, m, size, whole) for m in range(size)]
    out = {}
    for key, st in first.items():
        fields = []
        for f in range(len(st)):
            parts = [local_states[m][key][f] for m in range(size)]
            if cuts[0][key][f] is None:
                fields.append(parts[0])
                continue
            dim = cuts[0][key][f][0]
            pieces, filled = [], 0
            for m in range(size):
                _, start, count = cuts[m][key][f]
                if start + count <= filled:
                    continue
                skip = filled - start
                pieces.append(parts[m][(slice(None),) * dim
                                       + (slice(skip, count),)])
                filled = start + count
            fields.append(torch.cat(pieces, dim=dim)
                          if isinstance(parts[0], torch.Tensor)
                          else np.concatenate(
                              [np.asarray(p) for p in pieces], axis=dim))
        out[key] = type(st)(*fields)
    return out
