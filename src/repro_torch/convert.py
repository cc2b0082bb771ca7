"""State from the reference package, as numpy arrays, into the port:
parameters into the port's tree (same keys, shapes and dtypes, so both
packages compute the same function on the same weights), a wired
(compressed-weight) tree and its manifest in both directions
(:func:`wire_from_numpy`, :func:`wire_to_numpy`), the flat ZeRO-1
optimizer state into one data-parallel rank's slice, and a global
parameter tree cut to one rank's MoE experts (:func:`shard_experts`)."""
from __future__ import annotations

import json

import numpy as np
import torch

from repro_torch.models.moe import EXPERT_LEAVES, is_moe_ffn
from repro_torch.models.transformer import resolve_device


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
    ``[*data_axes, model, seg]``, ``step`` a scalar) -> this data-parallel
    rank's flat state ``{"m": [seg], "v": [seg], "step": []}`` on
    ``device``. The model axis must have size 1 (the ZeRO-1 state over a
    model axis is not ported, ROADMAP queue 1, item 15); data ranks are taken in row-major order of the mesh's
    data axes, the order of the reference's reduce-scatter segments."""
    dev = resolve_device(device)
    out = {}
    for k in ("m", "v"):
        a = np.array(state[k])
        if a.shape[-2] != 1:
            raise ValueError(f"{k}: model axis {a.shape[-2]} != 1")
        out[k] = torch.from_numpy(
            np.ascontiguousarray(a.reshape(-1, a.shape[-1])[rank])).to(dev)
    out["step"] = torch.tensor(int(np.array(state["step"])),
                               dtype=torch.int32, device=dev)
    return out


def shard_experts(params, model_index: int, model_size: int):
    """The tree a rank of model index ``model_index`` holds under
    ``shardmap_a2a``: each MoE FFN's expert weights (a whole model's, or
    one FFN's) cut to its ``num_experts / model_size`` experts ``[m * el,
    (m + 1) * el)`` along the expert dim (the third from last), every
    other leaf whole. Identity for ``model_size == 1``."""
    if model_size == 1:
        return params

    return _cut_experts(params, model_index, model_size)


def _cut_experts(node, model_index: int, model_size: int):
    if not isinstance(node, dict):
        return node
    moe_here = is_moe_ffn(node)
    return {k: _cut_expert_leaf(v, model_index, model_size)
            if moe_here and k in EXPERT_LEAVES
            else _cut_experts(v, model_index, model_size)
            for k, v in node.items()}


def _cut_expert_leaf(t, model_index: int, model_size: int):
    e = t.shape[-3]
    el = e // model_size
    if el * model_size != e:
        raise ValueError(f"{e} experts cannot be split over a model "
                         f"axis of {model_size}")
    return t.narrow(-3, model_index * el, el).clone()
