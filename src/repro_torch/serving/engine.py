"""Serving helpers: token-by-token prefill, the greedy window step, and
the compressed-weight wire (``compress_params_for_serving`` /
``open_params``).

``prefill(..., start_pos=)`` feeds a prompt segment at absolute
positions from ``start_pos``, so a prompt fed in segments gives the
states of one whole-prompt call. :func:`window_step` runs ``window``
greedy decode steps with each argmax fed back on the device and returns
the window's tokens as one tensor: the async paging engine uploads a
seed token and position per slot, runs the window, and reads the tokens
back once (the counterpart of the reference's jitted window scan; no
CUDA graph yet).

Over a model row (a mesh in scope, ``serving.scheduler.Engine(mesh=)``)
:func:`prefill` and :func:`window_step` run on the rank's local tree
and its part of the decode states (under a sequence split, its range of
positions: each step's token lands on the rank whose range holds it, and
the engine pages and prefetches, through K5, that range's blocks between
windows), and every rank gets the same tokens;
:func:`compress_params_for_serving` wires the rank's blocks only.

Compressed-weight serving stores the layer stack as block-32 e4m3 + QLC
words (or raw e4m3 codes, ``mode="e4m3"``; ``repro_torch.comm.weights``),
compressed through K1, and opens it through K2 before the engine starts,
locally or chunk-sharded over a process group (:func:`open_params`).
Under FSDP the wire stays compressed: each rank holds its chunks of
every compressed leaf's model-block wire (:func:`place_wire`), and the
engine opens a layer group's wire over the data column inside each
decode step (``Engine(weight_codec=)``), the reference's FSDP serving
gather.
:func:`serving_manifest` / :func:`codec_from_manifest` carry the wire's
recipe (and the KV cache's) through JSON in the reference's format.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode_step


@dataclasses.dataclass
class ServeConfig:
    max_seq_len: int
    max_new_tokens: int = 32
    greedy: bool = True


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, states,
            start_pos: int = 0, chunk: int = 1, weight_codec=None):
    """Feed a prompt through the decode path token by token (the
    reference's implementation, correct for every block kind), token
    ``t`` at position ``start_pos + t``. ``chunk`` above 1 feeds that
    many tokens a decode step, written into the caches together and each
    attending causally (an attention-only stack: a long prompt then
    costs ``S / chunk`` steps, not ``S``).

    tokens: [B, S]. ``weight_codec``: ``params["groups"]`` is a weight
    wire, opened a group at a time in each step (``models.decode_step``).
    Returns (last_logits [B, V], states).
    """
    if chunk > 1 and any(k != "attention" for k in cfg.layer_kinds()):
        raise ValueError(f"a prefill of {chunk} tokens a step needs an "
                         f"attention-only stack; {cfg.name} has "
                         f"{sorted(set(cfg.layer_kinds()))}")
    b, s = tokens.shape
    logits = None
    for t in range(0, s, chunk):
        n = min(chunk, s - t)
        pos = torch.arange(start_pos + t, start_pos + t + n,
                           dtype=torch.int32,
                           device=tokens.device)[None].repeat(b, 1)
        logits, states = decode_step(params, cfg, tokens[:, t:t + n], states,
                                     pos, weight_codec=weight_codec)
    return logits[:, -1], states


def window_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                positions: torch.Tensor, states, window: int,
                free: Optional[torch.Tensor] = None, weight_codec=None):
    """``window`` greedy decode steps from seed ``tokens`` [B, 1] at
    ``positions`` [B, 1]: each step's argmax is the next step's token,
    on the device. Returns (generated tokens int32 [B, window], states);
    column t is the token step t produced.

    ``free`` (bool [B, 1]) marks free slots: they feed their seed token
    at their seed position at every step of the window, as the
    step-by-step engine feeds them, so an MoE batch, whose capacity
    those rows share, is the same in both."""
    gen = []
    tok, pos = tokens, positions
    for _ in range(window):
        lg, states = decode_step(params, cfg, tok, states, pos,
                                 weight_codec=weight_codec)
        nxt = torch.argmax(lg[:, 0], dim=-1).to(torch.int32)[:, None]
        gen.append(nxt)
        if free is None:
            tok, pos = nxt, pos + 1
        else:
            tok = torch.where(free, tokens, nxt)
            pos = torch.where(free, positions, pos + 1)
    return torch.cat(gen, dim=1), states


def compress_params_for_serving(params, tables, mode: str = "qlc",
                                use_kernels: bool = True, type_key_fn=None,
                                whole_shapes=None, column=None,
                                data_dims=None):
    """Wire a parameter tree for compressed serving: large layer-stack
    leaves become block-32 e4m3 symbols, packed into QLC words with
    exactly measured capacity (``mode="qlc"``) or kept raw
    (``mode="e4m3"``), plus bf16 scales; everything else stays dense.
    ``tables`` is a ``CodecTables`` or a per-tensor-type
    ``CodecRegistry`` (with an optional ``type_key_fn(leaf_path) -> type
    name``). ``use_kernels`` is recorded in the manifest; the port
    routes by device. ``params`` may be one model rank's local tree
    (``convert.shard_params``), with ``whole_shapes`` (leaf path ->
    the whole model's shape, ``convert.whole_leaf_shapes``): the wire
    then holds the rank's
    blocks of the leaves the whole tree's wire holds. ``column`` (a
    ``launch.mesh.DataColumn``) with ``data_dims`` (leaf path -> FSDP
    dim): ``params`` holds FSDP blocks, and each wired leaf comes out as
    this rank's chunks of its model-block wire (:func:`place_wire`),
    wired a leaf at a time. Returns ``(wired_params, wire_codec)``; open
    with :func:`open_params`."""
    from repro_torch.comm.weights import compress_groups
    return compress_groups(params, tables, mode=mode,
                           use_kernels=use_kernels, type_key_fn=type_key_fn,
                           whole_shapes=whole_shapes, column=column,
                           data_dims=data_dims)


def serving_manifest(wire_codec, *, kv_spec=None, kv_registry=None) -> dict:
    """JSON-able manifest of a wired parameter tree: per-leaf geometry,
    scheme-ids, the codec registry and the channel placement. With
    ``kv_spec`` (a ``KVCacheSpec``) the KV cache's recipe rides along
    under ``"kv"``, its ``kv/layer{i}`` scheme-ids resolved against
    ``kv_registry`` (default: the wire codec's registry)."""
    from repro_torch.serving.kv_cache import kv_cache_manifest
    m = wire_codec.manifest()
    if kv_spec is not None:
        m["kv"] = kv_cache_manifest(
            kv_spec, kv_registry if kv_registry is not None
            else wire_codec.registry)
    return m


def codec_from_manifest(manifest: dict, use_kernels=None):
    """Rebuild a ``GroupWireCodec`` from :func:`serving_manifest` output
    (either package's): tables re-derived bit-identically from the
    registry, the channel placement carried along. ``use_kernels=None``
    keeps the manifest's recorded toggle; manifests without a channel
    placement get the reference's historic default, True."""
    from repro_torch.comm.weights import GroupWireCodec
    if use_kernels is None and "channel" not in manifest:
        use_kernels = True
    return GroupWireCodec.from_manifest(manifest, use_kernels=use_kernels)


def place_wire(wired_params, column):
    """The rank's place of a weight wire under FSDP: each compressed
    leaf's chunks cut over the data ``column`` (a
    ``launch.mesh.DataColumn``; ``comm.weights.shard_chunks``; a leaf
    whose chunks the column does not divide stays whole), as the
    reference's wire lies over its data axes. ``column`` None: the wire
    as it is."""
    if column is None:
        return wired_params
    from repro_torch.comm.weights import shard_chunks
    return shard_chunks(wired_params, column.index, column.size)


def open_params(wired_params, wire_codec, *, channel=None, axis_name=None,
                axis_size=None, transport=None, column=None):
    """Decode a wired parameter tree back to dense tensors (K2 for QLC
    leaves on the card, the plain version on the CPU).

    With a ``Channel`` bound to a process group
    (``wire_codec.channel(axis, axis_size)``), or the loose
    ``axis_name`` (a mesh axis of the mesh in scope) / ``axis_size`` /
    ``transport``, every compressed leaf is a chunk shard
    (``comm.weights.shard_chunks``) and the wire streams over the group
    (:meth:`GroupWireCodec.open_group_sharded`); the values are
    bit-identical to the whole open. ``column`` (a
    ``launch.mesh.DataColumn``): the wire is placed over the FSDP data
    column (:func:`place_wire`) and opened over it."""
    if column is not None:
        return wire_codec.open_group_sharded(wired_params,
                                             transport=transport,
                                             group=column.group)
    if channel is not None:
        if channel.axis is None:          # local placement: plain open
            return wire_codec.open_group(wired_params)
        return wire_codec.open_group_sharded(
            wired_params, transport=transport, channel=channel)
    if axis_name is None:
        return wire_codec.open_group(wired_params)
    return wire_codec.open_group_sharded(wired_params, axis_name,
                                         axis_size, transport)
