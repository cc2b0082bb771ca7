"""Attention with RoPE and a KV cache: the decode branch of the
reference's ``models/attention.py::attention_block``.

The blocked (flash-style) training/prefill attention is not ported yet
(ROADMAP queue 1, item 7); serving prefills token by token through the
decode branch, as the reference's ``serving.engine.prefill`` does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers

NEG_INF = -2.0 ** 30


class KVCache(NamedTuple):
    k: torch.Tensor        # [B, S_max, KV, H]
    v: torch.Tensor        # [B, S_max, KV, H]
    length: torch.Tensor   # [B] int32 — tokens filled

    @classmethod
    def init(cls, batch: int, max_len: int, kv_heads: int, head_dim: int,
             dtype, device) -> "KVCache":
        return cls(
            k=torch.zeros((batch, max_len, kv_heads, head_dim), dtype=dtype,
                          device=device),
            v=torch.zeros((batch, max_len, kv_heads, head_dim), dtype=dtype,
                          device=device),
            length=torch.zeros((batch,), dtype=torch.int32, device=device),
        )


#: seq axis of the K/V tensors counted from the END (leading dims vary:
#: [B, S, KV, H] per layer, [G, B, S, KV, H] stacked over groups).
KV_SEQ_AXIS = -3


def kv_block_slice(cache: KVCache, t0: int, t1: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token block ``[t0, t1)`` of a cache (views) — the unit the paged
    serving cache evicts and encodes. Works on a per-layer cache or the
    group-stacked decode-states leaf."""
    return (cache.k.narrow(KV_SEQ_AXIS, t0, t1 - t0),
            cache.v.narrow(KV_SEQ_AXIS, t0, t1 - t0))


def kv_block_restore(cache: KVCache, t0: int, t1: int, k: torch.Tensor,
                     v: torch.Tensor) -> KVCache:
    """Write block ``[t0, t1)`` back into the cache — the inverse of
    :func:`kv_block_slice`. Unlike the reference's functional update it
    writes in place (the block's rows of ``cache.k`` / ``cache.v``, which
    may be views of the engine's states) and returns ``cache``."""
    cache.k.narrow(KV_SEQ_AXIS, t0, t1 - t0).copy_(k)
    cache.v.narrow(KV_SEQ_AXIS, t0, t1 - t0).copy_(v)
    return cache


def attention_block(params, x, cfg: ModelConfig, positions,
                    cache: Optional[KVCache] = None):
    """Single-token decode against ``cache``.

    x: [B, 1, D]. Writes k/v at position ``cache.length`` and attends
    over the filled prefix. Returns (out [B, 1, D], new_cache).
    """
    if cache is None or x.shape[1] != 1:
        raise NotImplementedError(
            "only single-token decode against a KV cache is ported; "
            "blocked training/prefill attention waits for ROADMAP queue 1, "
            "item 7")
    if cfg.sliding_window is not None or (
            cfg.pad_heads_multiple
            and cfg.num_heads % cfg.pad_heads_multiple):
        raise NotImplementedError(
            "sliding-window and padded-head attention are not ported")
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    groups = h // kv

    q = torch.einsum("bsd,dnh->bsnh", x, params["wq"].to(x.dtype))
    k = torch.einsum("bsd,dnh->bsnh", x, params["wk"].to(x.dtype))
    v = torch.einsum("bsd,dnh->bsnh", x, params["wv"].to(x.dtype))
    q = layers.apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = layers.apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)

    b = x.shape[0]
    idx = cache.length                                       # [B]
    s_max = cache.k.shape[1]
    pos_iota = torch.arange(s_max, dtype=torch.int32,
                            device=x.device)[None, :, None, None]
    writing = pos_iota == idx[:, None, None, None]           # [B,S,1,1]
    k_new = torch.where(writing, k.to(cache.k.dtype), cache.k)
    v_new = torch.where(writing, v.to(cache.v.dtype), cache.v)
    new_cache = KVCache(k=k_new, v=v_new, length=idx + 1)

    # GQA-grouped decode: contract against the cache per KV head.
    qg = q.reshape(b, 1, kv, groups, hd)
    k_pos = torch.arange(s_max, dtype=torch.int32, device=x.device)
    scale = hd ** -0.5
    scores = (torch.einsum("bqkgd,bskd->bqkgs", qg, k_new).float()
              * scale)                                      # [B,S,KV,G,Smax]
    valid = (k_pos[None, None, None, None, :]
             <= positions[:, :, None, None, None])
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bqkgs,bskd->bqkgd", probs.to(x.dtype), v_new)
    out = out.reshape(b, 1, h, hd)
    return torch.einsum("bsnh,nhd->bsd", out,
                        params["wo"].to(out.dtype)), new_cache
