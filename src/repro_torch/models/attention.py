"""Attention with RoPE: the reference's ``models/attention.py``.

Full-sequence causal attention for training (:func:`dense_attention`,
the O(S^2) reference, and :func:`blocked_attention`, the flash-style
online softmax over KV blocks), in plain PyTorch ops with autograd for
the backward pass, following the reference's formulation: f32 scores
and softmax statistics, the probabilities cast to the compute dtype for
the value product. The reference's TPU memory tricks (a checkpointed
scan over KV blocks) become Python loops; the per-layer checkpoint of
``remat="full"`` bounds what autograd keeps.

Tensor parallelism (training): with a ``launch.mesh.ModelRow`` the
block takes ``wq`` / ``wo`` split over the row by heads when its local
``wq`` holds fewer than the padded heads, and ``wk`` / ``wv`` by KV
heads likewise, each as its spec resolves (:func:`attention_param_specs`).
Each rank attends with its own query heads, each reading the KV head the
whole model's GQA map gives it: its own KV heads' when they are all
local, else the whole ``wk`` / ``wv`` (held whole, or gathered over the
row), whose gradient the row then sums, since each rank's query heads
use only part of them. The output projection's partial sums are summed
over the row.

Serving runs the decode branch of :func:`attention_block`: ``S`` query
tokens written into a KV cache at its length and attending over the
filled prefix, within the sliding window when the config has one (the
engine's prefill goes token by token through it, as the reference's
``serving.engine.prefill`` does). Padded heads (``pad_heads_multiple``)
are zero slices of ``wq`` / ``wo`` held out of the gradient: training
attends with all of them, decode with the real ones only. Over a model
row the decode branch runs the rank's query heads against a cache of
the KV heads they read (:func:`decode_kv_heads`), contracted per KV
head, and sums the ``wo`` rows' partial outputs over the row. Under a
sequence split of the cache (``launch.mesh.SeqShard``) each rank holds a
range of positions and the shard's partial softmax statistics are
combined (:func:`decode_partial`, :func:`combine_partials`); over the
model axis a rank's range holds every KV head, and every rank attends
with the row's gathered query heads (:func:`_decode_tp`, over a row of
one where the model axis has one rank).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import (ModelRow, copy_to_model,
                                     gather_from_model, reduce_from_model)
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


def padded_heads(cfg: ModelConfig) -> int:
    """Query heads after padding to a multiple of ``pad_heads_multiple``."""
    h, m = cfg.num_heads, cfg.pad_heads_multiple
    if not m or h % m == 0:
        return h
    return -(-h // m) * m


def attention_param_specs():
    return {
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
    }


def _freeze_pad(w: torch.Tensor, n_real: int, axis: int) -> torch.Tensor:
    """The pad slice along ``axis`` detached, so padded heads stay
    exactly 0 (the reference's ``stop_gradient``): without it the padded
    heads' uniform softmax gives ``wo``'s pad slice a gradient."""
    pad = w.narrow(axis, n_real, w.shape[axis] - n_real).detach()
    return torch.cat([w.narrow(axis, 0, n_real), pad], dim=axis)


def _expand_kv_padded(x: torch.Tensor, groups: int, n_real: int,
                      hp: int) -> torch.Tensor:
    """GQA expansion to ``hp`` heads: real head h reads kv[h // groups],
    a padded head (its q is 0) reads kv[0]."""
    idx = [min(h_ // groups, x.shape[2] - 1) if h_ < n_real else 0
           for h_ in range(hp)]
    return torch.index_select(x, 2, torch.tensor(idx, device=x.device))


def _repeat_kv(x: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, S, KV, H] -> [B, S, KV*groups, H] (GQA head expansion)."""
    if groups == 1:
        return x
    b, s, kv, h = x.shape
    return x[:, :, :, None, :].expand(b, s, kv, groups, h).reshape(
        b, s, kv * groups, h)


def _mask(q_pos, k_pos, window: Optional[int]):
    """Causal (+ sliding window) mask: [..., Sq, Sk] bool (True = keep)."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if window is not None:
        m &= k_pos[..., None, :] > (q_pos[..., :, None] - window)
    return m


def dense_attention(q, k, v, q_pos, k_pos, window=None):
    """Reference O(S^2) attention. q: [B,Sq,H,D], k/v: [B,Sk,H,D]."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    mask = _mask(q_pos, k_pos, window)[:, None]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def blocked_attention(q, k, v, q_pos, k_pos, window=None, q_block=512,
                      kv_block=1024, causal_skip=False,
                      score_dtype=torch.float32):
    """Flash-style attention: q blocks in turn, an online softmax over kv
    blocks, scores accumulated in ``score_dtype`` and kept in f32.
    Shapes as :func:`dense_attention`. ``causal_skip`` is accepted for
    the reference's signature; as there, no block is skipped."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    q_block = min(q_block, sq)
    kv_block = min(kv_block, sk)
    if sq % q_block or sk % kv_block:
        raise ValueError(f"sequence lengths {sq}/{sk} must be multiples of "
                         f"the blocks {q_block}/{kv_block}")
    scale = hd ** -0.5
    outs = []
    for q0 in range(0, sq, q_block):
        qi = q[:, q0:q0 + q_block].to(score_dtype)
        qpi = q_pos[:, q0:q0 + q_block]
        acc = torch.zeros((b, h, q_block, hd), dtype=torch.float32,
                          device=q.device)
        m_run = torch.full((b, h, q_block), NEG_INF, dtype=torch.float32,
                           device=q.device)
        l_run = torch.zeros((b, h, q_block), dtype=torch.float32,
                            device=q.device)
        for k0 in range(0, sk, kv_block):
            kj = k[:, k0:k0 + kv_block]
            vj = v[:, k0:k0 + kv_block]
            s_ij = torch.einsum("bqhd,bkhd->bhqk", qi,
                                kj.to(score_dtype)).float() * scale
            msk = _mask(qpi, k_pos[:, k0:k0 + kv_block], window)[:, None]
            s_ij = torch.where(msk, s_ij, torch.full_like(s_ij, NEG_INF))
            m_new = torch.maximum(m_run, s_ij.amax(dim=-1))
            p = torch.exp(s_ij - m_new[..., None])
            alpha = torch.exp(m_run - m_new)
            l_run = l_run * alpha + p.sum(dim=-1)
            acc = (acc * alpha[..., None]
                   + torch.einsum("bhqk,bkhd->bhqd", p.to(vj.dtype),
                                  vj).float())
            m_run = m_new
        out = acc / torch.clamp(l_run[..., None], min=1e-30)
        outs.append(out.transpose(1, 2).to(q.dtype))
    return torch.cat(outs, dim=1)


def _write_cache(cache: KVCache, k: torch.Tensor, v: torch.Tensor,
                 offset: int = 0) -> KVCache:
    """``k`` / ``v`` [B, S, KV, H] written at each row's ``cache.length``;
    the length advanced by S. One token is a masked select over the
    cache, as the reference's; S tokens a scatter at rows starting at
    ``length`` clamped to ``S_max - S`` (``dynamic_update_slice``'s
    clamp). ``offset``: the position of the cache's first row (a
    sequence shard's, one token only): the token lands only on the
    shard whose range holds it."""
    b, s_in = k.shape[:2]
    idx = cache.length                                       # [B]
    s_max = cache.k.shape[1]
    if s_in == 1:
        pos_iota = torch.arange(offset, offset + s_max, dtype=torch.int32,
                                device=k.device)[None, :, None, None]
        writing = pos_iota == idx[:, None, None, None]       # [B,S,1,1]
        k_new = torch.where(writing, k.to(cache.k.dtype), cache.k)
        v_new = torch.where(writing, v.to(cache.v.dtype), cache.v)
    else:
        start = torch.clamp(idx, 0, s_max - s_in).long()
        rows = start[:, None] + torch.arange(s_in, device=k.device)
        rows = rows[:, :, None, None].expand(-1, -1, *k.shape[2:])
        k_new = cache.k.scatter(1, rows, k.to(cache.k.dtype))
        v_new = cache.v.scatter(1, rows, v.to(cache.v.dtype))
    return KVCache(k=k_new, v=v_new, length=idx + s_in)


def _tp_projections(params, x, cfg: ModelConfig, row):
    """The training branch's q / k / v of this rank's query heads over
    the model ``row``, and the ``wo`` block to project them with: see the
    module docstring. Returns (q, k and v with one head per local query
    head, wo, whether the output is partial over the row)."""
    h, kv = cfg.num_heads, cfg.num_kv_heads
    groups, hp = h // kv, padded_heads(cfg)
    wq, wk, wv, wo = (params[k] for k in ("wq", "wk", "wv", "wo"))
    hl, kvl = wq.shape[1], wk.shape[1]
    q_split, kv_split = hl != hp, kvl != kv
    q0 = row.index * hl if q_split else 0
    if hp != h:
        n_real = min(max(h - q0, 0), hl)
        wq = _freeze_pad(wq, n_real, 1)
        wo = _freeze_pad(wo, n_real, 0)
    # the KV head of each local query head (a padded one reads head 0)
    need = [(q0 + j) // groups if q0 + j < h else 0 for j in range(hl)]
    k0 = row.index * kvl if kv_split else 0
    if kv_split and all(k0 <= n < k0 + kvl for n in need):
        need = [n - k0 for n in need]
    elif kv_split:
        wk, wv = (gather_from_model(w, 1, row) for w in (wk, wv))
    if q_split and not (kv_split and wk.shape[1] == kvl):
        # whole KV weights serve part of the heads here: the row sums
        # their gradient
        wk, wv = copy_to_model(wk, row), copy_to_model(wv, row)
    if q_split:
        x = copy_to_model(x, row)
    q = torch.einsum("bsd,dnh->bsnh", x, wq.to(x.dtype))
    k = torch.einsum("bsd,dnh->bsnh", x, wk.to(x.dtype))
    v = torch.einsum("bsd,dnh->bsnh", x, wv.to(x.dtype))
    if need != list(range(k.shape[2])):
        k, v = (torch.index_select(t, 2, torch.tensor(need, device=x.device))
                for t in (k, v))
    return q, k, v, wo, q_split


def _row_heads(cfg: ModelConfig, index: int, size: int):
    """This rank's query heads over a model row of ``size``: (whether
    ``heads`` is split, the local heads ``hl``, the first one ``q0``),
    as ``wq``'s resolved spec cuts its padded heads."""
    hp = padded_heads(cfg)
    q_split = size > 1 and hp % size == 0
    hl = hp // size if q_split else hp
    return q_split, hl, index * hl if q_split else 0


def decode_kv_heads(cfg: ModelConfig, index: int = 0, size: int = 1
                    ) -> Tuple[int, ...]:
    """The KV heads the decode cache of rank ``index`` of a model row of
    ``size`` holds, ascending: its ``kv_heads`` block where the KV heads
    divide the row and its query heads read no other (the block
    ``decode_states_specs`` resolves to), else the KV heads its real
    query heads read through the GQA map, as :func:`_tp_projections`
    picks them (a rank whose heads are all padding holds head 0).
    Every KV head is held by at least one rank."""
    h, kv = cfg.num_heads, cfg.num_kv_heads
    groups = h // kv
    _, hl, q0 = _row_heads(cfg, index, size)
    need = sorted({(q0 + j) // groups for j in range(hl) if q0 + j < h})
    if size > 1 and kv % size == 0:
        kvl = kv // size
        block = range(index * kvl, (index + 1) * kvl)
        if all(n in block for n in need):
            return tuple(block)
    if size == 1:
        return tuple(range(kv))
    return tuple(need) or (0,)


def _kv_gathered(cfg: ModelConfig, size: int) -> bool:
    """Whether decode over a row of ``size`` that splits the KV heads
    gathers the row's k / v: some rank's cache holds heads besides its
    own block (every rank then takes part in the gather)."""
    kvl = cfg.num_kv_heads // size
    return any(decode_kv_heads(cfg, r, size)
               != tuple(range(r * kvl, (r + 1) * kvl)) for r in range(size))


def _decode_tp(params, x, cfg: ModelConfig, positions, cache: KVCache,
               row, shard=None):
    """The decode branch over a model row: this rank's query heads (its
    ``wq`` block, padded heads left out), the k / v of the KV heads its
    cache holds (:func:`decode_kv_heads`: from its ``wk`` / ``wv`` block,
    from the whole leaves, or, where the KV heads are split but its
    query heads read another rank's, from the row's k / v gathered),
    written into its cache (under a sequence shard, on the rank whose
    range holds the token); the grouped decode over those heads, and its
    ``wo`` rows' partial output summed over the row. Under a shard over
    the model axis (the reference's ``kv_seq -> model`` and ``("data",
    "model")``) the cache holds every KV head of the rank's range: the
    token's k / v of every head are written, the row's query heads
    gathered, and every head's partials combined over the shard (so
    every rank of it gets the same bits) before the rank keeps its own
    heads for ``wo``."""
    h, kv = cfg.num_heads, cfg.num_kv_heads
    groups = h // kv
    wq, wk, wv, wo = (params[k] for k in ("wq", "wk", "wv", "wo"))
    q_split, hl, q0 = _row_heads(cfg, row.index, row.size)
    if wq.shape[1] != hl:
        raise ValueError(f"wq holds {wq.shape[1]} heads, the row's spec "
                         f"gives a rank {hl}")
    n_real = min(max(h - q0, 0), hl)
    every = shard is not None and shard.over_model
    sel = (tuple(range(kv)) if every
           else decode_kv_heads(cfg, row.index, row.size))  # contiguous
    kv_split = wk.shape[1] != kv
    if not kv_split:                            # whole: my heads' slices
        wk, wv = (w.narrow(1, sel[0], len(sel)) for w in (wk, wv))
    k = torch.einsum("bsd,dnh->bsnh", x, wk.to(x.dtype))
    v = torch.einsum("bsd,dnh->bsnh", x, wv.to(x.dtype))
    if kv_split and (every or _kv_gathered(cfg, row.size)):
        # this rank holds heads of other ranks' blocks
        k, v = (gather_from_model(t, 2, row).narrow(2, sel[0], len(sel))
                for t in (k, v))
    if every:
        # every query head (padded ones' rows dropped), the row's gathered
        q = torch.einsum("bsd,dnh->bsnh", x, wq.to(x.dtype))
        if q_split:
            q = gather_from_model(q, 2, row)
        q = q[:, :, :h]
        need = [j // groups for j in range(h)]
    else:
        q = torch.einsum("bsd,dnh->bsnh", x, wq[:, :n_real].to(x.dtype))
        # local query head j reads cache head need[j]
        need = [(q0 + j) // groups - sel[0] for j in range(n_real)]
    q = layers.apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = layers.apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    offset = 0 if shard is None else shard.index * cache.k.shape[1]
    new_cache = _write_cache(cache, k, v, offset)
    out = _decode_attend(q, new_cache, positions, cfg, need, shard)
    if every:
        out = out[:, :, q0:q0 + n_real]
    out = torch.einsum("bsnh,nhd->bsd", out, wo[:n_real].to(out.dtype))
    return (reduce_from_model(out, row) if q_split else out), new_cache


def _decode_scores(q, cache: KVCache, positions, cfg: ModelConfig, need,
                   offset: int = 0):
    """The f32 scores of q [B, S, n, H] against ``cache``, whose first
    row is position ``offset``, query head ``j`` reading cache head
    ``need[j]``: contracted per KV head (GQA-grouped, no head expansion)
    where each cache head serves the same number of consecutive query
    heads, else against the cache expanded to the query heads. Positions
    past the query's own, or outside the sliding window, hold
    ``NEG_INF``. Returns (scores [B, S, KV, G, S_max], the valid mask,
    the value cache it pairs with)."""
    b, s_in, n, hd = q.shape
    kc, vc = cache.k, cache.v
    n_kv = kc.shape[2]
    g = n // n_kv if n_kv and n % n_kv == 0 else 0
    if not g or need != [j // g for j in range(n)]:
        idx = torch.tensor(need, device=q.device, dtype=torch.long)
        kc, vc = kc.index_select(2, idx), vc.index_select(2, idx)
        n_kv, g = n, 1
    qg = q.reshape(b, s_in, n_kv, g, hd)
    k_pos = torch.arange(offset, offset + kc.shape[1], dtype=torch.int32,
                         device=q.device)[None, None, None, None, :]
    q_pos = positions[:, :, None, None, None]
    scores = (torch.einsum("bqkgd,bskd->bqkgs", qg, kc).float()
              * hd ** -0.5)                                 # [B,S,KV,G,Smax]
    valid = k_pos <= q_pos
    if cfg.sliding_window is not None:
        valid &= k_pos > q_pos - cfg.sliding_window
    return scores.masked_fill_(~valid, NEG_INF), valid, vc


def _grouped_decode(q, cache: KVCache, positions, cfg: ModelConfig,
                    need) -> torch.Tensor:
    """q [B, S, n, H] over the filled prefix of ``cache`` (and within the
    sliding window), query head ``j`` reading cache head ``need[j]``
    (:func:`_decode_scores`). [B, S, n, H]."""
    scores, _, vc = _decode_scores(q, cache, positions, cfg, need)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bqkgs,bskd->bqkgd", probs.to(q.dtype), vc)
    return out.reshape(q.shape)


class DecodePartial(NamedTuple):
    """One sequence shard's part of a decode step's attention, in f32:
    the row max of its valid scores (``NEG_INF`` where it has none), the
    sum of their exponentials against it, and the unnormalised weighted
    values."""
    m: torch.Tensor        # [B, S, KV, G]
    l: torch.Tensor        # [B, S, KV, G]
    acc: torch.Tensor      # [B, S, KV, G, H]


def decode_partial(q, cache: KVCache, positions, cfg: ModelConfig, need,
                   offset: int) -> DecodePartial:
    """The partial-statistics form of :func:`_grouped_decode` over a
    cache that holds positions ``[offset, offset + S_max)``: a range with
    no valid position (past the length, or outside the window) weighs
    exactly zero, although ``NEG_INF`` keeps its max finite."""
    scores, valid, vc = _decode_scores(q, cache, positions, cfg, need,
                                       offset)
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None]).masked_fill_(~valid, 0.0)
    acc = torch.einsum("bqkgs,bskd->bqkgd", p, vc.float())
    return DecodePartial(m=m, l=p.sum(dim=-1), acc=acc)


def combine_partials(parts) -> torch.Tensor:
    """The attention of the whole sequence from its shards' partials, in
    shard order: each weighted by ``exp(m - max m)``, and by 0 where it
    saw no valid position. The same bits wherever the same partials
    come in the same order, on any rank. [B, S, KV, G, H] f32."""
    top = parts[0].m
    for p in parts[1:]:
        top = torch.maximum(top, p.m)
    total = out = None
    for p in parts:
        w = torch.where(p.l > 0, torch.exp(p.m - top),
                        torch.zeros_like(p.m))
        total = w * p.l if total is None else total + w * p.l
        wa = w[..., None] * p.acc
        out = wa if out is None else out + wa
    return out / total[..., None]


def _seq_sharded_decode(q, cache: KVCache, positions, cfg: ModelConfig,
                        need, shard) -> torch.Tensor:
    """:func:`_grouped_decode` over a cache split by sequence over
    ``shard`` (``launch.mesh.SeqShard``: the data column, the model row
    or the mesh): this rank's partial (:func:`decode_partial`)
    all-gathered over the shard and combined in rank order
    (:func:`combine_partials`), so every rank of it gets the same bits.
    [B, S, n, H]."""
    import torch.distributed as dist
    part = decode_partial(q, cache, positions, cfg, need,
                          shard.index * cache.k.shape[1])
    flat = torch.cat([part.m[..., None], part.l[..., None], part.acc],
                     dim=-1).contiguous()
    got = [torch.empty_like(flat) for _ in range(shard.size)]
    dist.all_gather(got, flat, group=shard.group)
    out = combine_partials([DecodePartial(m=t[..., 0], l=t[..., 1],
                                          acc=t[..., 2:]) for t in got])
    return out.to(q.dtype).reshape(q.shape)


def _decode_attend(q, cache: KVCache, positions, cfg: ModelConfig, need,
                   shard) -> torch.Tensor:
    if shard is None:
        return _grouped_decode(q, cache, positions, cfg, need)
    if q.shape[1] != 1:
        raise ValueError(f"a decode step over a sequence-split cache "
                         f"takes one token, got {q.shape[1]}")
    return _seq_sharded_decode(q, cache, positions, cfg, need, shard)


def attention_block(params, x, cfg: ModelConfig, positions,
                    cache: Optional[KVCache] = None, row=None, shard=None):
    """Self-attention over the whole sequence (training), or, with
    ``cache``, decode.

    x: [B, S, D]. With ``cache`` it writes the S tokens' k/v from
    position ``cache.length`` and attends over the filled prefix, each
    query causally at its own position (and within the sliding window).
    ``row``: the model row the weights may be split over (module
    docstring); decode over it holds the rank's KV heads in ``cache``
    (:func:`decode_kv_heads`). ``shard`` (a ``launch.mesh.SeqShard``):
    the cache holds the rank's range of positions of a sequence split
    over the data column, the model row or the mesh (over the model
    axis, of every KV head: :func:`_decode_tp`, over a row of one when
    ``row`` is None); a one-token decode
    step writes the token on the rank whose range holds it and combines
    the shard's partial attentions (:func:`decode_partial`,
    :func:`combine_partials`).
    Returns (out [B, S, D], new_cache or None).
    """
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    groups = h // kv
    hp = padded_heads(cfg)
    if cache is not None and (row is not None or (
            shard is not None and shard.over_model)):
        return _decode_tp(params, x, cfg, positions, cache,
                          row or ModelRow(None, 1, 0), shard)
    if row is not None:
        return _attention_tp(params, x, cfg, positions, row), None

    wq, wo = params["wq"], params["wo"]
    if hp != h:
        wq = _freeze_pad(wq, h, 1)
        wo = _freeze_pad(wo, h, 0)
    q = torch.einsum("bsd,dnh->bsnh", x, wq.to(x.dtype))
    k = torch.einsum("bsd,dnh->bsnh", x, params["wk"].to(x.dtype))
    v = torch.einsum("bsd,dnh->bsnh", x, params["wv"].to(x.dtype))
    q = layers.apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = layers.apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)

    if cache is None:
        if hp != h:
            kk = _expand_kv_padded(k, groups, h, hp)
            vv = _expand_kv_padded(v, groups, h, hp)
        else:
            kk, vv = _repeat_kv(k, groups), _repeat_kv(v, groups)
        if cfg.attn_impl == "dense":
            out = dense_attention(q, kk, vv, positions, positions,
                                  cfg.sliding_window)
        else:
            out = blocked_attention(
                q, kk, vv, positions, positions, cfg.sliding_window,
                cfg.attn_q_block, cfg.attn_kv_block, cfg.causal_skip,
                score_dtype=getattr(torch, cfg.attn_score_dtype))
        return torch.einsum("bsnh,nhd->bsd", out, wo.to(out.dtype)), None

    offset = 0 if shard is None else shard.index * cache.k.shape[1]
    new_cache = _write_cache(cache, k, v, offset)
    # GQA-grouped decode over the real heads
    out = _decode_attend(q[:, :, :h], new_cache, positions, cfg,
                         [j // groups for j in range(h)], shard)
    return torch.einsum("bsnh,nhd->bsd", out,
                        wo[:h].to(out.dtype)), new_cache


def _attention_tp(params, x, cfg: ModelConfig, positions, row):
    """The training branch over a model row (:func:`_tp_projections`)."""
    q, k, v, wo, q_split = _tp_projections(params, x, cfg, row)
    q = layers.apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = layers.apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    if cfg.attn_impl == "dense":
        out = dense_attention(q, k, v, positions, positions,
                              cfg.sliding_window)
    else:
        out = blocked_attention(
            q, k, v, positions, positions, cfg.sliding_window,
            cfg.attn_q_block, cfg.attn_kv_block, cfg.causal_skip,
            score_dtype=getattr(torch, cfg.attn_score_dtype))
    out = torch.einsum("bsnh,nhd->bsd", out, wo.to(out.dtype))
    return reduce_from_model(out, row) if q_split else out
