"""Per-tensor-type codec calibration (paper §7: one LUT per tensor type,
derived apriori from a histogram of the quantized data).

Weights: the symbol histograms come out of K1's ``emit_hist`` side
output, so on the card no plain quantizer runs: block-32 symbols do not
depend on how the flat tensor is cut into chunk rows, so the bulk goes
through K1 in rows of 1024 and a ragged tail in rows of 32.

Over a mesh (:func:`histogram_of_local_tree`) each rank counts its
blocks of the split leaves, the first rank along an axis the leaves that
axis holds whole, and the mesh sums the counts: every rank registers the
codec the whole tree gives.

Gradients (:func:`calibrate_for_gradients`, :func:`calibrate_for_tensor`):
the flat tensor is quantized in pieces on its device and its symbols are
counted there by the histogram kernel K6 (``kernels.ops.histogram``), in
launches of at most 2^31 - 1 symbols summed in int64. The empirical slot
sizing (:func:`empirical_plan`) gathers each symbol's code length and
sums it per chunk on the same device; only the per-chunk sums come down
to the host, where the percentile and the margin are computed exactly as
in the reference.

KV / decode states (:func:`calibrate_kv_entries`): the lossless mode's
symbols are the states' bytes, split into byte planes by a little-endian
``view(torch.uint8)`` on the states' device, and counted there by K6.

MoE expert wire (:func:`calibrate_moe_entries`): one forward pass with
traffic capture, each MoE layer's dispatch and combine buffers, their
block-32 e4m3 symbols counted by K6.
"""
from __future__ import annotations

import dataclasses
import math

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.comm.planner import CommPlan, plan_for_tables
from repro_torch.core import adapt, codec
from repro_torch.core.lut import CodecTables, identity_tables
from repro_torch.core.schemes import TABLE1, QLCScheme
from repro_torch.kernels import histogram256 as _hist
from repro_torch.kernels import ops
from repro_torch.models.transformer import (leaf_grads, pytree_leaves,
                                           pytree_unflatten, tree_leaves)
from repro_torch.quant import e4m3

_ROW = 1024
# Any tables give the same symbols; the encode half of K1 is unused.
_TABLES = identity_tables(TABLE1)


def histogram_of_quantized(x: torch.Tensor) -> np.ndarray:
    """float tensor -> counts[256] (float64) of its block-32 e4m3
    symbols; a trailing partial block is left out, as in the reference."""
    flat = x.reshape(-1)
    n = (flat.shape[0] // e4m3.BLOCK) * e4m3.BLOCK
    bulk = (n // _ROW) * _ROW
    counts = np.zeros(256, dtype=np.float64)
    for part, k in ((flat[:bulk], _ROW), (flat[bulk:n], e4m3.BLOCK)):
        if part.numel() == 0:
            continue
        *_, hist = ops.quantize_encode(part.reshape(-1, k), _TABLES,
                                       codec.worst_case_words(k),
                                       emit_hist=True)
        counts += hist.cpu().numpy()
    return counts


def histogram_of_tree(tree) -> np.ndarray:
    """Tree of float tensors -> summed counts[256] of their e4m3
    symbols, leaf by leaf: the calibration input for
    ``CodecRegistry.register("default", ...)``."""
    counts = np.zeros(256, dtype=np.float64)
    for leaf in tree_leaves(tree):
        counts += histogram_of_quantized(leaf)
    return counts


def block32_aligned(local_shape, dim: Optional[int]) -> bool:
    """Whether a leaf cut along ``dim`` into blocks of ``local_shape``
    keeps the whole leaf's block-32 groups whole: each rank's contiguous
    runs of the whole flat leaf (its ``local_shape[dim:]`` entries) are a
    multiple of 32 long, so every group of 32, and its scale, lies in one
    rank's block. A whole leaf (``dim`` None) is."""
    return dim is None or math.prod(local_shape[dim:]) % e4m3.BLOCK == 0


def histogram_of_local_tree(tree, cfg, mesh=None) -> np.ndarray:
    """:func:`histogram_of_tree` of the whole model from ``tree``, this
    rank's local tree (``convert.shard_params``: its model block of each
    leaf, and under rules in scope that cut parameters by FSDP its ``data
    x model`` block) on ``mesh`` (default: the mesh in scope), the same
    counts on every rank: a block counted on its rank where the whole
    leaf's block-32 groups stay whole in it (:func:`block32_aligned`), a
    leaf the data column (or the model row) holds whole counted on its
    first data (or model) index only; any other leaf gathered whole and
    counted on rank ``(0, 0)``; the counts summed over the mesh. Exact:
    the counts are integers, summed in float64. With no mesh, the
    tree's own."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import (DataColumn, current_mesh,
                                         gather_blocks)
    from repro_torch.parallel import sharding
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None:
        return histogram_of_tree(tree)
    d_i, m_i = mesh.coords
    dims = pytree_leaves(sharding.leaf_dims(cfg, mesh.data, mesh.model,
                                            split=True))
    counts = np.zeros(256, dtype=np.float64)
    for leaf, (ddim, mdim) in zip(pytree_leaves(tree), dims):
        cut = [x for x in (ddim, mdim) if x is not None]
        if block32_aligned(tuple(leaf.shape), max(cut) if cut else None):
            if (ddim is not None or d_i == 0) and (mdim is not None
                                                   or m_i == 0):
                counts += histogram_of_quantized(leaf)
            continue
        if ddim is not None:
            leaf = gather_blocks(leaf, ddim, DataColumn(
                mesh.data_group, mesh.data, d_i))
        if mdim is not None:
            parts = [torch.empty_like(leaf) for _ in range(mesh.model)]
            dist.all_gather(parts, leaf.contiguous(), group=mesh.model_group)
            leaf = torch.cat(parts, dim=mdim)
            del parts
        if d_i == 0 and m_i == 0:
            counts += histogram_of_quantized(leaf)
        del leaf
    total = torch.from_numpy(counts)
    if mesh.size > 1:
        dist.all_reduce(total, group=mesh.world_group)
    return total.numpy()


def symbol_counts(syms: torch.Tensor) -> np.ndarray:
    """u8 symbols on any device -> counts[256] (float64), through K6 on
    the card in launches of at most 2^31 - 1 symbols, summed in int64."""
    flat = syms.reshape(-1)
    total = torch.zeros(256, dtype=torch.int64, device=flat.device)
    for s in range(0, flat.numel(), _hist.MAX_SYMBOLS):
        total += ops.histogram(flat[s:s + _hist.MAX_SYMBOLS]).long()
    return total.cpu().numpy().astype(np.float64)


def _chunk_bit_sums(tables: CodecTables, syms: torch.Tensor,
                    chunk_symbols: int, n_chunks: int) -> np.ndarray:
    """int64 [n_chunks]: the code bits of each whole chunk of ``syms``,
    gathered and summed on the symbols' device, piece by piece."""
    enc_len = torch.as_tensor(np.asarray(tables.enc_len, np.int32),
                              device=syms.device)
    sums = torch.empty(n_chunks, dtype=torch.int64, device=syms.device)
    step = max(1, e4m3.PIECE // chunk_symbols)
    for c0 in range(0, n_chunks, step):
        c1 = min(n_chunks, c0 + step)
        part = syms[c0 * chunk_symbols:c1 * chunk_symbols].to(torch.int32)
        lens = torch.index_select(enc_len, 0, part)
        sums[c0:c1] = lens.reshape(c1 - c0, chunk_symbols).sum(
            dim=1, dtype=torch.int64)
    return sums.cpu().numpy()


def empirical_plan(tables: CodecTables,
                   syms: Union[torch.Tensor, np.ndarray], plan: CommPlan,
                   *, chunk_symbols: int = 1024,
                   target_escape_prob: float = 1e-6,
                   max_pool_slots_per_1k: Optional[int] = None,
                   drift_margin_bits: Optional[float] = None) -> CommPlan:
    """Re-size a plan's chunk slot from the *measured* per-chunk bit-count
    distribution of a representative symbol stream: the 99.9th
    percentile plus ``drift_margin_bits`` per symbol (default: the
    plan's own). Streams shorter than 8 chunks keep the plan.
    ``max_pool_slots_per_1k`` caps the escape pool for callers with a
    raw fallback for incompressible streams (the paged KV cache)."""
    if drift_margin_bits is None:
        drift_margin_bits = plan.drift_margin_bits
    syms = torch.as_tensor(syms).reshape(-1)
    n_chunks = syms.numel() // chunk_symbols
    if n_chunks < 8:
        return plan
    sums = _chunk_bit_sums(tables, syms, chunk_symbols, n_chunks)
    q = float(np.quantile(sums, 0.999))
    bits = min(8.0 * chunk_symbols, q + drift_margin_bits * chunk_symbols)
    cap_words = max(1, int(np.ceil(bits / 32)))
    emp_escape = float((sums > cap_words * 32).mean())
    pool = max(8, int(np.ceil(emp_escape * 1024 * 8)) + 8)
    if max_pool_slots_per_1k is not None:
        pool = min(max_pool_slots_per_1k, pool)
    return CommPlan(
        chunk_symbols=chunk_symbols,
        capacity_words=cap_words,
        pool_slots_per_1k=pool,
        expected_bits_per_symbol=plan.expected_bits_per_symbol,
        escape_prob_bound=max(emp_escape, target_escape_prob),
        drift_margin_bits=drift_margin_bits,
    )


def quantized_symbols(x: torch.Tensor) -> torch.Tensor:
    """float tensor -> u8 [n] block-32 e4m3 symbols of its flattened
    values, on its device; a trailing partial block is left out, as in
    the reference."""
    flat = x.reshape(-1)
    n = (flat.shape[0] // e4m3.BLOCK) * e4m3.BLOCK
    codes, _ = e4m3.quantize_block32_pieces(flat[:n].float())
    return codes


def calibrate_for_tensor(x: torch.Tensor,
                         scheme: Optional[QLCScheme] = None,
                         chunk_symbols: int = 1024,
                         target_escape_prob: float = 1e-6,
                         allow_search: bool = False,
                         empirical: bool = True,
                         ) -> Tuple[CodecTables, CommPlan]:
    """Histogram a representative tensor and derive tables + wire plan.

    ``empirical=True`` sizes the chunk slot from the measured per-chunk
    bit counts (:func:`empirical_plan`) rather than an iid Hoeffding
    bound: a whole gradient vector mixes tensor types whose local
    statistics differ, so its chunk sums are far more dispersed than iid
    sampling of the global PMF predicts."""
    codes = quantized_symbols(x)
    counts = np.maximum(symbol_counts(codes), 1e-6)
    tables = adapt.calibrate_tables(counts, scheme=scheme,
                                    allow_search=allow_search)
    plan = plan_for_tables(tables, counts, chunk_symbols=chunk_symbols,
                           target_escape_prob=target_escape_prob)
    if empirical:
        plan = empirical_plan(tables, codes, plan,
                              chunk_symbols=chunk_symbols,
                              target_escape_prob=target_escape_prob)
    return tables, plan


def flat_gradient(model_cfg, params, batch) -> torch.Tensor:
    """One backward pass of ``next_token_loss`` over ``batch`` -> the
    gradient leaves flattened into one f32 vector, in the reference's
    pytree order."""
    from repro_torch.models import next_token_loss
    live = [p.detach().requires_grad_(True) for p in pytree_leaves(params)]
    loss = next_token_loss(pytree_unflatten(params, live), model_cfg,
                           batch["tokens"], batch["labels"])
    grads = leaf_grads(loss, live)
    return torch.cat([g.reshape(-1).float() for g in grads])


def calibrate_for_gradients(model_cfg, params, batch,
                            chunk_symbols: int = 1024,
                            allow_search: bool = False,
                            ) -> Tuple[CodecTables, CommPlan]:
    """One backward pass -> gradient histogram (K6) -> tables + plan."""
    return calibrate_for_tensor(flat_gradient(model_cfg, params, batch),
                                chunk_symbols=chunk_symbols,
                                allow_search=allow_search)


# --------------------------------------------------------------------------
# Per-layer KV codecs (serving paged cache)
# --------------------------------------------------------------------------

def _value_bytes(a: torch.Tensor) -> torch.Tensor:
    """u8 [n_values, itemsize]: the little-endian bytes of a tensor."""
    return a.contiguous().reshape(-1).view(torch.uint8).reshape(
        -1, a.element_size())


def kv_symbol_stream(arrays, mode: str = "qlc") -> torch.Tensor:
    """Decode-state tensors -> the u8 symbol stream the KV codec sees, on
    their device. ``"qlc"`` (lossless): their bytes, concatenated.
    ``"e4m3"``: block-32 e4m3 symbols of their values (a trailing
    partial block is left out)."""
    if mode == "e4m3":
        parts = []
        for a in arrays:
            flat = a.float().reshape(-1)
            n = (flat.shape[0] // e4m3.BLOCK) * e4m3.BLOCK
            if n:
                parts.append(e4m3.quantize_block32(flat[:n])[0])
        return torch.cat(parts) if parts else torch.zeros(0, dtype=torch.uint8)
    if not arrays:
        return torch.zeros(0, dtype=torch.uint8)
    return torch.cat([_value_bytes(a).reshape(-1) for a in arrays])


def byte_planes(arrays) -> Dict[Tuple[int, int], torch.Tensor]:
    """Byte-plane decomposition of state tensors (the lossless mode's
    symbol streams): little-endian byte *j* of every ``itemsize``-wide
    value, pooled across tensors in order, ``{(itemsize, j): u8
    stream}``. Sign/exponent planes code to a few bits while mantissa
    planes are near-uniform, so each plane gets its own codec."""
    groups: Dict[int, list] = {}
    for a in arrays:
        b = _value_bytes(a)
        groups.setdefault(b.shape[1], []).append(b)
    out: Dict[Tuple[int, int], torch.Tensor] = {}
    for isz in sorted(groups):
        mat = torch.cat(groups[isz]) if len(groups[isz]) > 1 \
            else groups[isz][0]
        for j in range(isz):
            out[(isz, j)] = mat[:, j].contiguous()
    return out


def _layer_index(key) -> int:
    if isinstance(key, int):
        return key
    s = str(key)
    return int(s[1:] if s.startswith("l") else s)


def calibrate_kv_entries(registry, layer_arrays, *, mode: str = "qlc",
                         chunk_symbols: int = 1024,
                         target_escape_prob: float = 1e-4,
                         prefix: str = "kv",
                         plane_split_min_symbols: Optional[int] = None,
                         merge_tol: float = 0.05,
                         allow_search: bool = False) -> Dict[str, object]:
    """Calibrate per-layer KV codecs into ``registry``.

    ``layer_arrays`` maps layer keys (``"l0"``/``0``/...) to the state
    tensors that layer's cache blocks carry. ``"e4m3"`` mode registers
    one codec per layer under ``f"{prefix}/layer{i}"``; the lossless
    ``"qlc"`` mode one per byte plane under
    ``f"{prefix}/layer{i}/w{itemsize}b{j}"``, or one interleaved codec
    under the base name for layers whose planes are shorter than
    ``plane_split_min_symbols`` (default ``2 * chunk_symbols``). The
    layout is recorded by which names exist.

    Streams whose normalized histograms lie within total-variation
    distance ``merge_tol`` of a group's first member share one set of
    tables built from the group's summed counts (one scheme-id); each
    stream keeps its own empirically sized plan. Returns ``{name:
    CodecEntry}`` in layer order.
    """
    if plane_split_min_symbols is None:
        plane_split_min_symbols = 2 * chunk_symbols

    pending = []                      # [(name, syms)]
    layout: list = []                 # names in output order
    for key in sorted(layer_arrays, key=_layer_index):
        base = f"{prefix}/layer{_layer_index(key)}"
        if mode == "e4m3":
            streams = [(base, kv_symbol_stream(layer_arrays[key], mode))]
        else:
            planes = byte_planes(layer_arrays[key])
            if min((p.numel() for p in planes.values()), default=0) \
                    >= plane_split_min_symbols:
                streams = [(f"{base}/w{isz}b{j}", plane)
                           for (isz, j), plane in planes.items()]
            else:
                streams = [(base,
                            kv_symbol_stream(layer_arrays[key], "qlc"))]
        for name, syms in streams:
            layout.append(name)
            if name not in registry:
                pending.append((name, syms))

    groups = []   # [{pmf, counts, members: [(name, syms, counts)]}]
    for name, syms in pending:
        counts = np.maximum(symbol_counts(syms), 1e-6)
        pmf = counts / counts.sum()
        for g in groups:
            if merge_tol > 0 and \
                    0.5 * float(np.abs(pmf - g["pmf"]).sum()) <= merge_tol:
                g["counts"] += counts
                g["members"].append((name, syms, counts))
                break
        else:
            groups.append({"pmf": pmf, "counts": counts.copy(),
                           "members": [(name, syms, counts)]})

    entries = {}
    for g in groups:
        tables = adapt.calibrate_tables(g["counts"],
                                        allow_search=allow_search)
        for name, syms, counts in g["members"]:
            plan = plan_for_tables(tables, counts,
                                   chunk_symbols=chunk_symbols,
                                   target_escape_prob=target_escape_prob)
            # Capped pool: the paged cache wires incompressible streams
            # raw (codec_wins), so the pool never covers a pathological
            # escape rate here.
            plan = empirical_plan(tables, syms, plan,
                                  chunk_symbols=chunk_symbols,
                                  target_escape_prob=target_escape_prob,
                                  max_pool_slots_per_1k=64)
            entries[name] = registry.register_tables(name, tables, plan,
                                                     counts=counts)
    return {name: entries.get(name, registry[name]) for name in layout}


# --------------------------------------------------------------------------
# MoE expert-wire codecs
# --------------------------------------------------------------------------

def calibrate_moe_entries(registry, model_cfg, params, batch, *,
                          chunk_symbols: int = 1024,
                          target_escape_prob: float = 1e-4,
                          dispatch_name: str = "moe/dispatch",
                          combine_name: str = "moe/combine",
                          allow_search: bool = False) -> Dict[str, object]:
    """Calibrate the MoE expert-dispatch wire codecs into ``registry``.

    Runs ONE forward pass (no gradient) over ``batch`` with traffic
    capture on (``moe.capture_moe_traffic``), recomputes each captured
    MoE layer's dispatch/combine buffers with ``moe.dispatch_traffic`` —
    the routed-token values entering / leaving the expert all-to-all,
    capacity drops and padding zeros included — and registers one codec
    per direction from the pooled e4m3-symbol histograms (counted by K6
    on the card, :func:`symbol_counts`):

    * ``dispatch_name`` — pre-FFN token activations (a2a out),
    * ``combine_name`` — post-FFN expert outputs (a2a back).

    Each plan keeps a quarter-bit drift margin and is sized on the
    measured chunk sums with an escape pool of at most 64 slots per 1024
    chunks, as in the reference. Names already in ``registry`` are kept
    (idempotent). Returns ``{name: CodecEntry}``. The capture forward
    runs with ``remat="none"`` and ``moe.impl="gspmd"`` on this rank's
    whole ``batch``: routing does not depend on the impl.
    """
    from repro_torch.models import moe, next_token_loss

    todo = [n for n in (dispatch_name, combine_name) if n not in registry]
    if not todo:
        return {dispatch_name: registry[dispatch_name],
                combine_name: registry[combine_name]}

    eager_cfg = dataclasses.replace(
        model_cfg, remat="none",
        moe=dataclasses.replace(model_cfg.moe, impl="gspmd"))
    captured: list = []
    with torch.no_grad(), moe.capture_moe_traffic(captured), \
            moe.batch_over(None), moe.bind_moe_channels(None):
        next_token_loss(params, eager_cfg, batch["tokens"],
                        batch["labels"], batch.get("prefix_emb"))
        if not captured:
            raise ValueError(
                "no MoE traffic captured — is model_cfg.moe set?")
        streams = {dispatch_name: [], combine_name: []}
        for layer_params, x in captured:
            buf, out_e = moe.dispatch_traffic(layer_params, x, eager_cfg)
            streams[dispatch_name].append(buf)
            streams[combine_name].append(out_e)

    entries = {}
    for name in (dispatch_name, combine_name):
        if name not in todo:
            entries[name] = registry[name]
            continue
        syms = kv_symbol_stream(streams[name], mode="e4m3")
        counts = np.maximum(symbol_counts(syms), 1e-6)
        tables = adapt.calibrate_tables(counts, allow_search=allow_search)
        plan = plan_for_tables(tables, counts, chunk_symbols=chunk_symbols,
                               target_escape_prob=target_escape_prob,
                               drift_margin_bits=0.25)
        plan = empirical_plan(tables, syms, plan,
                              chunk_symbols=chunk_symbols,
                              target_escape_prob=target_escape_prob,
                              max_pool_slots_per_1k=64)
        entries[name] = registry.register_tables(name, tables, plan,
                                                 counts=counts)
    return entries
