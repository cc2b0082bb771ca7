"""The QLC wire payload and its local transforms: the codes path (paged
KV serving, containers) and the value path (the gradient wire's
quantize-encode, decode-dequantize and decode-accumulate).

Each ``chunk_symbols``-symbol chunk gets a fixed slot of
``capacity_words`` 32-bit words, a 1-byte escape flag, and escaped
chunks (whose code does not fit) ride raw in a small overflow pool. If
the pool itself overflows, ``ok`` is False and the caller falls back
(the paged KV cache re-wires the block raw). Lossless semantics never
depend on statistics.

Tensors follow the port's convention: words and pool rows are int32
tensors holding u32 bit patterns, flags uint8, pool_count int32. Raw
chunks become words by a little-endian byte view, as the reference's
``bitcast_convert_type`` does.

``_encode`` / ``_decode`` route by the device of their input through
``kernels.ops``: K3 and K4 on the card, their plain versions on the
CPU; the value transforms likewise through K1 (quantize-encode) and K2
(decode-dequantize, plain and accumulate forms). ``CommConfig.
use_kernels`` is kept so that configs, manifests and registry JSON
round-trip with the reference, but it does not pick the route: the
reference leaves it False on its serving and training paths and so runs
its pure codec, while on the card the port must run its kernels. The
outputs are the same bit for bit either way.

Escaped chunks are patched into the decoded values on the device: each
of the pool's fixed slots is dequantized and copied over its chunk's row
(``_merge_pool``), where the reference selects between two full-size
tensors: the same values, without a second full-size temporary and
without a host read, so the compressed step traces on fake tensors.
Chunks past an overflowed pool (``ok`` False) get the reference's values,
the last pool row, by one full-size select on every device
(``_overflow_rows``): the expert all-to-all uses them as the reference
does. The collectives over these transforms live in ``comm.transport``
and ``comm.channel``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.comm.planner import CommPlan
from repro_torch.core.lut import CodecTables
from repro_torch.kernels import ops
from repro_torch.quant import e4m3


@dataclasses.dataclass(frozen=True)
class CommConfig:
    """Static configuration of the compressed wire format."""
    enabled: bool = True          # False => raw e4m3 codes on the wire
    chunk_symbols: int = 1024
    capacity_words: int = 240     # 7.5 bits/symbol default
    pool_slots_per_1k: int = 8
    scale_dtype: str = "bfloat16"
    #: kept for JSON/manifest compatibility with the reference; the route
    #: follows the tensor's device (see the module docstring).
    use_kernels: bool = False

    @classmethod
    def from_plan(cls, plan: CommPlan, **kw) -> "CommConfig":
        base = dict(chunk_symbols=plan.chunk_symbols,
                    capacity_words=plan.capacity_words,
                    pool_slots_per_1k=plan.pool_slots_per_1k)
        base.update(kw)          # explicit overrides win over the plan
        return cls(**base)

    def pool_slots(self, n_chunks: int) -> int:
        return max(1, math.ceil(n_chunks * self.pool_slots_per_1k / 1024))

    def raw_words(self) -> int:
        return self.chunk_symbols // 4


class WirePayload(NamedTuple):
    """Static-shape compressed payload for one transfer."""
    words: torch.Tensor       # int32 [..., n_chunks, capacity_words]
    flags: torch.Tensor       # uint8 [..., n_chunks] 1 = escaped-to-pool
    pool: torch.Tensor        # int32 [..., pool_slots, K/4] raw escapes
    pool_count: torch.Tensor  # int32 [..., 1] number of escapes


def wire_bytes(payload: WirePayload,
               scales: Optional[torch.Tensor] = None) -> int:
    """Static wire footprint in bytes (for accounting)."""
    total = sum(t.numel() * t.element_size() for t in payload)
    if scales is not None:
        total += scales.numel() * scales.element_size()
    return total


def pad_to_multiple(x: torch.Tensor, multiple: int
                    ) -> Tuple[torch.Tensor, int]:
    """Flatten and zero-pad to a multiple; returns (padded, true length)."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    pad = (-n) % multiple
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat, n


def _as_words(chunks: torch.Tensor) -> torch.Tensor:
    """u8 [..., K] -> int32 [..., K/4], little-endian (a byte view)."""
    return chunks.contiguous().view(torch.int32)


def _encode(chunks: torch.Tensor, tables: CodecTables, cfg: CommConfig):
    """u8 [..., n_chunks, K] -> (words [..., n_chunks, CW], nbits
    [..., n_chunks]): K3 for a CUDA tensor."""
    flat = chunks.reshape(-1, cfg.chunk_symbols)
    words, nbits = ops.encode(flat, tables, cfg.capacity_words)
    lead = chunks.shape[:-1]
    return (words.reshape(lead + (cfg.capacity_words,)),
            nbits.reshape(lead))


def _decode(words: torch.Tensor, tables: CodecTables, cfg: CommConfig):
    """words [..., n_chunks, CW] -> u8 [..., n_chunks, K]: K4 for a CUDA
    tensor."""
    flat = words.reshape(-1, words.shape[-1])
    out = ops.decode(flat, tables, cfg.chunk_symbols)
    return out.reshape(words.shape[:-1] + (cfg.chunk_symbols,))


def _raw_payload(chunks: torch.Tensor) -> WirePayload:
    """Raw e4m3 wire: u8 chunks viewed as u32 words, no escapes."""
    *lead, n_chunks, k = chunks.shape
    dev = chunks.device
    return WirePayload(
        words=_as_words(chunks),
        flags=torch.zeros((*lead, n_chunks), dtype=torch.uint8, device=dev),
        pool=torch.zeros((*lead, 1, k // 4), dtype=torch.int32, device=dev),
        pool_count=torch.zeros((*lead, 1), dtype=torch.int32, device=dev),
    )


# --- escape-pool machinery (shared by wire assembly and decode; the
# --- slot/gather invariants live ONLY here) -------------------------------

def _escape_slots(escape: torch.Tensor, pool_slots: int):
    """Per-chunk pool slot assignment from escape flags.

    Returns ``(esc_idx, slot)``: running escape index, and the scatter
    slot (``pool_slots`` — i.e. dropped — for non-escaped and
    pool-overflowing chunks).
    """
    esc_i = escape.to(torch.int64)
    esc_idx = torch.cumsum(esc_i, dim=-1) - esc_i
    slot = torch.where(escape.bool(), esc_idx,
                       torch.full_like(esc_idx, pool_slots))
    return esc_idx, slot


def _flat_lead(t: torch.Tensor, keep: int) -> torch.Tensor:
    return t.reshape((-1,) + tuple(t.shape[t.dim() - keep:]))


def _slot_chunks(escape: torch.Tensor, pool_slots: int) -> torch.Tensor:
    """Each pool slot's chunk, fixed-size: int64 [..., pool_slots], slot
    ``p`` holding the ``p``-th escaped chunk, or ``n_chunks`` (a dummy
    row) where fewer than ``p + 1`` chunks escaped. No host read."""
    *lead, n_chunks = escape.shape
    esc_c = torch.cumsum(escape.to(torch.int64), dim=-1)
    want = torch.arange(1, pool_slots + 1, device=escape.device)
    return torch.searchsorted(
        esc_c, want.expand(*lead, pool_slots).contiguous())


def _take_rows(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[..., n, W] rows + int64 [..., P] indices in [0, n] -> [..., P, W];
    index ``n`` (the dummy row) gives zeros."""
    n = rows.shape[-2]
    got = _gather_pool_rows(rows, idx.clamp(max=n - 1))
    return torch.where((idx < n)[..., None], got, torch.zeros_like(got))


def _gather_pool_rows(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[..., pool_slots, W] pool + [..., n_chunks] idx -> [..., n_chunks, W]."""
    *lead, _, w = pool.shape
    p = _flat_lead(pool, 2)
    i = _flat_lead(idx, 1)
    b = torch.arange(p.shape[0], device=pool.device)[:, None].expand_as(i)
    return p[b, i].reshape(*lead, i.shape[-1], w)


def _assemble_payload(chunks: torch.Tensor, words: torch.Tensor,
                      nbits: torch.Tensor, cfg: CommConfig) -> WirePayload:
    """Build the escape-flag/pool wire format around encoded slots."""
    n_chunks = chunks.shape[-2]
    escape = nbits > cfg.capacity_words * 32
    pool_slots = cfg.pool_slots(n_chunks)
    # Each pool slot takes its escaped chunk's raw form (zeros where no
    # chunk is left); pool-overflowing chunks are dropped.
    pool = _take_rows(_as_words(chunks), _slot_chunks(escape, pool_slots))
    pool_count = escape.to(torch.int32).sum(dim=-1, keepdim=True,
                                            dtype=torch.int32)
    return WirePayload(words=words, flags=escape.to(torch.uint8),
                       pool=pool, pool_count=pool_count)


def _compress_codes(codes: torch.Tensor, tables: CodecTables,
                    cfg: CommConfig) -> WirePayload:
    """uint8 [..., M] (M % chunk_symbols == 0) -> WirePayload."""
    k = cfg.chunk_symbols
    *lead, m = codes.shape
    if m % k:
        raise ValueError(f"{m} symbols are not a multiple of {k}")
    chunks = codes.reshape(*lead, m // k, k)
    if not cfg.enabled:
        return _raw_payload(chunks)
    words, nbits = _encode(chunks, tables, cfg)
    return _assemble_payload(chunks, words, nbits, cfg)


def _gather_pool_raw(payload: WirePayload, cfg: CommConfig) -> torch.Tensor:
    """Gather each chunk's escape-pool raw form -> u8 [..., n_chunks, K].

    Rows whose chunk did not escape hold arbitrary pool data; callers
    select with the escape flags.
    """
    *lead, n_chunks, _ = payload.words.shape
    pool_slots = payload.pool.shape[-2]
    esc_idx, _ = _escape_slots(payload.flags, pool_slots)
    raw_words = _gather_pool_rows(payload.pool,
                                  esc_idx.clamp(max=pool_slots - 1))
    return raw_words.contiguous().view(torch.uint8).reshape(
        *lead, n_chunks, cfg.chunk_symbols)


def _decompress_codes(payload: WirePayload, tables: Optional[CodecTables],
                      cfg: CommConfig, *,
                      decode_fn: Optional[Callable] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """WirePayload -> (uint8 codes [..., M], ok bool [...]).

    ``tables`` may be ``None`` only for a raw (``cfg.enabled=False``)
    wire. ``decode_fn(words, tables, cfg)`` overrides the slot decode —
    the async KV paging path routes it through K5
    (``kernels.ops.decode_block_async``) while reusing this escape merge
    unchanged."""
    k = cfg.chunk_symbols
    *lead, n_chunks, _ = payload.words.shape
    dev = payload.words.device
    if not cfg.enabled:
        codes = payload.words.contiguous().view(torch.uint8)
        return (codes.reshape(*lead, n_chunks * k),
                torch.ones(tuple(lead), dtype=torch.bool, device=dev))
    dec = (_decode if decode_fn is None else decode_fn)(
        payload.words, tables, cfg)                    # [..., n_chunks, K]
    escape = payload.flags.bool()
    out = torch.where(escape[..., None], _gather_pool_raw(payload, cfg), dec)
    ok = payload.pool_count[..., 0] <= payload.pool.shape[-2]
    return out.reshape(*lead, n_chunks * k), ok


def _quantize(x: torch.Tensor, cfg: CommConfig):
    """float [..., M] -> (codes u8 [..., M], scales [..., M/32] in
    ``cfg.scale_dtype``, cast with round-to-nearest-even), in pieces (the
    raw twin quantizes a whole flat gradient)."""
    codes, scales = e4m3.quantize_block32_pieces(x.float())
    return codes, scales.to(getattr(torch, cfg.scale_dtype))


def _dequantize(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return e4m3.dequantize_block32_pieces(codes, scales.float())



# --- value transforms (the gradient wire's local hot path) ----------------

class ReduceScatterResult(NamedTuple):
    """A compressed reduce-scatter's output: this rank's summed segment,
    padded to the static segment length; ``valid``, how many leading
    entries of it map to real (pre-padding) input; and ``ok``."""
    segment: torch.Tensor     # f32 [seg_padded]
    valid: int
    ok: torch.Tensor          # bool []


def _compress_values(x: torch.Tensor, tables: CodecTables, cfg: CommConfig,
                     *, emit_hist: bool = False):
    """float [..., M] (M % chunk_symbols == 0) -> (WirePayload, scales
    [..., M/32] in ``cfg.scale_dtype`` [, hist int32 [256]]).

    Enabled: quantize and encode in one K1 launch on the card, which also
    emits the symbols (the escape pool stores escaped chunks raw) and,
    with ``emit_hist``, their histogram. Raw twin (``enabled=False``):
    the plain quantizer, the codes viewed as words."""
    k = cfg.chunk_symbols
    *lead, m = x.shape
    if m % k:
        raise ValueError(f"{m} values are not a multiple of {k}")
    n_chunks = m // k
    if not cfg.enabled:
        codes, scales = _quantize(x, cfg)
        payload = _raw_payload(codes.reshape(*lead, n_chunks, k))
        if emit_hist:
            return payload, scales, ops.histogram(codes)
        return payload, scales
    outs = ops.quantize_encode(x.reshape(-1, k), tables, cfg.capacity_words,
                               emit_codes=True, emit_hist=emit_hist)
    words, nbits, scales, codes = outs[:4]
    payload = _assemble_payload(
        codes.reshape(*lead, n_chunks, k),
        words.reshape(*lead, n_chunks, cfg.capacity_words),
        nbits.reshape(*lead, n_chunks), cfg)
    scales = scales.reshape(*lead, m // e4m3.BLOCK).to(
        getattr(torch, cfg.scale_dtype))
    if emit_hist:
        return payload, scales, outs[4]
    return payload, scales


def _merge_pool(vals: torch.Tensor, payload: WirePayload,
                scales: torch.Tensor, acc: Optional[torch.Tensor],
                k: int) -> None:
    """The value decode's escape epilogue on the device, in place and with
    no host read: each of the pool's fixed slots maps to its escaped chunk
    (:func:`_slot_chunks`), its row is dequantized with that chunk's own
    scales (``acc +`` it in the accumulate form) and copied over the
    chunk's row of ``vals`` [rows, K] by one ``index_copy_``. A slot with
    no escaped chunk left targets a chunk that did not escape, one of its
    own, and copies that row's value back unchanged, so the targets are
    distinct and the copy deterministic. Chunks past an overflowed pool
    are :func:`_overflow_rows`'s."""
    flags = payload.flags.reshape(-1, payload.flags.shape[-1])
    b, n_chunks = flags.shape
    slots = min(payload.pool.shape[-2], n_chunks)   # at most n can escape
    escape = flags.bool()
    chunk = _slot_chunks(escape, slots)             # [b, slots] in [0, n]
    used = chunk < n_chunks
    # Free slots take, in order, the chunks that did not escape: at least
    # ``slots - escapes`` of them exist, since slots <= n_chunks.
    free_i = torch.cumsum((~used).to(torch.int64), dim=-1)
    kept_c = torch.cumsum((~escape).to(torch.int64), dim=-1)
    kept = torch.searchsorted(kept_c, free_i.contiguous())
    target = torch.where(used, chunk, kept.clamp(max=n_chunks - 1))
    rows = (target + n_chunks * torch.arange(
        b, device=flags.device)[:, None]).reshape(-1)
    pool_u8 = payload.pool.contiguous().view(torch.uint8).reshape(
        b, -1, k)[:, :slots].reshape(-1, k)
    chunk_scales = scales.float().reshape(-1, k // e4m3.BLOCK)
    raw = e4m3.dequantize_block32(pool_u8, chunk_scales[rows])
    if acc is not None:
        raw = acc.reshape(-1, k)[rows].float() + raw
    src = torch.where(used.reshape(-1, 1), raw, vals[rows])
    vals.index_copy_(0, rows, src)


def _overflow_rows(vals: torch.Tensor, payload: WirePayload,
                   scales: torch.Tensor, acc: Optional[torch.Tensor],
                   k: int) -> None:
    """The reference's values for chunks past an overflowed pool, in
    place: the last pool row dequantized with each chunk's own scales
    (``acc +`` it in the accumulate form). ``ok`` is then False; the
    train step falls back, and the expert all-to-all uses these values as
    the reference's does. One full-size select with no host read, the
    same on every device."""
    flags = payload.flags.reshape(-1, payload.flags.shape[-1])
    b, n_chunks = flags.shape
    nb = k // e4m3.BLOCK
    escape = flags.bool()
    over = escape & (torch.cumsum(escape.to(torch.int64), dim=-1)
                     > payload.pool.shape[-2])
    last = payload.pool[..., -1:, :].contiguous().view(torch.uint8)
    raw = (e4m3.e4m3_decode(last.reshape(b, 1, nb, e4m3.BLOCK))
           * scales.float().reshape(b, n_chunks, nb, 1))
    if acc is not None:
        raw = acc.reshape(b, n_chunks, nb, e4m3.BLOCK).float() + raw
    v = vals.view(b, n_chunks, nb, e4m3.BLOCK)
    torch.where(over[:, :, None, None], raw, v, out=v)


def _decode_values(payload: WirePayload, scales: torch.Tensor,
                   tables: CodecTables, cfg: CommConfig,
                   acc: Optional[torch.Tensor]):
    k = cfg.chunk_symbols
    *lead, n_chunks, cw = payload.words.shape
    flat_words = payload.words.reshape(-1, cw)
    flat_scales = scales.float().reshape(-1, k // e4m3.BLOCK)
    if acc is None:
        vals = ops.decode_dequantize(flat_words, flat_scales, tables, k)
    else:
        vals = ops.decode_dequantize_accumulate(
            acc.reshape(-1, k).float(), flat_words, flat_scales, tables, k)
    _merge_pool(vals, payload, scales, acc, k)
    _overflow_rows(vals, payload, scales, acc, k)
    ok = payload.pool_count[..., 0] <= payload.pool.shape[-2]
    return vals.reshape(*lead, n_chunks * k), ok


def _decompress_values(payload: WirePayload, scales: torch.Tensor,
                       tables: Optional[CodecTables], cfg: CommConfig
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(WirePayload, scales) -> (f32 values [..., M], ok bool [...]):
    one K2 launch on the card, escaped chunks patched in from the pool.
    The raw twin views the words as codes and dequantizes them."""
    if not cfg.enabled:
        codes, ok = _decompress_codes(payload, tables, cfg)
        return _dequantize(codes, scales), ok
    return _decode_values(payload, scales, tables, cfg, None)


def _accumulate_values(acc: torch.Tensor, payload: WirePayload,
                       scales: torch.Tensor, tables: Optional[CodecTables],
                       cfg: CommConfig
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``acc + decompress_values(payload)`` in f32: one launch of K2's
    accumulate form on the card (the dequantize product rounded before
    the add, so it equals the reference's decode-then-add bit for bit);
    escaped chunks are ``acc + raw`` from the pool. Returns ``(new_acc
    f32 [..., M], ok)``."""
    if not cfg.enabled:
        vals, ok = _decompress_values(payload, scales, tables, cfg)
        return acc + vals, ok
    return _decode_values(payload, scales, tables, cfg, acc)
