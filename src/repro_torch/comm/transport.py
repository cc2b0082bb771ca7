"""Transport layer of the compressed collectives over ``torch.distributed``:
one-shot and ring (the kinds of ``planner.TRANSPORT_KINDS``; the
hierarchical two-tier kind waits for multi-node, ROADMAP queue 1, item 13).

* **one-shot**: a single ``all_to_all_single`` (reduce-scatter,
  all-to-all) or ``all_gather_into_tensor`` (all-gather) of the whole
  compressed payload; every decode runs after the last byte lands.
* **ring**: the payload moves in ``d - 1`` point-to-point hops
  (``batch_isend_irecv``). Hop *s+1* is issued before hop *s* is decoded,
  so the decode (and, for the reduce-scatter, the accumulate) of one hop
  overlaps the next hop's transfer. ``TransportConfig.hop_chunks`` splits
  each hop's payload into independently compressed pieces.

Schedules (d = group size, i = this rank), as in the reference:

* all-gather: the neighbor ring ``i -> i+1``; hop *s* delivers peer
  ``i-s``'s original payload, decoded into its output row.
* reduce-scatter and all-to-all: the rotated pairwise exchange; hop *s*
  sends the original compressed segment destined for peer ``i+s`` and
  receives peer ``i-s``'s segment for this rank. No partial sum crosses
  the wire, so nothing is quantized twice. The all-to-all decodes each
  arriving row into its source's output row, its own row included.

**Bit-identity contract.** Both transports move the same compressed
bytes and reduce through the same per-row-piece op sequence in the same
order, own row first, then peers ``i-1, i-2, ...``
(:func:`_accumulate_row_pieces`), so they give the same bits and the
same ``ok``. With ``hop_chunks > 1`` every piece carries an escape pool
sized for the whole row and ``ok`` is evaluated per row on the summed
piece escape counts (:func:`_row_pool_ok`), the one-shot predicate.

**Wire.** Each piece of each row travels as ONE int32 message: its words
(u32 bit patterns), escape flags, pool rows, pool count and scales (bf16
as int16 pairs) packed byte for byte (:func:`_pack`). Gloo and NCCL
then move the same bytes, and a hop is one message per piece.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.comm import compressed as comp
from repro_torch.comm.planner import TransportConfig

_HIERARCHICAL = ("the hierarchical transport is not ported: ROADMAP queue 1, "
                 "item 13 (multi-node)")

#: ``all_gather_into_tensor`` under the name newer releases give it.
all_gather_flat = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor

Piece = Tuple[comp.WirePayload, torch.Tensor]     # (payload, scales)


# --------------------------------------------------------------------------
# Packing one piece per row into one int32 message
# --------------------------------------------------------------------------

def _row_bytes(t: torch.Tensor, rows: int) -> torch.Tensor:
    """[rows, ...] tensor -> u8 [rows, nbytes] (little-endian view)."""
    return t.contiguous().reshape(rows, -1).view(torch.uint8)


def _pack(piece: Piece) -> torch.Tensor:
    """A piece with lead dims [R] -> int32 [R, L], each part padded to
    whole words."""
    payload, scales = piece
    rows = payload.words.shape[0]
    parts = [_row_bytes(t, rows) for t in (*payload, scales)]
    padded = []
    for p in parts:
        pad = (-p.shape[1]) % 4
        if pad:
            p = torch.cat([p, p.new_zeros((rows, pad))], dim=1)
        padded.append(p)
    return torch.cat(padded, dim=1).view(torch.int32)


def _unpack(buf: torch.Tensor, like: Piece) -> Piece:
    """int32 [R, L] -> a piece shaped like ``like`` (per row), R rows."""
    rows = buf.shape[0]
    raw = buf.contiguous().view(torch.uint8)
    out, off = [], 0
    for t in (*like[0], like[1]):
        shape = (rows,) + tuple(t.shape[1:])
        n = t[0].numel() * t.element_size()
        out.append(raw[:, off:off + n].contiguous().view(t.dtype)
                   .reshape(shape))
        off += n + (-n) % 4
    return comp.WirePayload(*out[:4]), out[4]


# --------------------------------------------------------------------------
# Pieces, row ok and the one reduce step
# --------------------------------------------------------------------------

def _compress_pieces(flat: torch.Tensor, hop_chunks: int, tables, cfg,
                     emit_hist: bool = False):
    """[R, seg] -> ``(pieces, hist)``: ``hop_chunks`` independently
    compressed pieces (payload, scales) with lead dims [R], and the summed
    int32 [256] histogram of everything encoded when ``emit_hist``.

    With ``hop_chunks > 1`` every piece's pool is sized for the WHOLE row
    (``pool_slots_per_1k`` scaled by the piece count), so the row-level
    ok (:func:`_row_pool_ok`) is the one-shot predicate."""
    pieces = flat.reshape(flat.shape[:-1] + (hop_chunks, -1))
    if hop_chunks > 1 and cfg.enabled:
        cfg = dataclasses.replace(
            cfg, pool_slots_per_1k=cfg.pool_slots_per_1k * hop_chunks)
    outs = [comp._compress_values(pieces[..., p, :], tables, cfg,
                                  emit_hist=emit_hist)
            for p in range(hop_chunks)]
    hist = sum(o[2] for o in outs) if emit_hist else None
    return [(o[0], o[1]) for o in outs], hist


def _row_pool_ok(pieces: Sequence[Piece]) -> torch.Tensor:
    """Row-level escape-pool ok of one row's pieces: the summed escape
    count fits the row-sized pool every piece carries."""
    pool_slots = pieces[0][0].pool.shape[-2]
    total = sum(pp.pool_count.sum() for pp, _ in pieces)
    return total <= pool_slots


def _accumulate_row_pieces(accs: List, pieces: Sequence[Piece], tables, cfg,
                           ok: torch.Tensor):
    """Fold one peer row's pieces into the per-piece accumulators: the
    transport contract's only reduce step. The first row decodes, every
    later one accumulates (K2's accumulate form on the card)."""
    for p, (pp, ps) in enumerate(pieces):
        if accs[p] is None:
            accs[p], _ = comp._decompress_values(pp, ps, tables, cfg)
        else:
            accs[p], _ = comp._accumulate_values(accs[p], pp, ps, tables,
                                                 cfg)
    return accs, ok & _row_pool_ok(pieces)


def _row(piece: Piece, idx: int) -> Piece:
    payload, scales = piece
    return comp.WirePayload(*(t[idx] for t in payload)), scales[idx]


# --------------------------------------------------------------------------
# Point-to-point plumbing
# --------------------------------------------------------------------------

def _global(group, r: int) -> int:
    return r if group is None or group is dist.group.WORLD \
        else dist.get_global_rank(group, r)


def _exchange(sends: Sequence[torch.Tensor], dst: int, src: int, group):
    """Post one hop: every tensor of ``sends`` to rank ``dst`` and as many
    same-shaped tensors from rank ``src`` (group ranks). Returns (recv
    buffers, works)."""
    recvs = [torch.empty_like(t) for t in sends]
    op_list = [dist.P2POp(dist.isend, t, _global(group, dst), group)
               for t in sends]
    op_list += [dist.P2POp(dist.irecv, t, _global(group, src), group)
                for t in recvs]
    return recvs, dist.batch_isend_irecv(op_list)


def _wait(works):
    for w in works:
        w.wait()

def _pairwise(packed: Sequence[torch.Tensor], group, d: int, my: int,
              consume):
    """The rotated pairwise exchange of per-destination rows ``packed``
    (h x [d, L]): hop *s* sends row ``i+s`` to peer ``i+s`` and receives
    peer ``i-s``'s row for this rank; hop *s+1* is posted before hop *s*
    is consumed. ``consume(bufs, src)`` sees this rank's own row first."""
    def post(s):
        dst = (my + s) % d
        return _exchange([p[dst] for p in packed], dst, (my - s) % d,
                         group)

    nxt = post(1) if d > 1 else None
    for s in range(d):
        if s == 0:
            bufs = [p[my] for p in packed]
        else:
            bufs, works = nxt
            _wait(works)
            nxt = post(s + 1) if s + 1 < d else None
        consume(bufs, (my - s) % d)


def ring_stream(local: List[torch.Tensor], group, consume, init):
    """Neighbor-forwarding ring: at hop *s* the buffers holding peer
    ``i-s``'s original payload are consumed while the hop forwarding them
    to ``i+1`` is in flight. ``consume(carry, bufs, src) -> carry``.
    Returns the final carry."""
    d = dist.get_world_size(group)
    my = dist.get_rank(group)
    buf, carry = local, init
    for s in range(d):
        nxt = None
        if s < d - 1:
            nxt = _exchange(buf, (my + 1) % d, (my - 1) % d, group)
        carry = consume(carry, buf, (my - s) % d)
        if nxt is not None:
            _wait(nxt[1])
            buf = nxt[0]
    return carry


def _check_kind(t: TransportConfig):
    if t.kind == "hierarchical":
        raise NotImplementedError(_HIERARCHICAL)


# --------------------------------------------------------------------------
# All-gather
# --------------------------------------------------------------------------

def exchange_all_gather(flat: torch.Tensor, group, tables, cfg,
                        t: TransportConfig, emit_hist: bool = False):
    """Gather every rank's padded shard ``flat [seg]`` -> ``(vals f32
    [d, seg], ok bool [])`` (+ the local shard's int32 [256] histogram
    with ``emit_hist``)."""
    _check_kind(t)
    d = dist.get_world_size(group)
    h = t.hop_chunks if t.kind == "ring" else 1
    pieces, hist = _compress_pieces(flat[None], h, tables, cfg, emit_hist)
    if t.kind == "oneshot":
        packed = _pack(pieces[0])                       # [1, L]
        gathered = torch.empty((d, packed.shape[1]), dtype=packed.dtype,
                               device=packed.device)
        all_gather_flat(gathered, packed, group=group)
        payload, scales = _unpack(gathered, pieces[0])
        vals, ok = comp._decompress_values(payload, scales, tables, cfg)
        out = (vals, ok.all())
    else:
        seg = flat.shape[0]

        def consume(carry, bufs, src):
            vals_out, ok = carry
            row = [_row(_unpack(b, pc), 0) for b, pc in zip(bufs, pieces)]
            for p, (pp, ps) in enumerate(row):
                vals, _ = comp._decompress_values(pp, ps, tables, cfg)
                vals_out[src, p] = vals
            return vals_out, ok & _row_pool_ok(row)

        out0 = torch.empty((d, h, seg // h), dtype=torch.float32,
                           device=flat.device)
        ok0 = torch.ones((), dtype=torch.bool, device=flat.device)
        vals, ok = ring_stream([_pack(pc) for pc in pieces], group,
                               consume, (out0, ok0))
        out = (vals.reshape(d, seg), ok)
    return out + (hist,) if emit_hist else out


# --------------------------------------------------------------------------
# Reduce-scatter
# --------------------------------------------------------------------------

def exchange_reduce_scatter(xs: torch.Tensor, group, tables, cfg,
                            t: TransportConfig, emit_hist: bool = False):
    """Reduce-scatter of ``xs [d, seg]`` (row j = this rank's summand of
    rank j's segment) -> ``(acc f32 [seg], ok bool [])`` (+ the int32
    [256] histogram of every symbol this rank encoded with
    ``emit_hist``). Each segment is quantized and encoded once and summed
    in f32 at its destination in the order own row, then ``i-1, i-2,
    ...`` on both transports."""
    _check_kind(t)
    d = dist.get_world_size(group)
    my = dist.get_rank(group)
    h = t.hop_chunks
    pieces, hist = _compress_pieces(xs, h, tables, cfg, emit_hist)
    accs: List = [None] * h
    ok = torch.ones((), dtype=torch.bool, device=xs.device)

    if t.kind == "oneshot":
        # Decode strictly after the whole exchange, through the same
        # per-row-piece accumulate as the ring.
        received = []
        for pc in pieces:
            packed = _pack(pc)                         # [d, L]
            out = torch.empty_like(packed)
            dist.all_to_all_single(out, packed, group=group)
            received.append(_unpack(out, pc))
        for s in range(d):
            src = (my - s) % d
            accs, ok = _accumulate_row_pieces(
                accs, [_row(pc, src) for pc in received], tables, cfg, ok)
    else:
        def consume(bufs, src):
            nonlocal accs, ok
            row = [_row(_unpack(b[None], pc), 0)
                   for b, pc in zip(bufs, pieces)]
            accs, ok = _accumulate_row_pieces(accs, row, tables, cfg, ok)

        _pairwise([_pack(pc) for pc in pieces], group, d, my, consume)
    acc = torch.cat(accs)
    return (acc, ok, hist) if emit_hist else (acc, ok)



# --------------------------------------------------------------------------
# All-to-all
# --------------------------------------------------------------------------

def exchange_all_to_all(rows: torch.Tensor, group, tables, cfg,
                        t: TransportConfig, emit_hist: bool = False,
                        with_wire: bool = False):
    """All-to-all of ``rows [d, n]`` (row j goes to peer j) -> ``(vals
    f32 [d, n], ok bool [])``, output row j holding peer j's dequantized
    row for this rank (+ the int32 [256] histogram of every symbol this
    rank encoded with ``emit_hist``; + the wire bytes of this rank's
    compressed rows, every piece's payload and scales, with
    ``with_wire``). The own row is quantized and decoded like the others
    on both transports, so one-shot and ring give the same bits."""
    _check_kind(t)
    d = dist.get_world_size(group)
    my = dist.get_rank(group)
    h = t.hop_chunks if t.kind == "ring" else 1
    pieces, hist = _compress_pieces(rows, h, tables, cfg, emit_hist)
    if t.kind == "oneshot":
        packed = _pack(pieces[0])                       # [d, L]
        out = torch.empty_like(packed)
        dist.all_to_all_single(out, packed, group=group)
        payload, scales = _unpack(out, pieces[0])
        vals, ok = comp._decompress_values(payload, scales, tables, cfg)
        res = (vals, ok.all())
    else:
        vals_out = torch.empty((d, h, rows.shape[-1] // h),
                               dtype=torch.float32, device=rows.device)
        oks = []

        def consume(bufs, src):
            row = [_row(_unpack(b[None], pc), 0)
                   for b, pc in zip(bufs, pieces)]
            for p, (pp, ps) in enumerate(row):
                vals_out[src, p], _ = comp._decompress_values(pp, ps,
                                                              tables, cfg)
            oks.append(_row_pool_ok(row))

        _pairwise([_pack(pc) for pc in pieces], group, d, my, consume)
        res = (vals_out.reshape(d, -1), torch.stack(oks).all())
    if emit_hist:
        res += (hist,)
    if with_wire:
        res += (sum(comp.wire_bytes(p, s) for p, s in pieces),)
    return res
