"""Pure-torch chunked QLC codec: the plain version of the fused kernels
and the oracle they are held against.

Layout (the wire format of the reference package): the symbol stream is
cut into chunks of ``K`` symbols; each chunk is encoded on its own into a
slot of ``capacity_words`` 32-bit words, LSB-first. Words travel as
``torch.int32`` tensors holding the u32 bit pattern. Arithmetic on them
is done in int64 masked to 32 bits, because torch's int32 ``>>`` is an
arithmetic shift.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.lut import CodecTables

MAX_CODE_BITS = 11   # paper schemes top out at 3 + 8
U32 = 0xFFFFFFFF


def stack_decode_tables(tables_list: Sequence[CodecTables]):
    """Stack decoder LUTs of several schemes for multi-LUT decode.

    All schemes must share ``prefix_bits``. Returns ``(dec_lut [S, 256],
    area_symbol_bits [S, 2**p], area_starts [S, 2**p], prefix_bits)`` as
    numpy arrays.
    """
    if not tables_list:
        raise ValueError("need at least one CodecTables")
    pb = tables_list[0].prefix_bits
    for t in tables_list:
        if t.prefix_bits != pb:
            raise ValueError(
                "multi-LUT decode needs a uniform prefix_bits, got "
                f"{sorted({t.prefix_bits for t in tables_list})}")
    dec = np.stack([t.dec_lut for t in tables_list])
    sb = np.stack([t.area_symbol_bits for t in tables_list])
    st = np.stack([t.area_starts for t in tables_list])
    return dec, sb, st, pb


def worst_case_words(chunk_symbols: int, max_code_bits: int = MAX_CODE_BITS
                     ) -> int:
    """Slot size that can hold any chunk (guaranteed-lossless capacity)."""
    return math.ceil(chunk_symbols * max_code_bits / 32) + 1


def raw_words(chunk_symbols: int) -> int:
    """Words needed to store a chunk raw (8 bits/symbol)."""
    return math.ceil(chunk_symbols * 8 / 32)


def to_u32(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2**32)."""
    return words.to(torch.int64) & U32


def from_u32(vals: torch.Tensor) -> torch.Tensor:
    """int64 values (any) -> int32 tensor holding the low 32 bits."""
    v = vals & U32
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def encode_chunk_bits(symbols: torch.Tensor, enc_len) -> torch.Tensor:
    """Total encoded bits per chunk. symbols: [..., K] uint8 -> [...] int64."""
    lens = torch.as_tensor(np.asarray(enc_len, np.int64),
                           device=symbols.device)
    return lens[symbols.long()].sum(dim=-1)


def encode_chunks(symbols: torch.Tensor, tables: CodecTables,
                  capacity_words: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode chunks of symbols into fixed word slots.

    Args:
      symbols: uint8 [..., n_chunks, K].
      tables: codec tables.
      capacity_words: slot size per chunk, in 32-bit words.

    Returns:
      words: int32 [..., n_chunks, capacity_words] (u32 bit patterns).
        Bits past the encoded length are zero. A chunk that does not fit
        keeps the reference's contents: out-of-slot writes are clamped
        to the last word and ADDED there, mod 2**32.
      nbits: int32 [..., n_chunks], the exact encoded bit count.
    """
    dev = symbols.device
    enc_code = torch.as_tensor(tables.enc_code.astype(np.int64), device=dev)
    enc_len = torch.as_tensor(tables.enc_len.astype(np.int64), device=dev)
    sym = symbols.long()
    codes = enc_code[sym]
    lens = enc_len[sym]
    nbits = lens.sum(dim=-1)
    offsets = torch.cumsum(lens, dim=-1) - lens
    word_idx = (offsets >> 5).clamp(max=capacity_words - 1)
    shift = offsets & 31
    lo = (codes << shift) & U32
    hi = torch.where(shift == 0, torch.zeros_like(codes),
                     codes >> (32 - shift))
    hi_idx = (word_idx + 1).clamp(max=capacity_words - 1)
    words = torch.zeros(symbols.shape[:-1] + (capacity_words,),
                        dtype=torch.int64, device=dev)
    words.scatter_add_(-1, word_idx, lo)
    words.scatter_add_(-1, hi_idx, hi)
    return from_u32(words), nbits.to(torch.int32)


def decode_chunks(words: torch.Tensor, tables: CodecTables,
                  chunk_symbols: int) -> torch.Tensor:
    """Single-scheme decode (``decode_chunks_multi`` with S=1)."""
    return decode_chunks_multi(words, [tables], 0, chunk_symbols)


def decode_chunks_multi(words: torch.Tensor,
                        tables_list: Sequence[CodecTables],
                        scheme_ids, chunk_symbols: int) -> torch.Tensor:
    """Decode chunks encoded under different schemes in one pass.

    Args:
      words: int32 [..., n_chunks, capacity_words] u32 bit patterns.
      tables_list: the stacked schemes; ``scheme_ids`` index into it.
      scheme_ids: int, or int [n_chunks] / [..., n_chunks].
      chunk_symbols: K.

    Returns uint8 [..., n_chunks, K]. Per symbol: the 3-bit area code
    gives the payload bits and the area's first rank; the rank indexes
    ``dec_lut``. A cursor past the slot reads the reference's gather
    fill (all ones) for the first word and the clamped last word for the
    second, so over-capacity chunks decode to the same symbols.
    """
    dec_np, sb_np, st_np, prefix = stack_decode_tables(tables_list)
    dev = words.device
    a = sb_np.shape[1]
    dec = torch.as_tensor(dec_np.astype(np.int64), device=dev).reshape(-1)
    sbt = torch.as_tensor(sb_np.astype(np.int64), device=dev).reshape(-1)
    stt = torch.as_tensor(st_np.astype(np.int64), device=dev).reshape(-1)
    pmask = (1 << prefix) - 1

    lead = words.shape[:-1]
    cw = words.shape[-1]
    flat = to_u32(words.reshape(-1, cw))
    n = flat.shape[0]
    sid = torch.as_tensor(scheme_ids, dtype=torch.int64, device=dev)
    sid = torch.broadcast_to(sid, lead).reshape(-1)
    out = torch.empty((n, chunk_symbols), dtype=torch.uint8, device=dev)
    bitpos = torch.zeros(n, dtype=torch.int64, device=dev)
    fill = torch.full((n,), U32, dtype=torch.int64, device=dev)
    for i in range(chunk_symbols):
        widx = bitpos >> 5
        shift = bitpos & 31
        w0 = flat.gather(1, widx.clamp(max=cw - 1)[:, None])[:, 0]
        w0 = torch.where(widx < cw, w0, fill)
        w1 = flat.gather(1, (widx + 1).clamp(max=cw - 1)[:, None])[:, 0]
        w1s = torch.where(shift == 0, torch.zeros_like(w1),
                          (w1 << (32 - shift)) & U32)
        window = (w0 >> shift) | w1s
        area = window & pmask
        sb = sbt[sid * a + area]
        payload = (window >> prefix) & ((1 << sb) - 1)
        rank = stt[sid * a + area] + payload
        out[:, i] = dec[sid * 256 + rank.clamp(max=255)].to(torch.uint8)
        bitpos = bitpos + prefix + sb
    return out.reshape(lead + (chunk_symbols,))


# --------------------------------------------------------------------------
# Whole-array helpers (worst-case slots: every chunk fits)
# --------------------------------------------------------------------------

def pad_to_chunks(symbols: torch.Tensor, chunk_symbols: int
                  ) -> Tuple[torch.Tensor, int]:
    """Flatten and zero-pad a symbol tensor to [n_chunks, K]; returns it
    and the number of real symbols."""
    flat = symbols.reshape(-1)
    n = flat.numel()
    pad = -(-n // chunk_symbols) * chunk_symbols - n
    flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, chunk_symbols), n


def encode_stream(symbols: torch.Tensor, tables: CodecTables,
                  chunk_symbols: int = 1024):
    """Encode any u8 tensor into worst-case (always fitting) slots ->
    ``(words, nbits, n)``."""
    cap = worst_case_words(chunk_symbols, tables.max_code_length)
    chunks, n = pad_to_chunks(symbols, chunk_symbols)
    words, nbits = encode_chunks(chunks, tables, cap)
    return words, nbits, n


def decode_stream(words: torch.Tensor, tables: CodecTables,
                  chunk_symbols: int, n: int, shape=None) -> torch.Tensor:
    """Inverse of :func:`encode_stream`: the first ``n`` symbols,
    reshaped to ``shape`` when given."""
    out = decode_chunks(words, tables, chunk_symbols).reshape(-1)[:n]
    if shape is not None:
        out = out.reshape(shape)
    return out


def compressed_bits(symbols: torch.Tensor, tables: CodecTables
                    ) -> torch.Tensor:
    """Exact compressed size in bits, without packing: an int64 sum,
    returned as f32 (the reference sums in f32, exact below 2^24)."""
    lens = torch.as_tensor(np.asarray(tables.enc_len, np.int64),
                           device=symbols.device)
    return lens[symbols.reshape(-1).long()].sum().to(torch.float32)


def measured_compressibility(symbols, tables: CodecTables) -> float:
    """``(8 - mean bits) / 8`` on actual data (numpy, exact)."""
    syms = np.asarray(symbols).reshape(-1)
    lens = tables.enc_len[syms.astype(np.int64)]
    avg = lens.mean(dtype=np.float64)
    return float((8.0 - avg) / 8.0)
