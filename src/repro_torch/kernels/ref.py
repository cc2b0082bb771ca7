"""Plain PyTorch versions of the kernels K1-K6.

They compose the pure codec (and, for K1/K2, the e4m3 quantizer), op for
op, and are what ``kernels.ops`` runs for a tensor on the CPU. On the
card they are used only by tests and ``chip_smoke.py``, to hold the CUDA
kernels against.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import codec
from repro_torch.core.lut import CodecTables
from repro_torch.quant import e4m3


def quantize_encode_ref(x: torch.Tensor, tables: CodecTables,
                        capacity_words: int, *, emit_codes: bool = False,
                        emit_hist: bool = False):
    """Plain K1: float [n, K] -> (words int32 [n, CW], nbits int32 [n],
    scales f32 [n, K/32] [, codes u8 [n, K]] [, hist int32 [256]])."""
    codes, scales = e4m3.quantize_block32(x.float())
    words, nbits = codec.encode_chunks(codes, tables, capacity_words)
    out = [words, nbits, scales]
    if emit_codes:
        out.append(codes)
    if emit_hist:
        out.append(torch.bincount(codes.reshape(-1).long(), minlength=256)
                   .to(torch.int32))
    return tuple(out)


def decode_dequantize_ref(words: torch.Tensor, scales: torch.Tensor,
                          tables_list: Sequence[CodecTables],
                          scheme_ids, chunk_symbols: int,
                          out_dtype=torch.float32,
                          acc: torch.Tensor | None = None) -> torch.Tensor:
    """Plain K2: decode, dequantize, then ``acc +`` (f32) or the cast to
    ``out_dtype`` (round-to-nearest-even for bf16)."""
    sym = codec.decode_chunks_multi(words, tables_list, scheme_ids,
                                    chunk_symbols)
    vals = e4m3.dequantize_block32(sym, scales.float())
    if acc is not None:
        return acc.float() + vals
    return vals.to(out_dtype)


def encode_ref(symbols: torch.Tensor, tables: CodecTables,
               capacity_words: int):
    """Plain K3: u8 [n, K] -> (words int32 [n, CW], nbits int32 [n])."""
    return codec.encode_chunks(symbols, tables, capacity_words)


def decode_ref(words: torch.Tensor, tables_list: Sequence[CodecTables],
               scheme_ids, chunk_symbols: int) -> torch.Tensor:
    """Plain K4: words int32 [n, CW] + scheme slots [n] -> u8 [n, K]."""
    return codec.decode_chunks_multi(words, tables_list, scheme_ids,
                                     chunk_symbols)


#: Plain K5. K5 differs from K4 only in how the words reach the cursor.
decode_block_async_ref = decode_ref


#: symbols per slice of the plain histogram: its one-hot is 1 KiB per
#: symbol, so a slice holds at most 64 MiB of it.
_HIST_SLICE = 1 << 16


def histogram256_ref(symbols: torch.Tensor) -> torch.Tensor:
    """Plain K6: u8 (any shape) -> int32 [256] counts, as the reference's
    one-hot reduction, slice by slice."""
    flat = symbols.reshape(-1)
    bins = torch.arange(256, dtype=torch.int32, device=flat.device)
    counts = torch.zeros(256, dtype=torch.int32, device=flat.device)
    for s in range(0, flat.numel(), _HIST_SLICE):
        part = flat[s:s + _HIST_SLICE].to(torch.int32)
        counts += (part[:, None] == bins[None, :]).sum(dim=0,
                                                       dtype=torch.int32)
    return counts
