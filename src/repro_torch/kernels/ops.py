"""Public entry points of the fused codec kernels.

Dispatch is by the device of the tensor given: a CPU tensor goes to the
plain version (``kernels.ref``), a CUDA tensor to the hand-written CUDA
kernel (``kernels.qlc_fused``), and anything else raises. There is no
fallback from the kernel to the plain version.

  quantize_encode               — float -> (words, nbits, scales
                                  [, codes] [, hist]): K1.
  decode_dequantize             — words + scales -> float (f32 / bf16): K2.
  decode_dequantize_accumulate  — acc + decode_dequantize, f32, one
                                  launch: K2's accumulate form.

Both decode entry points take one ``CodecTables`` or a sequence of them
with ``scheme_ids`` (int [n_chunks]) naming each chunk's scheme: stacked
multi-LUT operands, as in the reference. The CUDA kernels need no row
padding, so the reference's TPU tile table has no counterpart here; the
histogram counts exactly the symbols of the n input rows, which is what
the reference returns after it takes its padding rows back out of bin 0.
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from repro_torch.core import codec
from repro_torch.core.lut import CodecTables
from repro_torch.kernels import qlc_fused, ref
from repro_torch.quant import e4m3

Tables = Union[CodecTables, Sequence[CodecTables]]


def _tables_list(tables: Tables):
    return [tables] if isinstance(tables, CodecTables) else list(tables)


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel route for device {t.device}")
    return t.device.type


def _i32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int32), device=device)


def quantize_encode(x: torch.Tensor, tables: CodecTables,
                    capacity_words: int, *, emit_codes: bool = False,
                    emit_hist: bool = False):
    """Fused e4m3-quantize + QLC-encode of float chunks [n, K].

    Returns (words int32 [n, CW] (u32 bit patterns), nbits int32 [n],
    scales f32 [n, K/32] [, codes u8 [n, K]] [, hist int32 [256]]).
    """
    if _route(x) == "cpu":
        return ref.quantize_encode_ref(x, tables, capacity_words,
                                       emit_codes=emit_codes,
                                       emit_hist=emit_hist)
    return qlc_fused.fused_encode(
        x.contiguous(), _i32(tables.enc_code, x.device),
        _i32(tables.enc_len, x.device), capacity_words,
        emit_codes=emit_codes, emit_hist=emit_hist)


def _decode(words, scales, tables: Tables, chunk_symbols: int, scheme_ids,
            out_dtype, acc):
    tables_list = _tables_list(tables)
    n = words.shape[0]
    if scheme_ids is None:
        sid = torch.zeros(n, dtype=torch.int32, device=words.device)
    else:
        sid = torch.as_tensor(scheme_ids, device=words.device
                              ).to(torch.int32).reshape(-1)
        if sid.shape[0] != n:
            raise ValueError(f"{sid.shape[0]} scheme ids for {n} chunks")
        # The kernel indexes its shared-memory LUTs with these slots.
        if n and not 0 <= int(sid.min()) <= int(sid.max()) < len(tables_list):
            raise ValueError(f"scheme ids must lie in [0, {len(tables_list)})")
    if _route(words) == "cpu":
        return ref.decode_dequantize_ref(words, scales, tables_list, sid,
                                         chunk_symbols, out_dtype=out_dtype,
                                         acc=acc)
    dec, sb, st, prefix_bits = codec.stack_decode_tables(tables_list)
    dev = words.device
    return qlc_fused.fused_decode(
        words.contiguous(), scales.float().contiguous(), sid,
        _i32(dec, dev), _i32(sb, dev), _i32(st, dev),
        torch.as_tensor(e4m3.decode_table(), device=dev), chunk_symbols,
        prefix_bits=prefix_bits, out_dtype=out_dtype,
        acc=None if acc is None else acc.float().contiguous())


def decode_dequantize(words: torch.Tensor, scales: torch.Tensor,
                      tables: Tables, chunk_symbols: int, *,
                      scheme_ids=None, out_dtype=torch.float32
                      ) -> torch.Tensor:
    """Fused QLC-decode + e4m3-dequantize: words int32 [n, CW] + scales
    f32 [n, K/32] -> [n, K] in ``out_dtype`` (f32 or bf16, cast with
    round-to-nearest-even)."""
    return _decode(words, scales, tables, chunk_symbols, scheme_ids,
                   out_dtype, None)


def decode_dequantize_accumulate(acc: torch.Tensor, words: torch.Tensor,
                                 scales: torch.Tensor, tables: Tables,
                                 chunk_symbols: int, *, scheme_ids=None
                                 ) -> torch.Tensor:
    """``acc + decode_dequantize(words, scales)`` in f32, in one launch;
    the product is rounded to f32 before the add (no FMA)."""
    if tuple(acc.shape) != (words.shape[0], chunk_symbols):
        raise ValueError(f"acc shape {tuple(acc.shape)} != "
                         f"{(words.shape[0], chunk_symbols)}")
    return _decode(words, scales, tables, chunk_symbols, scheme_ids,
                   torch.float32, acc)
