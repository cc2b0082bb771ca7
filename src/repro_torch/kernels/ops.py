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
  encode                        — u8 symbols -> (words, nbits): K3.
  decode                        — words -> u8 symbols: K4.
  decode_block_async            — ``decode`` with the words staged through
                                  a double-buffered copy: K5.
  histogram                     — u8 symbols -> int32 [256] counts: K6.

Every decode entry point takes one ``CodecTables`` or a sequence of them
with ``scheme_ids`` (int [n_chunks]) naming each chunk's scheme: stacked
multi-LUT operands, as in the reference. The CUDA kernels need no row
padding, so the reference's TPU tile table has no counterpart here; the
histogram counts exactly the symbols of the n input rows, which is what
the reference returns after it takes its padding rows back out of bin 0.
Words are int32 tensors holding u32 bit patterns, and bit counts int32.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import codec
from repro_torch.core.lut import CodecTables
from repro_torch.kernels import histogram256 as _hist
from repro_torch.kernels import qlc_codes, qlc_fused, ref
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


_LUT_CACHE: Dict[Tuple, Tuple[torch.Tensor, ...]] = {}


def _device_luts(arrays, device) -> Tuple[torch.Tensor, ...]:
    """int32 copies of small host tables on ``device``, kept per content:
    a decode issued on a side stream then uploads nothing (a pageable
    upload would wait for the stream's earlier work)."""
    arrays = [np.ascontiguousarray(np.asarray(a, np.int32)) for a in arrays]
    key = (str(device),) + tuple((a.shape, a.tobytes()) for a in arrays)
    hit = _LUT_CACHE.get(key)
    if hit is None:
        hit = tuple(torch.from_numpy(a).to(device) for a in arrays)
        # Entries are never dropped: a kernel queued on another stream
        # may still read them.
        if len(_LUT_CACHE) < 256:
            _LUT_CACHE[key] = hit
    return hit


def _scheme_slots(tables: Tables, n: int, scheme_ids, device):
    """(tables list, int32 [n] scheme slot per chunk), validated."""
    tables_list = _tables_list(tables)
    if scheme_ids is None:
        return tables_list, torch.zeros(n, dtype=torch.int32, device=device)
    sid = torch.as_tensor(scheme_ids, device=device).to(torch.int32
                                                        ).reshape(-1)
    if sid.shape[0] != n:
        raise ValueError(f"{sid.shape[0]} scheme ids for {n} chunks")
    # The kernels index their shared-memory LUTs with these slots.
    if n and not 0 <= int(sid.min()) <= int(sid.max()) < len(tables_list):
        raise ValueError(f"scheme ids must lie in [0, {len(tables_list)})")
    return tables_list, sid


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
    tables_list, sid = _scheme_slots(tables, words.shape[0], scheme_ids,
                                     words.device)
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


def encode(symbols: torch.Tensor, tables: CodecTables, capacity_words: int):
    """QLC-encode u8 chunks [n, K] -> (words int32 [n, CW] (u32 bit
    patterns), nbits int32 [n]), through K3 on the card."""
    if symbols.dtype != torch.uint8 or symbols.dim() != 2:
        raise TypeError(f"symbols must be u8 [n, K], got {symbols.dtype}"
                        f"{tuple(symbols.shape)}")
    if _route(symbols) == "cpu":
        return ref.encode_ref(symbols, tables, capacity_words)
    enc_code, enc_len = _device_luts((tables.enc_code, tables.enc_len),
                                     symbols.device)
    return qlc_codes.encode(symbols.contiguous(), enc_code, enc_len,
                            capacity_words)


def _codes_decode(kernel, plain, words, tables: Tables, chunk_symbols: int,
                  scheme_ids):
    tables_list, sid = _scheme_slots(tables, words.shape[0], scheme_ids,
                                     words.device)
    if _route(words) == "cpu":
        return plain(words, tables_list, sid, chunk_symbols)
    dec, sb, st, prefix_bits = codec.stack_decode_tables(tables_list)
    return kernel(words.contiguous(), sid,
                  *_device_luts((dec, sb, st), words.device), chunk_symbols,
                  prefix_bits=prefix_bits)


def decode(words: torch.Tensor, tables: Tables, chunk_symbols: int, *,
           scheme_ids=None) -> torch.Tensor:
    """QLC-decode words int32 [n, CW] -> u8 [n, K], multi-LUT by
    ``scheme_ids``, through K4 on the card."""
    return _codes_decode(qlc_codes.decode, ref.decode_ref, words, tables,
                         chunk_symbols, scheme_ids)


def decode_block_async(words: torch.Tensor, tables: Tables,
                       chunk_symbols: int, *, scheme_ids=None
                       ) -> torch.Tensor:
    """:func:`decode`, bit for bit, with the words streamed tile by tile
    through K5's double-buffered shared-memory copy: the decode the async
    KV paging path issues ahead of a block's use."""
    return _codes_decode(qlc_codes.prefetch_decode,
                         ref.decode_block_async_ref, words, tables,
                         chunk_symbols, scheme_ids)


def histogram(symbols: torch.Tensor) -> torch.Tensor:
    """u8 symbols (any shape, at most 2^31 - 1 of them) -> int32 [256]
    counts, through K6 on the card. The reference pads to its tile and
    takes the padding back out of bin 0; K6 needs no padding, so the
    counts are those of exactly the symbols given."""
    if symbols.dtype != torch.uint8:
        raise TypeError(f"symbols must be u8, got {symbols.dtype}")
    if _route(symbols) == "cpu":
        return ref.histogram256_ref(symbols)
    return _hist.histogram256(symbols.reshape(-1).contiguous())
