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
                                  a double-buffered bulk copy: K5.
  histogram                     — u8 symbols -> int32 [256] counts: K6.

Every decode entry point takes one ``CodecTables`` or a sequence of them
with ``scheme_ids`` (int [n_chunks]) naming each chunk's scheme: stacked
multi-LUT operands, as in the reference. Scheme ids given as host data
(a list, an array, a CPU tensor) are checked against the number of
tables before they are uploaded, and a ``ValueError`` names any outside
``[0, S)``. Ids given as a CUDA tensor are not read back, which would
block the host on the card: the kernels clamp each into ``[0, S)`` (as
XLA clamps a dynamic index), so they never read outside their tables.
The device copies of the tables (LUTs, window tables, the e4m3 value
table) are made once per table set and kept, keyed by
``CodecTables.digest``; after one warm call a decode on the card makes no
device-to-host read and no upload. The CUDA kernels need no row
padding, so the reference's TPU tile table has no counterpart here; the
histogram counts exactly the symbols of the n input rows, which is what
the reference returns after it takes its padding rows back out of bin 0.
Words are int32 tensors holding u32 bit patterns, and bit counts int32.

Inside ``roofline.op_count.count()`` each entry on fake tensors is one
counted op with empty outputs (``counted_kernel``, the hook at its top);
outside it the hook costs one look at the dispatch-mode stack.
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
from repro_torch.roofline.op_count import counted_kernel

Tables = Union[CodecTables, Sequence[CodecTables]]


def _tables_list(tables: Tables):
    return [tables] if isinstance(tables, CodecTables) else list(tables)


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel route for device {t.device}")
    return t.device.type


def _i32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int32), device=device)


_DEVICE_TABLES: Dict[Tuple, object] = {}


def _on_device(key: Tuple, make):
    """``make()``'s device tables, made once per key: the key names the
    tables by ``CodecTables.digest`` (computed once per instance), so a
    call looks them up without re-stacking or hashing any array, and a
    decode issued on a side stream uploads nothing (a pageable upload
    would wait for the stream's earlier work)."""
    hit = _DEVICE_TABLES.get(key)
    if hit is None:
        hit = make()
        # Entries are never dropped: a kernel queued on another stream
        # may still read them.
        if len(_DEVICE_TABLES) < 256:
            _DEVICE_TABLES[key] = hit
    return hit


def _encode_luts(tables: CodecTables, device):
    """K1's and K3's int32 [256] code and length tables on ``device``, and
    the longest code in bits. Checked on the host once per table set
    (the kernels OR codes into place where the reference adds them):
    every length in [0, 32] and every code below 2^length, else
    ValueError."""
    def make():
        code = np.asarray(tables.enc_code).astype(np.int64)
        length = np.asarray(tables.enc_len).astype(np.int64)
        if code.shape != (256,) or length.shape != (256,):
            raise ValueError(f"encoder tables {code.shape}, {length.shape} "
                             "are not [256]")
        if length.min() < 0 or length.max() > 32:
            raise ValueError("code lengths must lie in [0, 32], got "
                             f"[{length.min()}, {length.max()}]")
        if code.min() < 0 or (code >> length).any():
            bad = np.flatnonzero((code < 0) | (code >> length != 0))
            raise ValueError(f"codes of symbols {bad[:8].tolist()} do not "
                             "fit their lengths")
        return _i32(code, device), _i32(length, device), int(length.max())
    return _on_device(("enc", str(device), tables.digest), make)


def _area_luts(tables_list, device):
    """K2's stacked decode LUTs on ``device``: (dec [S, 256], area_sb,
    area_starts [S, 2^p], prefix_bits)."""
    def make():
        dec, sb, st, pb = codec.stack_decode_tables(tables_list)
        return _i32(dec, device), _i32(sb, device), _i32(st, device), pb
    return _on_device(("area", str(device))
                      + tuple(t.digest for t in tables_list), make)


def _window_luts(tables_list, device):
    """K4's and K5's stacked window tables on ``device``: (int16 [S,
    2^(p + 8)], prefix_bits, longest code in bits)."""
    def make():
        dec, sb, st, pb = codec.stack_decode_tables(tables_list)
        tab, longest = qlc_codes.window_table(dec, sb, st, pb)
        return torch.from_numpy(tab).to(device), pb, longest
    return _on_device(("window", str(device))
                      + tuple(t.digest for t in tables_list), make)


def _value_table(device) -> torch.Tensor:
    """The e4m3 value table, f32 [256], on ``device``."""
    return _on_device(("e4m3", str(device)), lambda: torch.as_tensor(
        e4m3.decode_table(), device=device))


def _scheme_slots(n_tables: int, n: int, scheme_ids, device):
    """The chunks' scheme slots for a decode on ``device``: None (all 0),
    or int32 [n]. Ids given as host data are range-checked before upload;
    ids already on the card are not read back (the kernels clamp them into
    ``[0, n_tables)``)."""
    if scheme_ids is None:
        return None
    if (isinstance(scheme_ids, torch.Tensor) and device.type == "cuda"
            and scheme_ids.device.type == "cuda"):
        sid = scheme_ids.reshape(-1)
        if sid.shape[0] != n:
            raise ValueError(f"{sid.shape[0]} scheme ids for {n} chunks")
        return sid.to(device=device, dtype=torch.int32)
    if isinstance(scheme_ids, torch.Tensor):
        scheme_ids = scheme_ids.cpu()
    host = np.asarray(scheme_ids, np.int64).reshape(-1)
    if host.shape[0] != n:
        raise ValueError(f"{host.shape[0]} scheme ids for {n} chunks")
    if n and not 0 <= host.min() <= host.max() < n_tables:
        raise ValueError(f"scheme ids must lie in [0, {n_tables})")
    return torch.from_numpy(host.astype(np.int32)).to(device)


def quantize_encode(x: torch.Tensor, tables: CodecTables,
                    capacity_words: int, *, emit_codes: bool = False,
                    emit_hist: bool = False):
    """Fused e4m3-quantize + QLC-encode of float chunks [n, K].

    Returns (words int32 [n, CW] (u32 bit patterns), nbits int32 [n],
    scales f32 [n, K/32] [, codes u8 [n, K]] [, hist int32 [256]]).
    """
    counted = counted_kernel("quantize_encode", x, tables, capacity_words,
                             emit_codes=emit_codes, emit_hist=emit_hist)
    if counted is not None:
        return counted
    if _route(x) == "cpu":
        return ref.quantize_encode_ref(x, tables, capacity_words,
                                       emit_codes=emit_codes,
                                       emit_hist=emit_hist)
    code, length, longest = _encode_luts(tables, x.device)
    if longest > qlc_fused.MAX_CODE_BITS:
        raise ValueError(f"K1 takes codes of at most "
                         f"{qlc_fused.MAX_CODE_BITS} bits, the tables have "
                         f"{longest}")
    return qlc_fused.fused_encode(
        x.contiguous(), code, length, capacity_words,
        emit_codes=emit_codes, emit_hist=emit_hist)


def _decode(words, scales, tables: Tables, chunk_symbols: int, scheme_ids,
            out_dtype, acc):
    tables_list = _tables_list(tables)
    route = _route(words)
    sid = _scheme_slots(len(tables_list), words.shape[0], scheme_ids,
                        words.device)
    if route == "cpu":
        return ref.decode_dequantize_ref(
            words, scales, tables_list, 0 if sid is None else sid,
            chunk_symbols, out_dtype=out_dtype, acc=acc)
    dev = words.device
    dec, sb, st, prefix_bits = _area_luts(tables_list, dev)
    if sid is None:
        sid = torch.zeros(words.shape[0], dtype=torch.int32, device=dev)
    return qlc_fused.fused_decode(
        words.contiguous(), scales.float().contiguous(), sid, dec, sb, st,
        _value_table(dev), chunk_symbols, prefix_bits=prefix_bits,
        out_dtype=out_dtype,
        acc=None if acc is None else acc.float().contiguous())


def decode_dequantize(words: torch.Tensor, scales: torch.Tensor,
                      tables: Tables, chunk_symbols: int, *,
                      scheme_ids=None, out_dtype=torch.float32
                      ) -> torch.Tensor:
    """Fused QLC-decode + e4m3-dequantize: words int32 [n, CW] + scales
    f32 [n, K/32] -> [n, K] in ``out_dtype`` (f32 or bf16, cast with
    round-to-nearest-even)."""
    counted = counted_kernel("decode_dequantize", words, scales, tables,
                             chunk_symbols, scheme_ids=scheme_ids,
                             out_dtype=out_dtype)
    if counted is not None:
        return counted
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
    counted = counted_kernel("decode_dequantize_accumulate", acc, words,
                             scales, tables, chunk_symbols,
                             scheme_ids=scheme_ids)
    if counted is not None:
        return counted
    return _decode(words, scales, tables, chunk_symbols, scheme_ids,
                   torch.float32, acc)


def encode(symbols: torch.Tensor, tables: CodecTables, capacity_words: int):
    """QLC-encode u8 chunks [n, K] -> (words int32 [n, CW] (u32 bit
    patterns), nbits int32 [n]), through K3 on the card."""
    if symbols.dtype != torch.uint8 or symbols.dim() != 2:
        raise TypeError(f"symbols must be u8 [n, K], got {symbols.dtype}"
                        f"{tuple(symbols.shape)}")
    counted = counted_kernel("encode", symbols, tables, capacity_words)
    if counted is not None:
        return counted
    if _route(symbols) == "cpu":
        return ref.encode_ref(symbols, tables, capacity_words)
    code, length, longest = _encode_luts(tables, symbols.device)
    return qlc_codes.encode(symbols.contiguous(), code, length,
                            capacity_words, max_code_bits=longest)


def _codes_decode(kernel, plain, words, tables: Tables, chunk_symbols: int,
                  scheme_ids):
    tables_list = _tables_list(tables)
    route = _route(words)
    sid = _scheme_slots(len(tables_list), words.shape[0], scheme_ids,
                        words.device)
    if route == "cpu":
        return plain(words, tables_list, 0 if sid is None else sid,
                     chunk_symbols)
    window, prefix_bits, longest = _window_luts(tables_list, words.device)
    return kernel(words.contiguous(), sid, window, chunk_symbols,
                  prefix_bits=prefix_bits, max_code_bits=longest)


def decode(words: torch.Tensor, tables: Tables, chunk_symbols: int, *,
           scheme_ids=None) -> torch.Tensor:
    """QLC-decode words int32 [n, CW] -> u8 [n, K], multi-LUT by
    ``scheme_ids``, through K4 on the card."""
    counted = counted_kernel("decode", words, tables, chunk_symbols,
                             scheme_ids=scheme_ids)
    if counted is not None:
        return counted
    return _codes_decode(qlc_codes.decode, ref.decode_ref, words, tables,
                         chunk_symbols, scheme_ids)


def decode_block_async(words: torch.Tensor, tables: Tables,
                       chunk_symbols: int, *, scheme_ids=None
                       ) -> torch.Tensor:
    """:func:`decode`, bit for bit, with the words staged tile by tile
    through K5's double-buffered bulk copy into shared memory: the decode
    the async KV paging path issues ahead of a block's use."""
    counted = counted_kernel("decode_block_async", words, tables,
                             chunk_symbols, scheme_ids=scheme_ids)
    if counted is not None:
        return counted
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
    counted = counted_kernel("histogram", symbols)
    if counted is not None:
        return counted
    if _route(symbols) == "cpu":
        return ref.histogram256_ref(symbols)
    return _hist.histogram256(symbols.reshape(-1).contiguous())
