"""Wrappers of the codes kernels for Hopper (sm_90a): QLC over u8
symbols, no quantizer.

  K3 ``encode``           — u8 chunks -> word slots + bit counts
                            (``csrc/qlc_encode.cu``; replaces
                            ``repro/kernels/qlc_encode.py::encode_pallas``).
  K4 ``decode``           — word slots -> u8 chunks, multi-LUT
                            (``csrc/qlc_decode.cu``; replaces
                            ``repro/kernels/qlc_decode.py::decode_pallas``).
  K5 ``prefetch_decode``  — K4's function with the words staged through a
                            double-buffered ``cp.async`` copy into shared
                            memory (``csrc/qlc_prefetch.cu``; replaces
                            ``repro/kernels/qlc_prefetch.py::
                            prefetch_decode_pallas``).

The sources build with the fused kernels' (``qlc_fused.build_kernels``).
The wrappers take CUDA tensors only; the CPU route to the plain versions
lives in ``kernels.ops``. Each counts its launches in a plain int
attribute (``encode.launches`` ...), incremented once per kernel launch
and nowhere else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.qlc_fused import (MAX_SMEM, _check, _lib, _stream,
                                           _threads_for)

#: shared memory K5 may give its two word slots (of the 227 KiB a CTA
#: can have, leaving room for the LUTs and the staging tiles).
PREFETCH_SMEM = 160 * 1024


def encode(symbols: torch.Tensor, enc_code: torch.Tensor,
           enc_len: torch.Tensor, capacity_words: int):
    """K3 on the card: u8 [n, K] -> (words int32 [n, CW] (u32 bit
    patterns), nbits int32 [n]). ``enc_code`` / ``enc_len`` are int32
    [256] CUDA tensors."""
    _check(symbols, "symbols", (torch.uint8,), 2)
    for t, what in ((enc_code, "enc_code"), (enc_len, "enc_len")):
        _check(t, what, (torch.int32,), 1)
        if t.numel() != 256 or t.device != symbols.device:
            raise ValueError(f"{what} must be 256 entries on "
                             f"{symbols.device}")
    n, k = symbols.shape
    cap = int(capacity_words)
    max_cap = (MAX_SMEM - 4096) // 4     # 4 KiB of static tables/scan
    if not 1 <= cap <= max_cap:
        raise ValueError(f"capacity_words {cap} outside [1, {max_cap}]")
    threads = _threads_for(k)
    words = torch.empty((n, cap), dtype=torch.int32, device=symbols.device)
    nbits = torch.empty((n,), dtype=torch.int32, device=symbols.device)
    rc = _lib("qlc_encode").qlc_encode(
        symbols.data_ptr(), n, k, enc_code.data_ptr(), enc_len.data_ptr(),
        cap, words.data_ptr(), nbits.data_ptr(), threads, _stream(symbols))
    if rc != 0:
        raise RuntimeError(f"K3 encode launch failed: CUDA error {rc}")
    encode.launches += 1
    return words, nbits


encode.launches = 0


def _decode_operands(words, scheme_ids, dec_lut, area_sb, area_starts,
                     chunk_symbols: int):
    _check(words, "words", (torch.int32,), 2)
    n, _ = words.shape
    k = int(chunk_symbols)
    if k % 4 or k <= 0:
        raise ValueError(f"chunk_symbols {k} must be a positive multiple "
                         "of 4")
    _check(scheme_ids, "scheme_ids", (torch.int32,), 1)
    for t, what in ((dec_lut, "dec_lut"), (area_sb, "area_sb"),
                    (area_starts, "area_starts")):
        _check(t, what, (torch.int32,), 2)
    s, a = area_sb.shape
    if (scheme_ids.shape != (n,) or dec_lut.shape != (s, 256)
            or area_starts.shape != (s, a)):
        raise ValueError("operand shapes disagree: words "
                         f"{tuple(words.shape)}, sid "
                         f"{tuple(scheme_ids.shape)}, dec_lut "
                         f"{tuple(dec_lut.shape)}, area {tuple(area_sb.shape)}")
    if s * (256 + 2 * a) * 4 > 16 * 1024:
        raise ValueError(f"{s} stacked schemes exceed the kernel's LUT "
                         "shared memory")
    out = torch.empty((n, k), dtype=torch.uint8, device=words.device)
    return n, k, s, a, out


def decode(words: torch.Tensor, scheme_ids: torch.Tensor,
           dec_lut: torch.Tensor, area_sb: torch.Tensor,
           area_starts: torch.Tensor, chunk_symbols: int, *,
           prefix_bits: int) -> torch.Tensor:
    """K4 on the card: words int32 [n, CW], scheme slots int32 [n],
    stacked LUTs int32 ``dec_lut [S, 256]`` / ``area_* [S, A]`` -> u8
    [n, K]."""
    n, k, s, a, out = _decode_operands(words, scheme_ids, dec_lut,
                                       area_sb, area_starts, chunk_symbols)
    rc = _lib("qlc_decode").qlc_decode(
        words.data_ptr(), n, words.shape[1], scheme_ids.data_ptr(),
        dec_lut.data_ptr(), area_sb.data_ptr(), area_starts.data_ptr(), s, a,
        int(prefix_bits), k, out.data_ptr(), _stream(words))
    if rc != 0:
        raise RuntimeError(f"K4 decode launch failed: CUDA error {rc}")
    decode.launches += 1
    return out


decode.launches = 0


def prefetch_warps(capacity_words: int) -> int:
    """Warps per CTA of K5 (its tile is 32 chunks per warp): the most of
    4, 2, 1 whose two word slots fit in ``PREFETCH_SMEM``."""
    stride = int(capacity_words) | 1
    for warps in (4, 2, 1):
        if 2 * 32 * warps * stride * 4 <= PREFETCH_SMEM:
            return warps
    raise ValueError(f"a {capacity_words}-word slot is too wide for K5's "
                     "double buffer")


def prefetch_decode(words: torch.Tensor, scheme_ids: torch.Tensor,
                    dec_lut: torch.Tensor, area_sb: torch.Tensor,
                    area_starts: torch.Tensor, chunk_symbols: int, *,
                    prefix_bits: int) -> torch.Tensor:
    """K5 on the card: K4's operands and result, with the words staged
    tile by tile through two shared-memory slots."""
    n, k, s, a, out = _decode_operands(words, scheme_ids, dec_lut,
                                       area_sb, area_starts, chunk_symbols)
    warps = prefetch_warps(words.shape[1])
    rc = _lib("qlc_prefetch").qlc_prefetch(
        words.data_ptr(), n, words.shape[1], scheme_ids.data_ptr(),
        dec_lut.data_ptr(), area_sb.data_ptr(), area_starts.data_ptr(), s, a,
        int(prefix_bits), k, out.data_ptr(), warps, _stream(words))
    if rc != 0:
        raise RuntimeError(f"K5 prefetch_decode launch failed: CUDA error "
                           f"{rc}")
    prefetch_decode.launches += 1
    return out


prefetch_decode.launches = 0
