"""Wrappers of the codes kernels for Hopper (sm_90a): QLC over u8
symbols, no quantizer.

  K3 ``encode``           — u8 chunks -> word slots + bit counts
                            (``csrc/qlc_encode.cu``; replaces
                            ``repro/kernels/qlc_encode.py::encode_pallas``).
  K4 ``decode``           — word slots -> u8 chunks, multi-LUT
                            (``csrc/qlc_decode.cu``; replaces
                            ``repro/kernels/qlc_decode.py::decode_pallas``).
  K5 ``prefetch_decode``  — K4's function with each tile's words staged
                            into one of two shared-memory slots by a bulk
                            asynchronous copy (TMA)
                            (``csrc/qlc_prefetch.cu``; replaces
                            ``repro/kernels/qlc_prefetch.py::
                            prefetch_decode_pallas``).

K3 takes any chunk size that is a multiple of 32, slots of 1 to
``ENCODE_MAX_CAP`` words and codes of up to 32 bits; its launch geometry
is :func:`encode_geometry`, which refuses anything else with
``ValueError`` before the card is touched.

K4 and K5 decode through a per-scheme window table
(:func:`window_table`, built once per table set on the host and kept on
the card by ``kernels.ops``): for every (prefix + 8)-bit window, the
symbol and the code length in 2 bytes. They take codes of at most 16
bits (``prefix_bits`` up to 8) and as many stacked schemes as their
tables fit in one CTA's shared memory with the CTA's word buffers
(:func:`decode_smem`, :func:`prefetch_smem`); the wrappers refuse
anything beyond with ``ValueError`` before they touch the card. Scheme
slots are clamped into ``[0, S)`` by the kernels.

The sources build with the fused kernels' (``qlc_fused.build_kernels``).
The wrappers take CUDA tensors only; the CPU route to the plain versions
lives in ``kernels.ops``. Each counts its launches in a plain int
attribute (``encode.launches`` ...), incremented once per kernel launch
and nowhere else.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.qlc_fused import (ENCODE_MAX_CAP, MAX_CODE_BITS,
                                           MAX_SMEM, _aligned16, _check,
                                           _lib, _stream)

#: the widest area code K4 and K5 take: codes of at most 16 bits.
MAX_PREFIX_BITS = MAX_CODE_BITS - 8
#: shared memory one CTA can have on the H100 (227 KiB).
CTA_SMEM = 232448


#: the longest code K3 takes (codes of at most 16 bits are packed four
#: to a 64-bit step, longer ones two).
ENCODE_MAX_CODE_BITS = 32


def encode_geometry(chunk_symbols: int, capacity_words: int,
                    max_code_bits: int) -> Tuple[int, int, int]:
    """K3's launch geometry (``csrc/qlc_encode.cu``): (warps per CTA,
    chunks per warp turn, shared memory of one CTA in bytes). A warp's
    turn is 32 lanes of 32 symbols: up to ``32 / (k / 32)`` whole chunks
    of k <= 1024 symbols, or one 1024-symbol piece of a longer chunk. A
    CTA holds the encoder LUT (256 x 4 B, or 256 x 8 B for codes over 16
    bits) and each warp a slot of ``capacity_words`` per chunk of its
    turn: the most chunks a turn takes with the most warps of 8, 4, 2, 1
    that fit in 48 KiB, else one warp with as many chunks as fit. Raises
    ValueError outside K3's domain: ``chunk_symbols`` a positive multiple
    of 32, ``capacity_words`` in [1, ENCODE_MAX_CAP], ``max_code_bits``
    in [0, 32]."""
    k, cap, bits = int(chunk_symbols), int(capacity_words), int(max_code_bits)
    if k <= 0 or k % 32:
        raise ValueError(f"chunk size {k} must be a positive multiple of 32")
    if not 1 <= cap <= ENCODE_MAX_CAP:
        raise ValueError(f"capacity_words {cap} outside [1, "
                         f"{ENCODE_MAX_CAP}]")
    if not 0 <= bits <= ENCODE_MAX_CODE_BITS:
        raise ValueError(f"max_code_bits {bits} outside [0, "
                         f"{ENCODE_MAX_CODE_BITS}]")
    most = 1 if k > 1024 else 32 // (k // 32)
    lut = 256 * (8 if bits > MAX_CODE_BITS else 4)
    slot = 4 * cap
    warps = next((w for w in (8, 4, 2, 1)
                  if lut + w * most * slot <= MAX_SMEM), 0)
    chunks = most if warps else (MAX_SMEM - lut) // slot
    warps = max(warps, 1)
    return warps, chunks, lut + warps * chunks * slot


def encode_grid_chunks(chunk_symbols: int, capacity_words: int,
                       max_code_bits: int) -> int:
    """The chunks of a full K3 grid's first turns on the current card at
    these operands: the most chunks one launch encodes before its
    persistent warps go round again."""
    warps, chunks, _ = encode_geometry(chunk_symbols, capacity_words,
                                       max_code_bits)
    got = _lib("qlc_encode").qlc_encode_grid_warps(
        int(chunk_symbols), int(capacity_words), int(max_code_bits), warps,
        chunks)
    if got <= 0:
        raise RuntimeError(f"K3 occupancy query failed: CUDA error {-got}")
    return got * chunks


def encode(symbols: torch.Tensor, enc_code: torch.Tensor,
           enc_len: torch.Tensor, capacity_words: int, *,
           max_code_bits: int = ENCODE_MAX_CODE_BITS):
    """K3 on the card: u8 [n, K] (any byte offset) -> (words int32 [n, CW]
    (u32 bit patterns), nbits int32 [n]). ``enc_code`` / ``enc_len`` are
    int32 [256] CUDA tensors, every code below 2^len and no length over
    ``max_code_bits`` (not checked here, which would cost a
    device-to-host read per call; ``kernels.ops`` checks its tables once
    on the host and passes their longest code), which picks the pack:
    four codes a step up to 16 bits, two above."""
    if symbols.dim() != 2:
        raise ValueError(f"symbols must be [n, K], got "
                         f"{tuple(symbols.shape)}")
    n, k = symbols.shape
    cap = int(capacity_words)
    warps, chunks, _ = encode_geometry(k, cap, max_code_bits)
    _check(symbols, "symbols", (torch.uint8,), 2)
    for t, what in ((enc_code, "enc_code"), (enc_len, "enc_len")):
        _check(t, what, (torch.int32,), 1)
        if t.numel() != 256 or t.device != symbols.device:
            raise ValueError(f"{what} must be 256 entries on "
                             f"{symbols.device}")
    words = torch.empty((n, cap), dtype=torch.int32, device=symbols.device)
    nbits = torch.empty((n,), dtype=torch.int32, device=symbols.device)
    if n == 0:
        return words, nbits
    symbols = _aligned16(symbols)
    rc = _lib("qlc_encode").qlc_encode(
        symbols.data_ptr(), n, k, enc_code.data_ptr(), enc_len.data_ptr(),
        cap, words.data_ptr(), nbits.data_ptr(), int(max_code_bits), warps,
        chunks, _stream(symbols))
    if rc != 0:
        raise RuntimeError(f"K3 encode launch failed: CUDA error {rc}")
    encode.launches += 1
    return words, nbits


encode.launches = 0


def window_table(dec_lut, area_sb, area_starts, prefix_bits: int
                 ) -> Tuple[np.ndarray, int]:
    """K4's and K5's decode table from stacked decode LUTs (numpy ``dec
    [S, 256]``, ``area_sb`` / ``area_starts [S, 2^prefix]``): for each
    scheme and each (prefix + 8)-bit window, the code length (prefix +
    payload bits) in bits 0-4 and the symbol ``dec[min(first rank +
    payload, 255)]`` in bits 8-15 -- the reference's cursor step, rank
    clamp included. Returns (int16 [S, 2^(prefix + 8)] bit patterns, the
    longest code in bits)."""
    p = int(prefix_bits)
    if not 0 <= p <= MAX_PREFIX_BITS:
        raise ValueError(f"prefix_bits {p} outside [0, {MAX_PREFIX_BITS}]: "
                         f"K4/K5 take codes of at most {MAX_CODE_BITS} bits")
    dec = np.asarray(dec_lut, np.int64)
    sb = np.asarray(area_sb, np.int64)
    st = np.asarray(area_starts, np.int64)
    if sb.ndim != 2 or sb.shape[1] != 1 << p or st.shape != sb.shape \
            or dec.shape != (sb.shape[0], 256):
        raise ValueError(f"stacked tables {dec.shape}, {sb.shape}, "
                         f"{st.shape} do not fit prefix_bits {p}")
    if sb.min() < 0 or sb.max() > 8:
        raise ValueError("payload widths must lie in [0, 8]: K4/K5 take "
                         f"codes of at most {MAX_CODE_BITS} bits")
    win = np.arange(1 << (p + 8))
    area = win & ((1 << p) - 1)
    nb = sb[:, area]
    rank = np.minimum(st[:, area] + ((win >> p) & ((1 << nb) - 1)), 255)
    sym = np.take_along_axis(dec, rank, axis=1) & 255
    tab = ((p + nb) | (sym << 8)).astype(np.uint16).view(np.int16)
    return np.ascontiguousarray(tab), int(p + sb.max())


def decode_smem(n_schemes: int, prefix_bits: int) -> int:
    """Shared memory of one K4 CTA (one warp): the stacked window tables
    and 32 word rings of 128 words at a stride of 132
    (``csrc/qlc_decode.cu``)."""
    return (n_schemes << (prefix_bits + 9)) + 32 * 132 * 4


def prefetch_smem(n_schemes: int, prefix_bits: int, capacity_words: int,
                  tile_rows: int = 32) -> int:
    """Shared memory of one K5 CTA (one warp): its two barriers, the
    stacked window tables, and two slots of a ``tile_rows``-chunk tile's
    words widened to 16-byte ends (``csrc/qlc_prefetch.cu``)."""
    slot = (tile_rows * capacity_words + 9) & ~3
    return 16 + (n_schemes << (prefix_bits + 9)) + 2 * slot * 4


def prefetch_tile_rows(n_schemes: int, prefix_bits: int,
                       capacity_words: int) -> int:
    """Chunks per K5 tile: the most of 32, 16, ..., 1 whose two slots fit a
    CTA's shared memory beside the tables (0 when none does). A tile of
    fewer than 32 chunks leaves lanes of the warp idle."""
    return next((t for t in (32, 16, 8, 4, 2, 1) if prefetch_smem(
        n_schemes, prefix_bits, capacity_words, t) <= CTA_SMEM), 0)


def _decode_operands(what, words, scheme_ids, window, chunk_symbols: int,
                     prefix_bits: int, max_code_bits: int, geometry):
    """Checks in the order the CPU can make them (domain, then devices).
    ``geometry(S, CW)`` gives the CTA's shared memory and the launcher's
    extra arguments. Returns (words, n, cw, k, S, extra, out)."""
    k = int(chunk_symbols)
    if k % 4 or k <= 0:
        raise ValueError(f"chunk_symbols {k} must be a positive multiple "
                         "of 4")
    p = int(prefix_bits)
    if not 0 <= p <= MAX_PREFIX_BITS:
        raise ValueError(f"prefix_bits {p} outside [0, {MAX_PREFIX_BITS}]: "
                         f"{what} takes codes of at most {MAX_CODE_BITS} bits")
    if not 0 <= int(max_code_bits) <= p + 8:
        raise ValueError(f"max_code_bits {max_code_bits} outside "
                         f"[0, {p + 8}]")
    if words.dim() != 2 or words.shape[1] < 1:
        raise ValueError(f"words {tuple(words.shape)} must be [n, CW], "
                         "CW >= 1")
    if window.dim() != 2 or window.shape[1] != 1 << (p + 8):
        raise ValueError(f"window table {tuple(window.shape)} is not [S, "
                         f"{1 << (p + 8)}] at prefix_bits {p}")
    n, cw = words.shape
    s = window.shape[0]
    smem, extra = geometry(s, cw)
    if s < 1 or smem > CTA_SMEM:
        raise ValueError(f"{what}: {s} stacked schemes at prefix_bits {p} "
                         f"and {cw}-word slots need {smem} B of shared "
                         f"memory per CTA, more than the {CTA_SMEM} B it "
                         "can have")
    _check(words, "words", (torch.int32,), 2)
    _check(window, "window", (torch.int16,), 2)
    if window.device != words.device or window.data_ptr() % 16:
        raise ValueError("window table must be a 16-byte aligned tensor "
                         f"on {words.device}")
    if scheme_ids is not None:
        _check(scheme_ids, "scheme_ids", (torch.int32,), 1)
        if scheme_ids.shape != (n,) or scheme_ids.device != words.device:
            raise ValueError(f"scheme_ids {tuple(scheme_ids.shape)} on "
                             f"{scheme_ids.device} for words "
                             f"{tuple(words.shape)} on {words.device}")
    # The kernels read from the 16-byte aligned address at or below the
    # words; it must lie in their allocation.
    if words.untyped_storage().data_ptr() > words.data_ptr() & ~15:
        words = words.clone()
    out = torch.empty((n, k), dtype=torch.uint8, device=words.device)
    return words, n, cw, k, s, extra, out


def _launch(fn_name, what, words, scheme_ids, window, chunk_symbols,
            prefix_bits, max_code_bits, geometry):
    words, n, cw, k, s, extra, out = _decode_operands(
        what, words, scheme_ids, window, chunk_symbols, prefix_bits,
        max_code_bits, geometry)
    rc = getattr(_lib(fn_name), fn_name)(
        words.data_ptr(), n, cw,
        scheme_ids.data_ptr() if scheme_ids is not None else None,
        window.data_ptr(), s, int(prefix_bits), int(max_code_bits), k,
        out.data_ptr(), *extra, _stream(words))
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")
    return out


def decode(words: torch.Tensor, scheme_ids: Optional[torch.Tensor],
           window: torch.Tensor, chunk_symbols: int, *, prefix_bits: int,
           max_code_bits: int) -> torch.Tensor:
    """K4 on the card: words int32 [n, CW] (any 4-byte offset), scheme
    slots int32 [n] (or None: all 0), stacked window tables int16 [S,
    2^(prefix_bits + 8)] (:func:`window_table`) -> u8 [n, K].
    ``max_code_bits`` is the longest code of the stacked schemes."""
    p = int(prefix_bits)
    out = _launch("qlc_decode", "K4 decode", words, scheme_ids, window,
                  chunk_symbols, prefix_bits, max_code_bits,
                  lambda s, cw: (decode_smem(s, p), ()))
    decode.launches += 1
    return out


decode.launches = 0


def prefetch_decode(words: torch.Tensor, scheme_ids: Optional[torch.Tensor],
                    window: torch.Tensor, chunk_symbols: int, *,
                    prefix_bits: int, max_code_bits: int) -> torch.Tensor:
    """K5 on the card: K4's operands and result, with each tile's words
    staged into one of two shared-memory slots by a bulk copy. A tile is
    ``prefetch_tile_rows`` chunks: 32 while two slots of them fit beside
    the tables (353-word slots, 1024 symbols at worst case, do at a 3-bit
    prefix), fewer for wider slots or tables."""
    p = int(prefix_bits)

    def geometry(s, cw):
        rows = max(1, prefetch_tile_rows(s, p, cw))
        return prefetch_smem(s, p, cw, rows), (rows,)
    out = _launch("qlc_prefetch", "K5 prefetch_decode", words, scheme_ids,
                  window, chunk_symbols, prefix_bits, max_code_bits, geometry)
    prefetch_decode.launches += 1
    return out


prefetch_decode.launches = 0
