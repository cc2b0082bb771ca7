"""e4m3 quantization in PyTorch: the plain versions that the fused
kernels (``repro_torch.kernels``) are held bit-exact against.

eXmY e4m3, all-finite variant (paper §3): S.EEEE.MMM, bias 7, max
2^8 * 1.875 = 480, no NaN/Inf. Encoding is a round-to-nearest-even
search over the 128 non-negative grid values. Block scaling uses blocks
of 32 along the last axis with ``scale = amax * (1/480)``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

E4M3_BIAS = 7
E4M3_MAX_FINITE = 480.0
BLOCK = 32
#: f32 reciprocal of the max, applied as an explicit multiply. A divide
#: by the constant would be rewritten to a reciprocal multiply by some
#: compilers and not by others; the multiply is the same everywhere.
INV_MAX = float(np.float32(1.0) / np.float32(E4M3_MAX_FINITE))


def _build_decode_table() -> np.ndarray:
    """Value of each of the 256 eXmY e4m3 codes (code = S EEEE MMM)."""
    codes = np.arange(256, dtype=np.uint32)
    sign = np.where(codes & 0x80, -1.0, 1.0)
    exp = ((codes >> 3) & 0xF).astype(np.int32)
    man = (codes & 0x7).astype(np.float64)
    mag = np.where(exp == 0,
                   (man / 8.0) * 2.0 ** (1 - E4M3_BIAS),
                   (1.0 + man / 8.0) * 2.0 ** (exp - E4M3_BIAS))
    return (sign * mag).astype(np.float32)


_DECODE_TABLE = _build_decode_table()
_POS_VALUES = _DECODE_TABLE[:128].copy()   # strictly increasing


def decode_table() -> np.ndarray:
    return _DECODE_TABLE.copy()


#: the value table on each device it was used on, uploaded once: a copy
#: from host memory waits for the device's queued work, and the wire's
#: value decode dequantizes its escape pool on every call
_TABLES: Dict[torch.device, torch.Tensor] = {}


def _value_table(codes: torch.Tensor) -> torch.Tensor:
    """The 256 values on ``codes``'s device; made anew for a fake tensor
    (``FakeTensorMode``), whose table has no storage to keep."""
    from torch._subclasses.fake_tensor import is_fake
    if is_fake(codes):
        return torch.as_tensor(_DECODE_TABLE, device=codes.device)
    table = _TABLES.get(codes.device)
    if table is None:
        table = _TABLES[codes.device] = torch.as_tensor(
            _DECODE_TABLE, device=codes.device)
    return table


def e4m3_decode(codes: torch.Tensor) -> torch.Tensor:
    """uint8 codes -> float32 values."""
    return _value_table(codes)[codes.long()]


def e4m3_encode(x: torch.Tensor) -> torch.Tensor:
    """float32 -> uint8 codes, round-to-nearest-even on the e4m3 grid.

    Values beyond +-480 saturate; NaN maps to max magnitude; the sign
    bit is kept (-0.0 -> 0x80).
    """
    pos = torch.as_tensor(_POS_VALUES, device=x.device)
    mag = x.abs()
    mag = torch.where(torch.isnan(mag), torch.full_like(mag, E4M3_MAX_FINITE),
                      mag)
    mag = torch.clamp(mag, max=E4M3_MAX_FINITE)
    hi = torch.searchsorted(pos, mag.contiguous(), side="left").clamp(0, 127)
    lo = (hi - 1).clamp(min=0)
    dhi = pos[hi] - mag
    dlo = mag - pos[lo]
    pick_lo = (dlo < dhi) | ((dlo == dhi) & (lo % 2 == 0))
    code = torch.where(pick_lo, lo, hi)
    code = torch.where(torch.signbit(x), code | 0x80, code)
    return code.to(torch.uint8)


def quantize_block32(x: torch.Tensor, block: int = BLOCK
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-scaled e4m3 quantization along the last axis.

    Returns (codes uint8 shaped like x, scales float32 [..., n/block]).
    """
    *lead, n = x.shape
    if n % block != 0:
        raise ValueError(f"last axis {n} not divisible by block {block}")
    xb = x.reshape(*lead, n // block, block).float()
    amax = xb.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax * INV_MAX, torch.ones_like(amax))
    codes = e4m3_encode(xb / scale)
    return codes.reshape(*lead, n), scale[..., 0]


def dequantize_block32(codes: torch.Tensor, scales: torch.Tensor,
                       block: int = BLOCK) -> torch.Tensor:
    *lead, n = codes.shape
    cb = codes.reshape(*lead, n // block, block)
    vals = e4m3_decode(cb) * scales[..., None].float()
    return vals.reshape(*lead, n)


#: values per piece of the piecewise (de)quantizers below.
PIECE = 1 << 24


def quantize_block32_pieces(x: torch.Tensor, piece: int = PIECE
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantize_block32` of ``x`` [..., n] computed over its
    flattened blocks in pieces of at most ``piece`` values: each block
    of 32 is quantized on its own, so the codes and scales are the same,
    and the temporaries (the encoder's int64 search indices are 8 B per
    value) stay bounded by the piece instead of the tensor."""
    *lead, n = x.shape
    if n % BLOCK:
        raise ValueError(f"last axis {n} not divisible by block {BLOCK}")
    flat = x.reshape(-1)
    codes = torch.empty(flat.shape, dtype=torch.uint8, device=x.device)
    scales = torch.empty(flat.shape[0] // BLOCK, dtype=torch.float32,
                         device=x.device)
    step = max(BLOCK, piece // BLOCK * BLOCK)
    for s in range(0, flat.shape[0], step):
        c, sc = quantize_block32(flat[s:s + step])
        codes[s:s + step] = c
        scales[s // BLOCK:(s + c.shape[0]) // BLOCK] = sc
    return codes.reshape(x.shape), scales.reshape(*lead, n // BLOCK)


def dequantize_block32_pieces(codes: torch.Tensor, scales: torch.Tensor,
                              piece: int = PIECE) -> torch.Tensor:
    """:func:`dequantize_block32` in pieces of at most ``piece`` values:
    the same values, temporaries bounded by the piece."""
    flat = codes.reshape(-1)
    sc = scales.reshape(-1)
    out = torch.empty(flat.shape, dtype=torch.float32, device=codes.device)
    step = max(BLOCK, piece // BLOCK * BLOCK)
    for s in range(0, flat.shape[0], step):
        part = flat[s:s + step]
        out[s:s + step] = dequantize_block32(
            part, sc[s // BLOCK:(s + part.shape[0]) // BLOCK])
    return out.reshape(codes.shape)
