"""Wrapper of the histogram kernel for Hopper (sm_90a).

  K6 ``histogram256`` — u8 symbols -> int32 [256] counts
                        (``csrc/histogram256.cu``; replaces
                        ``repro/kernels/histogram256.py::histogram256_pallas``).

The source builds with the other kernels (``qlc_fused.build_kernels``).
The wrapper takes a CUDA tensor only; the CPU route to the plain version
lives in ``kernels.ops``. It counts its launches in a plain int attribute
(``histogram256.launches``), incremented once per kernel launch and
nowhere else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.qlc_fused import _check, _lib, _stream

#: most symbols one launch counts: int32 bins cannot hold more.
MAX_SYMBOLS = (1 << 31) - 1
_THREADS = 256
_CTAS_PER_SM = 8     # 8 KiB of per-warp bins and 256 threads per CTA


def histogram256(symbols: torch.Tensor) -> torch.Tensor:
    """K6 on the card: u8 [n] (contiguous, any byte offset) -> int32
    [256] counts."""
    _check(symbols, "symbols", (torch.uint8,), 1)
    n = symbols.numel()
    if n > MAX_SYMBOLS:
        raise ValueError(f"{n} symbols exceed one launch's int32 counts "
                         f"({MAX_SYMBOLS}); count in pieces")
    counts = torch.zeros(256, dtype=torch.int32, device=symbols.device)
    if n == 0:
        return counts
    sms = torch.cuda.get_device_properties(symbols.device).multi_processor_count
    blocks = max(1, min(-(-n // (16 * _THREADS)), sms * _CTAS_PER_SM))
    rc = _lib("histogram256").histogram256(
        symbols.data_ptr(), n, counts.data_ptr(), blocks, _stream(symbols))
    if rc != 0:
        raise RuntimeError(f"K6 histogram256 launch failed: CUDA error {rc}")
    histogram256.launches += 1
    return counts


histogram256.launches = 0
