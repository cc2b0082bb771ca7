"""Per-tensor-type codec calibration (paper §7: one LUT per tensor type,
derived apriori from a histogram of the quantized data).

The symbol histograms come out of K1's ``emit_hist`` side output, so on
the card no plain quantizer runs: block-32 symbols do not depend on how
the flat tensor is cut into chunk rows, so the bulk goes through K1 in
rows of 1024 and a ragged tail in rows of 32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import codec
from repro_torch.core.lut import identity_tables
from repro_torch.core.schemes import TABLE1
from repro_torch.kernels import ops
from repro_torch.models.transformer import tree_leaves
from repro_torch.quant import e4m3

_ROW = 1024
# Any tables give the same symbols; the encode half of K1 is unused.
_TABLES = identity_tables(TABLE1)


def histogram_of_quantized(x: torch.Tensor) -> np.ndarray:
    """float tensor -> counts[256] (float64) of its block-32 e4m3
    symbols; a trailing partial block is left out, as in the reference."""
    flat = x.reshape(-1)
    n = (flat.shape[0] // e4m3.BLOCK) * e4m3.BLOCK
    bulk = (n // _ROW) * _ROW
    counts = np.zeros(256, dtype=np.float64)
    for part, k in ((flat[:bulk], _ROW), (flat[bulk:n], e4m3.BLOCK)):
        if part.numel() == 0:
            continue
        *_, hist = ops.quantize_encode(part.reshape(-1, k), _TABLES,
                                       codec.worst_case_words(k),
                                       emit_hist=True)
        counts += hist.cpu().numpy()
    return counts


def histogram_of_tree(tree) -> np.ndarray:
    """Tree of float tensors -> summed counts[256] of their e4m3
    symbols, leaf by leaf: the calibration input for
    ``CodecRegistry.register("default", ...)``."""
    counts = np.zeros(256, dtype=np.float64)
    for leaf in tree_leaves(tree):
        counts += histogram_of_quantized(leaf)
    return counts
