"""Synthetic e4m3 symbol streams of the paper's settings (§3-§4).

The port's copy of the reference's ``core/distributions.py``: the same
activations (FFN1: a Gaussian with a mild heavy tail; FFN2: GELU output
with an exactly-zero spike; gradients: logistic), quantized to block-32
e4m3 by the port's quantizer. The draws come from an explicit
``torch.Generator`` seeded with ``seed``, where the reference splits a
``jax.random`` key, so the two packages agree in distribution, not
symbol for symbol. Two of the reference's defaults carried over as they
are: ``jax.nn.gelu`` is the tanh approximation, and
``jax.random.logistic`` draws ``log(u) - log1p(-u)`` of a uniform ``u``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.quant import e4m3

NUM_SYMBOLS = 256


def histogram256(symbols: np.ndarray) -> np.ndarray:
    """Counts[256] of a uint8 symbol array (numpy)."""
    return np.bincount(
        np.asarray(symbols, dtype=np.uint8).reshape(-1), minlength=256
    ).astype(np.float64)


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(int(seed))


def _uniform(gen: torch.Generator, n: int) -> torch.Tensor:
    return torch.rand(n, generator=gen, dtype=torch.float32)


def _quantized(x: torch.Tensor) -> np.ndarray:
    codes, _ = e4m3.quantize_block32_pieces(x)
    return codes.numpy().astype(np.uint8)


def ffn1_symbols(n: int = 1 << 20, seed: int = 0,
                 outlier_frac: float = 0.01) -> np.ndarray:
    """FFN1-activation-like stream: Gaussian with a mild heavy tail,
    block-32 e4m3 quantized."""
    gen = _generator(seed)
    n = (n // e4m3.BLOCK) * e4m3.BLOCK
    x = torch.randn(n, generator=gen, dtype=torch.float32)
    # Mild heavy tail: a few values carry larger activations.
    boost = torch.where(_uniform(gen, n) < outlier_frac,
                        4.0 + 4.0 * _uniform(gen, n), torch.ones(()))
    return _quantized(x * boost)


def ffn2_symbols(n: int = 1 << 20, seed: int = 1,
                 zero_frac: float = 0.18) -> np.ndarray:
    """FFN2-activation-like stream: post-nonlinearity (a zero spike plus a
    positive-heavy tail), block-32 e4m3 quantized; ``zero_frac`` is the
    exactly-zero mass, the rest is GELU output."""
    gen = _generator(seed)
    n = (n // e4m3.BLOCK) * e4m3.BLOCK
    y = torch.nn.functional.gelu(
        torch.randn(n, generator=gen, dtype=torch.float32),
        approximate="tanh")
    y = torch.where(_uniform(gen, n) < zero_frac, torch.zeros(()), y)
    return _quantized(y)


def grad_symbols(n: int = 1 << 20, seed: int = 2) -> np.ndarray:
    """Weight-gradient-like stream (zero-mean, heavier tails: logistic)."""
    gen = _generator(seed)
    n = (n // e4m3.BLOCK) * e4m3.BLOCK
    # Open interval: u in (0, 1), as jax.random.logistic's uniform.
    u = _uniform(gen, n).clamp(min=torch.finfo(torch.float32).tiny)
    return _quantized(torch.log(u) - torch.log1p(-u))


def ffn1_counts(n: int = 1 << 20, seed: int = 0) -> np.ndarray:
    return histogram256(ffn1_symbols(n, seed))


def ffn2_counts(n: int = 1 << 20, seed: int = 1) -> np.ndarray:
    return histogram256(ffn2_symbols(n, seed))


def grad_counts(n: int = 1 << 20, seed: int = 2) -> np.ndarray:
    return histogram256(grad_symbols(n, seed))
