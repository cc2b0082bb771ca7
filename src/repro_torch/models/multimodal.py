"""Modality frontend stubs: the transformer backbone is real, and the
vision and audio encoders are replaced by precomputed embeddings.

A vlm or audio config's inputs carry a ``prefix_emb`` tensor of patch or
frame embeddings, which ``models.forward`` prepends to the token
embeddings. These helpers make such embeddings for smoke runs. They
match the reference's in distribution only (the reference draws with
``jax.random``); tests feed both packages the same numpy prefix.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import resolve_device


def prefix_spec(cfg: ModelConfig, batch: int
                ) -> Tuple[Tuple[int, int, int], torch.dtype]:
    """Shape and dtype of the frontend's output, ``[B, P, D]``."""
    return ((batch, cfg.frontend_prefix_len, cfg.d_model),
            getattr(torch, cfg.dtype))


def stub_prefix_embeddings(generator: torch.Generator, cfg: ModelConfig,
                           batch: int, device="cuda") -> torch.Tensor:
    """``[B, P, D]`` unit Gaussian patch or frame embeddings in
    ``cfg.dtype``, drawn from ``generator`` (which must live on
    ``device``)."""
    shape, dtype = prefix_spec(cfg, batch)
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=resolve_device(device))
