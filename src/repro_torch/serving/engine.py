"""Serving helpers: token-by-token prefill and the compressed-weight
wire (``compress_params_for_serving`` / ``open_params``).

Compressed-weight serving stores the layer stack as block-32 e4m3 + QLC
words (``repro_torch.comm.weights``), compressed through K1, and opens
it through K2 before the engine starts. Only the local open is ported;
the chunk-sharded open over a mesh axis comes with the collectives.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode_step


@dataclasses.dataclass
class ServeConfig:
    max_seq_len: int
    max_new_tokens: int = 32
    greedy: bool = True


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, states):
    """Feed a prompt through the decode path token by token (the
    reference's implementation, correct for every block kind).

    tokens: [B, S]. Returns (last_logits [B, V], states).
    """
    b, s = tokens.shape
    logits = None
    for t in range(s):
        pos = torch.full((b, 1), t, dtype=torch.int32,
                         device=tokens.device)
        logits, states = decode_step(params, cfg, tokens[:, t:t + 1], states,
                                     pos)
    return logits[:, 0], states


def compress_params_for_serving(params, tables):
    """Wire a parameter tree for compressed serving: large layer-stack
    leaves become QLC words with exactly measured capacity plus bf16
    scales, everything else stays dense. ``tables`` is a
    ``CodecTables`` or a ``CodecRegistry``. Returns
    ``(wired_params, wire_codec)``; open with :func:`open_params`."""
    from repro_torch.comm.weights import compress_groups
    return compress_groups(params, tables)


def open_params(wired_params, wire_codec):
    """Decode a wired parameter tree back to dense tensors through K2
    (the plain version for tensors on the CPU)."""
    return wire_codec.open_group(wired_params)
