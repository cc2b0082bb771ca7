"""Serving helpers: token-by-token prefill, the greedy window step, and
the compressed-weight wire (``compress_params_for_serving`` /
``open_params``).

``prefill(..., start_pos=)`` feeds a prompt segment at absolute
positions from ``start_pos``, so a prompt fed in segments gives the
states of one whole-prompt call. :func:`window_step` runs ``window``
greedy decode steps with each argmax fed back on the device and returns
the window's tokens as one tensor: the async paging engine uploads a
seed token and position per slot, runs the window, and reads the tokens
back once (the counterpart of the reference's jitted window scan; no
CUDA graph yet).

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


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, states,
            start_pos: int = 0):
    """Feed a prompt through the decode path token by token (the
    reference's implementation, correct for every block kind), token
    ``t`` at position ``start_pos + t``.

    tokens: [B, S]. Returns (last_logits [B, V], states).
    """
    b, s = tokens.shape
    logits = None
    for t in range(s):
        pos = torch.full((b, 1), start_pos + t, dtype=torch.int32,
                         device=tokens.device)
        logits, states = decode_step(params, cfg, tokens[:, t:t + 1], states,
                                     pos)
    return logits[:, 0], states


def window_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                positions: torch.Tensor, states, window: int):
    """``window`` greedy decode steps from seed ``tokens`` [B, 1] at
    ``positions`` [B, 1]: each step's argmax is the next step's token,
    on the device. Returns (generated tokens int32 [B, window], states);
    column t is the token step t produced."""
    gen = []
    tok, pos = tokens, positions
    for _ in range(window):
        lg, states = decode_step(params, cfg, tok, states, pos)
        tok = torch.argmax(lg[:, 0], dim=-1).to(torch.int32)[:, None]
        gen.append(tok)
        pos = pos + 1
    return torch.cat(gen, dim=1), states


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
