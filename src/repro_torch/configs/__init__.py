"""Config registry: one module per assigned architecture (+ the paper's
own Gemma-2B SFT setting). ``get_config(arch)`` is the ``--arch`` entry
point; ``reduced(cfg)`` builds the small same-family smoke variant."""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import (  # noqa: F401
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    ModelConfig,
    MoEConfig,
    PREFILL_32K,
    ShapeConfig,
    TRAIN_4K,
)

from repro_torch.configs import (
    chatglm3_6b,
    deepseek_coder_33b,
    deepseek_moe_16b,
    gemma_2b_sft,
    jamba_1_5_large_398b,
    mixtral_8x22b,
    musicgen_medium,
    nemotron_4_340b,
    phi3_mini_3_8b,
    phi3_vision_4_2b,
    xlstm_125m,
)

_MODULES = (
    deepseek_coder_33b, chatglm3_6b, nemotron_4_340b, phi3_mini_3_8b,
    phi3_vision_4_2b, musicgen_medium, jamba_1_5_large_398b,
    deepseek_moe_16b, mixtral_8x22b, xlstm_125m, gemma_2b_sft,
)

REGISTRY: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG
                                    for m in _MODULES}

#: The ten assigned architectures (gemma-2b-sft is the paper's own,
#: used by examples/benchmarks, not part of the 40-cell sweep).
ASSIGNED = tuple(n for n in REGISTRY if n != "gemma-2b-sft")


def get_config(arch: str) -> ModelConfig:
    if arch not in REGISTRY:
        raise KeyError(
            f"unknown arch {arch!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[arch]


def shapes_for(cfg: ModelConfig) -> tuple:
    """The assigned shape cells this arch runs (long_500k only for
    sub-quadratic archs, per the assignment brief)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.supports_long_context:
        out.append(LONG_500K)
    return tuple(out)


def skipped_shapes_for(cfg: ModelConfig) -> tuple:
    return () if cfg.supports_long_context else (LONG_500K,)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Small same-family config for CPU smoke tests: same block kinds,
    activation, routing structure; tiny widths/depth/vocab."""
    period = cfg.layer_period
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=max(period, 2 if period == 1 else period),
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2))
        if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=256,
        max_seq_len=512,
        frontend_prefix_len=8 if cfg.frontend else 0,
        attn_q_block=16,
        attn_kv_block=32,
        remat="none",
    )
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(
            num_experts=4, top_k=2, d_expert=32,
            num_shared_experts=min(cfg.moe.num_shared_experts, 1))
    kw.update(overrides)
    return dataclasses.replace(cfg, **kw)
