"""Model / runtime configuration dataclasses."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                 # hidden width of each routed expert
    num_shared_experts: int = 0   # deepseek-moe fine-grained shared experts
    capacity_factor: float = 1.25
    router_noise: float = 0.0
    impl: str = "gspmd"           # "gspmd" | "grouped_local" | "shardmap_a2a"
    dispatch_groups: int = 32     # grouped_local: dispatch groups
    #   (= dp shard count so token->expert-buffer scatters stay
    #   shard-local instead of lowering to giant all-reduces)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    activation: str = "swiglu"    # swiglu | gelu | squared_relu
    rope_fraction: float = 1.0    # chatglm3 applies rope to half the dims
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None   # mixtral SWA
    moe: Optional[MoEConfig] = None
    moe_every: int = 1            # jamba: MoE on every 2nd layer
    attn_every: Optional[int] = None       # jamba: 1 attention per 8 layers
    ssm_type: Optional[str] = None         # mamba | xlstm
    ssm_state_dim: int = 16
    conv_kernel: int = 4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    frontend: Optional[str] = None         # vision_stub | audio_stub
    frontend_prefix_len: int = 0           # patches/frames prepended
    max_seq_len: int = 524288
    # runtime
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "full"           # none | full | dots
    use_scan: bool = True
    attn_q_block: int = 512
    attn_kv_block: int = 1024
    attn_impl: str = "blocked"    # blocked (flash-style) | dense
    attn_score_dtype: str = "float32"   # bfloat16 halves score traffic
    pad_heads_multiple: Optional[int] = None  # pad Q heads so they
    #   shard over the model axis (frozen zero pad slices — function
    #   is exactly the unpadded arch; see models/attention.py)
    causal_skip: bool = False     # skip fully-masked KV blocks (perf opt)
    serve_params_tp_only: bool = False  # serving: no FSDP weight gathers

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def layer_period(self) -> int:
        """Heterogeneous stacks scan over groups of this many layers."""
        if self.family == "hybrid" and self.attn_every:
            return self.attn_every
        if self.ssm_type == "xlstm":
            return 2   # alternating sLSTM / mLSTM
        return 1

    def ffn_kind(self, idx_in_group: int) -> str:
        """FFN flavor for a layer: "moe" | "dense" | "none"."""
        kinds = self.layer_kinds()
        if self.d_ff == 0 or kinds[idx_in_group] not in ("attention",
                                                         "mamba"):
            return "none"
        if self.moe is not None and (
                idx_in_group % self.moe_every == self.moe_every - 1):
            return "moe"
        return "dense"

    def layer_kinds(self) -> Tuple[str, ...]:
        """Block kind for each layer within one period group."""
        if self.family == "hybrid" and self.attn_every:
            # jamba: 1 attention layer per `attn_every`, rest mamba.
            return tuple(
                "attention" if i == 0 else "mamba"
                for i in range(self.attn_every))
        if self.ssm_type == "xlstm":
            return ("slstm", "mlstm")
        if self.ssm_type == "mamba":
            return ("mamba",)
        return ("attention",)

    @property
    def is_attention_free(self) -> bool:
        return all(k not in ("attention",) for k in self.layer_kinds())

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic archs (ssm/hybrid) run the long_500k shape."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND roofline accounting)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        h, kv, hd = self.num_heads, self.num_kv_heads, self.resolved_head_dim
        kinds_per_group = self.layer_kinds()
        n_groups = self.num_layers // len(kinds_per_group)
        total = v * d                      # embedding
        if not self.tie_embeddings:
            total += v * d                 # lm head
        per_group = 0
        for li, kind in enumerate(kinds_per_group):
            per_group += 2 * d             # two rmsnorm scales
            if kind == "attention":
                per_group += d * h * hd + 2 * d * kv * hd + h * hd * d
                per_group += self._ffn_params(li)
            elif kind == "mamba":
                di = 2 * d
                dt_rank = max(1, d // 16)
                per_group += (d * 2 * di + di * self.conv_kernel
                              + di * (dt_rank + 2 * self.ssm_state_dim)
                              + dt_rank * di + di * self.ssm_state_dim
                              + di + di * d)
                per_group += self._ffn_params(li)
            elif kind in ("slstm", "mlstm"):
                # qkv + gates + out
                per_group += 3 * d * h * hd + 4 * d * h + h * hd * d
            else:
                raise ValueError(kind)
        total += n_groups * per_group
        total += d                         # final norm
        return total

    def _ffn_params(self, idx_in_group: int = 0) -> int:
        d, ff = self.d_model, self.d_ff
        if ff == 0:
            return 0
        if self.ffn_kind(idx_in_group) == "moe":
            m = self.moe
            e_params = (m.num_experts *
                        self._mlp_params(d, m.d_expert))
            shared = (self._mlp_params(d, m.num_shared_experts * m.d_expert)
                      if m.num_shared_experts else 0)
            router = d * m.num_experts
            return e_params + shared + router
        return self._mlp_params(d, ff)

    def _mlp_params(self, d: int, ff: int) -> int:
        if ff == 0:
            return 0
        gated = self.activation in ("swiglu",)
        return (3 if gated else 2) * d * ff

    def active_param_count(self) -> int:
        """Active params per token (MoE top-k) for 6·N_active·D."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        # Only top_k of the routed experts are active per token, on the
        # layers that carry the MoE.
        kinds = self.layer_kinds()
        n_moe_layers = (self.num_layers // len(kinds)) * sum(
            1 for li in range(len(kinds)) if self.ffn_kind(li) == "moe")
        inactive = ((m.num_experts - m.top_k) *
                    self._mlp_params(self.d_model, m.d_expert))
        return self.param_count() - n_moe_layers * inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
