"""Configuration dataclasses for models, input shapes, and runs (the port's
``repro.configs.base``, copied whole: plain dataclasses, no numpy)."""
from __future__ import annotations

import dataclasses
from typing import Optional

FAMILIES = ("dense", "moe", "rwkv6", "hybrid", "encdec", "vlm")


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    kind: str = "gqa"  # "gqa" | "mla"
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # MLA (DeepSeek-V2) fields
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # long-context variant
    sliding_window: Optional[int] = None  # None = full causal
    # decode-path optimization (MLA only): weight-absorbed latent attention
    mla_absorb: bool = False
    # KV-cache storage: "model" dtype or "int8" (per-slot-per-head absmax
    # quantization; halves decode cache bytes, a §Perf serving feature)
    cache_quant: str = "model"

    @property
    def q_dim(self) -> int:
        if self.kind == "mla":
            return self.num_heads * (self.qk_nope_dim + self.qk_rope_dim)
        return self.num_heads * self.head_dim

    @property
    def o_in_dim(self) -> int:
        if self.kind == "mla":
            return self.num_heads * self.v_head_dim
        return self.num_heads * self.head_dim


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_ff: int
    num_shared: int = 0
    first_dense_layers: int = 0  # leading layers use a dense MLP (DeepSeek-V2)
    dense_ff: int = 0  # d_ff of those dense layers
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    router_groups: int = 1  # token groups for local routing (set to data-axis size at scale)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str  # "mamba2" | "rwkv6"
    state_dim: int = 64  # N (mamba2) / head dim of the WKV state (rwkv6)
    head_dim: int = 64  # P per head
    expand: int = 2  # d_inner = expand * d_model
    conv_dim: int = 4
    chunk: int = 64
    lora_rank: int = 32  # rwkv6 data-dependent decay / token-shift LoRA rank
    ngroups: int = 1  # mamba2 B/C groups


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attention: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): a weight-shared attention block applied every N layers
    shared_block_period: int = 0
    # encoder-decoder (seamless-m4t)
    encoder_layers: int = 0
    # modality stubs: frontends provide precomputed embeddings of this width
    num_prefix_embeddings: int = 0  # VLM image patches / audio frames per sample
    frontend_dim: int = 0  # width of stub embeddings (projected to d_model)
    tie_embeddings: bool = True
    norm_eps: float = 1e-5
    act: str = "silu"
    dtype: str = "bfloat16"
    remat: bool = True
    citation: str = ""

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic total parameter count (used for roofline MODEL_FLOPS)."""
        d, l, v = self.d_model, self.num_layers, self.vocab_size
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        per_layer_attn = 0
        a = self.attention
        if a is not None:
            if a.kind == "mla":
                qd = a.q_lora_rank if a.q_lora_rank else 0
                if a.q_lora_rank:
                    per_layer_attn += d * a.q_lora_rank + a.q_lora_rank * a.q_dim
                else:
                    per_layer_attn += d * a.q_dim
                per_layer_attn += d * (a.kv_lora_rank + a.qk_rope_dim)
                per_layer_attn += a.kv_lora_rank * a.num_heads * (a.qk_nope_dim + a.v_head_dim)
                per_layer_attn += a.num_heads * a.v_head_dim * d
                del qd
            else:
                per_layer_attn += d * a.num_heads * a.head_dim  # q
                per_layer_attn += 2 * d * a.num_kv_heads * a.head_dim  # k, v
                per_layer_attn += a.num_heads * a.head_dim * d  # o
        if self.family == "rwkv6":
            s = self.ssm
            # time-mix: r,k,v,g,w projections + output + loras; channel-mix ~ d*d_ff*2
            per_layer = 5 * d * d + d * d + 6 * s.lora_rank * 2 * d + 2 * d * self.d_ff
            total += l * per_layer
            total += 2 * l * d  # norms
            return int(total)
        per_layer_mlp = 0
        if self.moe is not None:
            m = self.moe
            expert = 3 * d * m.expert_ff
            per_layer_mlp = m.num_experts * expert + m.num_shared * expert + d * m.num_experts
            moe_layers = l - m.first_dense_layers
            total += moe_layers * (per_layer_attn + per_layer_mlp + 2 * d)
            total += m.first_dense_layers * (per_layer_attn + 3 * d * m.dense_ff + 2 * d)
            return int(total)
        if self.family == "hybrid":
            s = self.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            per_mamba = (
                d * (2 * d_in + 2 * s.ngroups * s.state_dim + nheads)
                + (d_in + 2 * s.ngroups * s.state_dim) * s.conv_dim
                + d_in * d
                + 2 * nheads
            )
            total += l * (per_mamba + 2 * d)
            if self.shared_block_period:
                # shared block (+concat proj)
                total += 2 * d * d + per_layer_attn + 3 * d * self.d_ff
            return int(total)
        per_layer_mlp = 3 * d * self.d_ff if self.act != "relu" else 2 * d * self.d_ff
        n_dec = l
        total += n_dec * (per_layer_attn + per_layer_mlp + 2 * d)
        if self.encoder_layers:
            # encoder layer = self-attn + mlp; decoder additionally has cross-attn
            total += self.encoder_layers * (per_layer_attn + per_layer_mlp + 2 * d)
            total += n_dec * (per_layer_attn + d)  # cross attention + norm
        if self.num_prefix_embeddings and self.frontend_dim:
            total += self.frontend_dim * d  # projector
        return int(total)

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        d, l = self.d_model, self.num_layers
        dense_like = self.replace(moe=None, family="dense")
        base = dense_like.param_count() - l * 3 * d * self.d_ff
        expert = 3 * d * m.expert_ff
        moe_layers = l - m.first_dense_layers
        active = base
        active += moe_layers * ((m.top_k + m.num_shared) * expert + d * m.num_experts)
        active += m.first_dense_layers * 3 * d * m.dense_ff
        return int(active)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
