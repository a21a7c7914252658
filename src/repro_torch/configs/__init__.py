"""Experiment and model configurations of the port.

``p2pl_mnist`` holds the paper's experiments.  The model registry below is
the port's ``repro.configs`` registry: ``get_config(name)`` and
``reduced(cfg)``, and ``for_shape(cfg, shape)`` (the long-context window
variant).  The RWKV6 model, the four dense GQA decoders, the zamba2
hybrid and the two MoE decoders (deepseek-v2-236b with MLA,
qwen3-moe-235b-a22b) are registered; the reference's vlm and
encoder-decoder architectures raise ``NotImplementedError`` (ROADMAP.md
queue 1 item 16b).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    deepseek_v2_236b,
    minitron_8b,
    phi4_mini_3_8b,
    qwen1_5_32b,
    qwen3_moe_235b_a22b,
    rwkv6_7b,
    smollm_135m,
    zamba2_2_7b,
)
from repro_torch.configs.base import (
    INPUT_SHAPES,
    AttentionConfig,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    SSMConfig,
)

ARCHITECTURES = {
    "rwkv6-7b": rwkv6_7b.config,
    "minitron-8b": minitron_8b.config,
    "phi4-mini-3.8b": phi4_mini_3_8b.config,
    "qwen1.5-32b": qwen1_5_32b.config,
    "smollm-135m": smollm_135m.config,
    "zamba2-2.7b": zamba2_2_7b.config,
    "deepseek-v2-236b": deepseek_v2_236b.config,
    "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b.config,
}
# names the reference registers whose families the port does not run yet
UNPORTED_ARCHITECTURES = (
    "internvl2-2b",
    "seamless-m4t-medium",
)

# Sliding-window size for the long_500k variant of attention-bearing archs.
LONG_CTX_WINDOW = 4096
# Families whose long_500k decode is natively sub-quadratic.
NATIVE_LONG_CTX_FAMILIES = ("rwkv6", "hybrid")


def get_config(name: str) -> ModelConfig:
    """The named architecture's full-size config."""
    if name in UNPORTED_ARCHITECTURES:
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet: ROADMAP.md queue 1 item 16b"
        )
    if name not in ARCHITECTURES:
        raise KeyError(f"unknown architecture {name!r}; one of {sorted(ARCHITECTURES)}")
    return ARCHITECTURES[name]()


def for_shape(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """Adapt a config to an input shape (long-context window variant)."""
    if shape.name == "long_500k" and cfg.family not in NATIVE_LONG_CTX_FAMILIES:
        if cfg.attention is not None:
            att = dataclasses.replace(cfg.attention, sliding_window=LONG_CTX_WINDOW)
            cfg = cfg.replace(attention=att)
    return cfg


def reduced(cfg: ModelConfig) -> ModelConfig:
    """CPU-smoke variant of the same family: 2 layers, d_model<=256, <=4 experts."""
    kw: dict = dict(
        num_layers=2,
        d_model=128,
        d_ff=256,
        vocab_size=512,
        remat=False,
        dtype="float32",
    )
    if cfg.attention is not None:
        if cfg.attention.kind == "mla":
            kw["attention"] = dataclasses.replace(
                cfg.attention,
                num_heads=4,
                num_kv_heads=4,
                head_dim=32,
                kv_lora_rank=32,
                q_lora_rank=48,
                qk_nope_dim=32,
                qk_rope_dim=16,
                v_head_dim=32,
            )
        else:
            kw["attention"] = dataclasses.replace(
                cfg.attention, num_heads=4, num_kv_heads=2, head_dim=32
            )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=4,
            top_k=2,
            expert_ff=64,
            num_shared=min(cfg.moe.num_shared, 1),
            first_dense_layers=min(cfg.moe.first_dense_layers, 1),
            dense_ff=128,
            # generous capacity: smoke tests check decode/prefill parity,
            # which capacity dropping would perturb
            capacity_factor=8.0,
        )
        kw["num_layers"] = 2 + kw["moe"].first_dense_layers
    if cfg.ssm is not None:
        if cfg.ssm.kind == "rwkv6":
            kw["ssm"] = dataclasses.replace(cfg.ssm, head_dim=32, lora_rank=8, chunk=4)
        else:
            kw["ssm"] = dataclasses.replace(
                cfg.ssm, state_dim=16, head_dim=32, expand=2, chunk=4
            )
    if cfg.family == "hybrid":
        kw["num_layers"] = 4
        kw["shared_block_period"] = 2
    if cfg.encoder_layers:
        kw["encoder_layers"] = 2
    if cfg.num_prefix_embeddings:
        kw["num_prefix_embeddings"] = 4
        kw["frontend_dim"] = 32
    if cfg.frontend_dim and not cfg.num_prefix_embeddings:
        kw["frontend_dim"] = 32
    return cfg.replace(**kw)


__all__ = [
    "ARCHITECTURES",
    "AttentionConfig",
    "INPUT_SHAPES",
    "LONG_CTX_WINDOW",
    "ModelConfig",
    "MoEConfig",
    "NATIVE_LONG_CTX_FAMILIES",
    "SSMConfig",
    "ShapeConfig",
    "UNPORTED_ARCHITECTURES",
    "for_shape",
    "get_config",
    "reduced",
]
