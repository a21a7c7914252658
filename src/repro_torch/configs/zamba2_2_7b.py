"""zamba2-2.7b — Mamba2 + shared attention blocks [arXiv:2411.15242].

[hybrid] 54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64.
54 Mamba2 layers; a single weight-shared attention+MLP block is applied every
6 layers (9 applications), consuming concat(x, embedding) per the Zamba design.
long_500k runs natively (SSM state decode; the shared block keeps a KV cache).
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        num_layers=54,
        d_model=2560,
        d_ff=10240,
        vocab_size=32000,
        attention=AttentionConfig(num_heads=32, num_kv_heads=32, head_dim=80),
        ssm=SSMConfig(kind="mamba2", state_dim=64, head_dim=64, expand=2, chunk=64),
        shared_block_period=6,
        tie_embeddings=True,
        citation="arXiv:2411.15242",
    )
