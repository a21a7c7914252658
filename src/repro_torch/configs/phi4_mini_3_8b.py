"""phi4-mini-3.8b — RoPE SwiGLU GQA [arXiv:2412.08905].

[dense] 32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-3.8b",
        family="dense",
        num_layers=32,
        d_model=3072,
        d_ff=8192,
        vocab_size=200064,
        attention=AttentionConfig(num_heads=24, num_kv_heads=8, head_dim=128),
        tie_embeddings=True,
        citation="arXiv:2412.08905",
    )
