"""minitron-8b — pruned Nemotron [arXiv:2407.14679].

[dense] 32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
long_500k uses the sliding-window variant (window 4096): ``configs.for_shape``.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b",
        family="dense",
        num_layers=32,
        d_model=4096,
        d_ff=16384,
        vocab_size=256000,
        attention=AttentionConfig(num_heads=32, num_kv_heads=8, head_dim=128),
        tie_embeddings=False,
        citation="arXiv:2407.14679",
    )
