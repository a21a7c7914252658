"""internvl2-2b — InternViT + InternLM2 [arXiv:2404.16821].

[vlm] 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.
The InternViT vision encoder is a stub, as in the reference: the registry's
``make_batch`` draws 256 precomputed patch embeddings (width 1024) per
sample, projected to d_model and spliced as a prefix to the text tokens
(text len = seq_len - 256).
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b",
        family="vlm",
        num_layers=24,
        d_model=2048,
        d_ff=8192,
        vocab_size=92553,
        attention=AttentionConfig(num_heads=16, num_kv_heads=8, head_dim=128),
        num_prefix_embeddings=256,
        frontend_dim=1024,
        tie_embeddings=False,
        citation="arXiv:2404.16821",
    )
