"""qwen1.5-32b — QKV bias [hf:Qwen/Qwen1.5-0.5B scaled per assignment].

[dense] 64L d_model=5120 40H (GQA kv=40) d_ff=27392 vocab=152064.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b",
        family="dense",
        num_layers=64,
        d_model=5120,
        d_ff=27392,
        vocab_size=152064,
        attention=AttentionConfig(num_heads=40, num_kv_heads=40, head_dim=128, qkv_bias=True),
        tie_embeddings=False,
        citation="hf:Qwen/Qwen1.5-0.5B",
    )
