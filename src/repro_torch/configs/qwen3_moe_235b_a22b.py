"""qwen3-moe-235b-a22b — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B scaled].

[moe] 94L d_model=4096 64H (GQA kv=4) d_ff=1536 vocab=151936, MoE 128e top-8.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        num_layers=94,
        d_model=4096,
        d_ff=1536,
        vocab_size=151936,
        attention=AttentionConfig(num_heads=64, num_kv_heads=4, head_dim=128),
        moe=MoEConfig(num_experts=128, top_k=8, expert_ff=1536),
        tie_embeddings=False,
        citation="hf:Qwen/Qwen3-30B-A3B",
    )
