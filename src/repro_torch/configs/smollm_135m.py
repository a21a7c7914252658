"""smollm-135m — llama-arch small [hf:HuggingFaceTB/SmolLM-135M].

[dense] 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
The arch small enough to train for real on this CPU container.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m",
        family="dense",
        num_layers=30,
        d_model=576,
        d_ff=1536,
        vocab_size=49152,
        attention=AttentionConfig(num_heads=9, num_kv_heads=3, head_dim=64),
        tie_embeddings=True,
        citation="hf:HuggingFaceTB/SmolLM-135M",
    )
