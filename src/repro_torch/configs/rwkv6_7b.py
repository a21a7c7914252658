"""rwkv6-7b — Finch, data-dependent decay [arXiv:2404.05892].

[ssm] 32L d_model=4096 (attn-free) d_ff=14336 vocab=65536.
Attention-free; long_500k runs natively (O(1) recurrent decode state).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b",
        family="rwkv6",
        num_layers=32,
        d_model=4096,
        d_ff=14336,
        vocab_size=65536,
        ssm=SSMConfig(kind="rwkv6", head_dim=64, lora_rank=64, chunk=16),
        tie_embeddings=False,
        citation="arXiv:2404.05892",
    )
