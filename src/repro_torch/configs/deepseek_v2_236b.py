"""deepseek-v2-236b — MLA kv_lora=512, 2 shared + 160 routed top-6 [arXiv:2405.04434].

[moe] 60L d_model=5120 128H (GQA kv=128) d_ff=1536 vocab=102400, MoE 160e top-6.
MLA: kv_lora_rank=512, q_lora_rank=1536, qk_nope=128, qk_rope=64, v_head=128.
Layer 0 uses a dense MLP (d_ff 12288), layers 1..59 are MoE — per the model card.
Decode caches the latent (c_kv, k_rope); `mla_absorb=True` is the §Perf variant.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        num_layers=60,
        d_model=5120,
        d_ff=12288,  # dense-equivalent width (layer 0); experts use expert_ff
        vocab_size=102400,
        attention=AttentionConfig(
            num_heads=128,
            num_kv_heads=128,
            head_dim=128,
            kind="mla",
            kv_lora_rank=512,
            q_lora_rank=1536,
            qk_nope_dim=128,
            qk_rope_dim=64,
            v_head_dim=128,
        ),
        moe=MoEConfig(
            num_experts=160,
            top_k=6,
            expert_ff=1536,
            num_shared=2,
            first_dense_layers=1,
            dense_ff=12288,
        ),
        tie_embeddings=False,
        citation="arXiv:2405.04434",
    )
