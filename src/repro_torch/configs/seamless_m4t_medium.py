"""seamless-m4t-medium — enc-dec, multimodal [arXiv:2308.11596].

[audio] 12L d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=256206.
Backbone only: 12 encoder + 12 decoder layers; the mel-spectrogram + conv
feature extractor is a stub, as in the reference: the registry's
``make_batch`` draws precomputed frame embeddings (width 512).  Shape convention: for a
seq_len-S input shape, enc_len = S//4 frames and dec_len = S - S//4 tokens.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium",
        family="encdec",
        num_layers=12,
        encoder_layers=12,
        d_model=1024,
        d_ff=4096,
        vocab_size=256206,
        attention=AttentionConfig(num_heads=16, num_kv_heads=16, head_dim=64),
        frontend_dim=512,
        tie_embeddings=True,
        citation="arXiv:2308.11596",
    )
