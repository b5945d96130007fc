"""Whisper-base: encoder-decoder; mel+conv frontend is a STUB (frame embeddings
are provided directly by input_specs, shape (B, 1500, 512)).

[arXiv:2212.04356] 6L enc + 6L dec, d_model=512 8H d_ff=2048 vocab=51865,
LayerNorm + GELU, learned positions (no RoPE at runtime here).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-base",
    family="audio",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    norm="layernorm",
    act="gelu",
    n_encoder_layers=6,
    encoder_seq=1500,
    source="arXiv:2212.04356",
)
