"""Llama-3.2-Vision-90B language backbone: cross-attn image layers every 5th.

[hf:meta-llama/Llama-3.2-11B-Vision] 100L d_model=8192 64H (GQA kv=8)
d_ff=28672 vocab=128256. Vision tower (ViT) is a STUB: input_specs provides
projected patch embeddings (B, 1024, 8192).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    cross_attn_every=5,
    n_image_tokens=1024,
    rope_theta=5e5,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
