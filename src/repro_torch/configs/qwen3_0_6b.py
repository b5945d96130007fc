"""Qwen3-0.6B: dense GQA with qk-norm and explicit head_dim=128.

[hf:Qwen/Qwen3 family] 28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=3072,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
    source="hf:Qwen/Qwen3-8B",
)
