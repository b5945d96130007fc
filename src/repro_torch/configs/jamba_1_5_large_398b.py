"""Jamba-1.5-Large: hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887] 72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536.
MoE on every other layer (16 experts, top-2); one attention layer per 8.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    n_experts=16,
    top_k=2,
    moe_every=2,
    attn_every=8,
    mamba_d_state=16,
    mamba_expand=2,
    source="arXiv:2403.19887",
)
