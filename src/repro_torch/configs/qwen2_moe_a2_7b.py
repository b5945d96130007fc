"""Qwen1.5/2-MoE-A2.7B: 60 routed experts top-4 + 4 shared experts.

[hf:Qwen/Qwen1.5-MoE-A2.7B] 24L d_model=2048 16H (kv=16) expert d_ff=1408
vocab=151936; shared-expert intermediate = 4*1408 = 5632.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    qkv_bias=True,
    n_experts=60,
    top_k=4,
    n_shared_experts=4,
    shared_d_ff=5632,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
