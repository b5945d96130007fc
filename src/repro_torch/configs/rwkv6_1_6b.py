"""RWKV-6 (Finch) 1.6B: attention-free, data-dependent decay wkv recurrence.

[arXiv:2404.05892] 24L d_model=2048 d_ff=7168 vocab=65536, head_dim=64
(32 wkv heads), O(1) decode state per layer: (H, 64, 64).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    rwkv_head_dim=64,
    source="arXiv:2404.05892",
)
