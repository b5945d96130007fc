"""Snowflake Arctic: 128-expert top-2 MoE + parallel dense residual path.

[hf:Snowflake/snowflake-arctic-base] 35L d_model=7168 56H (GQA kv=8)
d_ff=4864 vocab=32000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    head_dim=128,
    n_experts=128,
    top_k=2,
    dense_residual=True,
    source="hf:Snowflake/snowflake-arctic-base",
)
