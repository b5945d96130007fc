"""SmolLM-360M: small llama-arch dense GQA model.

[hf:HuggingFaceTB/SmolLM-135M family] 32L d_model=960 15H (GQA kv=5)
d_ff=2560 vocab=49152, head_dim=64.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    head_dim=64,
    rope_theta=1e4,
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M",
)
