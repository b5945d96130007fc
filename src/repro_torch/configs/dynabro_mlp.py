"""The paper's own experiment scale: small classifier used by the
reproduction benchmarks (MNIST/CIFAR-class CNN stand-in as an MLP backbone).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="dynabro-mlp",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=512,
    vocab_size=64,
    head_dim=32,
    source="Dorfman et al. 2024, Section 6",
)
