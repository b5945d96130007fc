"""Architecture configs, copied from the JAX package's ``configs/``. One
module per assigned architecture.

Each module exposes ``CONFIG`` (a ``ModelConfig``) and the registry maps
``--arch <id>`` to it. ``reduced()`` returns a CPU-smoke-testable variant.
"""
from repro_torch.configs.base import ModelConfig, ShapeConfig, SHAPES, reduced

_ARCH_MODULES = {
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
    "codeqwen1.5-7b": "repro_torch.configs.codeqwen1_5_7b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "qwen2.5-32b": "repro_torch.configs.qwen2_5_32b",
    "whisper-base": "repro_torch.configs.whisper_base",
    "qwen3-0.6b": "repro_torch.configs.qwen3_0_6b",
    "llama-3.2-vision-90b": "repro_torch.configs.llama_3_2_vision_90b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
    "dynabro-mlp": "repro_torch.configs.dynabro_mlp",
}

ARCH_IDS = [a for a in _ARCH_MODULES if a != "dynabro-mlp"]


def get_config(arch_id: str) -> ModelConfig:
    import importlib

    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch_id]).CONFIG


def get_reduced_config(arch_id: str, **kw) -> ModelConfig:
    """``reduced(get_config(arch_id), **kw)`` — the model-zoo entry point
    (``models.zoo.make_zoo_task``) and the one-stop smoke-test config."""
    return reduced(get_config(arch_id), **kw)


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "ARCH_IDS", "get_config",
           "get_reduced_config", "reduced"]
