"""Config registry: ``get_config("<arch-id>")`` and input shapes, as in
the reference. The ICU LSTM classifiers live in `configs/icu_lstm.py`."""
from repro_torch.configs.base import INPUT_SHAPES, ModelConfig, ShapeConfig  # noqa: F401

_ARCH_MODULES = {
    "xlstm-350m": "xlstm_350m",
    "gemma2-27b": "gemma2_27b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "zamba2-2.7b": "zamba2_2_7b",
    "mixtral-8x7b": "mixtral_8x7b",
    "mixtral-8x22b": "mixtral_8x22b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "qwen2-1.5b": "qwen2_1_5b",
    "mistral-large-123b": "mistral_large_123b",
    "gemma-2b": "gemma_2b",
}

ARCH_NAMES = tuple(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_NAMES}")
    import importlib
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return INPUT_SHAPES[name]


def all_configs():
    return {n: get_config(n) for n in ARCH_NAMES}
