"""--arch registry: the 10 assigned architectures, as the reference's
``repro.configs`` has them (the same data; this package's ``ModelConfig``)."""
import importlib

from .base import (ModelConfig, ShapeConfig, ALL_SHAPES, SHAPES_BY_NAME,
                   TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K, supports_shape)

_ARCH_MODULES = {
    "recurrentgemma-2b": "recurrentgemma_2b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "gemma3-1b": "gemma3_1b",
    "qwen3-32b": "qwen3_32b",
    "qwen1.5-110b": "qwen15_110b",
    "olmo-1b": "olmo_1b",
    "rwkv6-7b": "rwkv6_7b",
}

ARCH_NAMES = tuple(_ARCH_MODULES)


def _mod(name: str):
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; have {ARCH_NAMES}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _mod(name).config()


def get_smoke_config(name: str) -> ModelConfig:
    return _mod(name).smoke_config()
