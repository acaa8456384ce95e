"""Config registry: --arch <id> resolution (the reference's ten
architectures, imported from this package)."""
from __future__ import annotations

import importlib

from .base import (
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    TRAIN_4K,
    ModelConfig,
    ShapeConfig,
    shape_applicable,
)

ARCH_IDS = (
    "whisper-large-v3",
    "granite-3-8b",
    "codeqwen1.5-7b",
    "minicpm3-4b",
    "smollm-135m",
    "falcon-mamba-7b",
    "recurrentgemma-2b",
    "deepseek-v2-236b",
    "phi3.5-moe-42b-a6.6b",
    "internvl2-76b",
)

_MODULES = {
    "whisper-large-v3": "whisper_large_v3",
    "granite-3-8b": "granite_3_8b",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "minicpm3-4b": "minicpm3_4b",
    "smollm-135m": "smollm_135m",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "internvl2-76b": "internvl2_76b",
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.smoke() if smoke else mod.full()


__all__ = [
    "ARCH_IDS",
    "get_config",
    "ModelConfig",
    "ShapeConfig",
    "ALL_SHAPES",
    "TRAIN_4K",
    "PREFILL_32K",
    "DECODE_32K",
    "LONG_500K",
    "shape_applicable",
]
