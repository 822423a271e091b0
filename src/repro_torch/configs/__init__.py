"""Architecture registry: ``--arch <id>`` resolves here.

A copy of ``repro/configs/__init__.py`` and its config files, as data.  The
port's LM (``models/transformer.py``) runs every one of them.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (
    ModelConfig, InputShape, ALL_SHAPES, SHAPES_BY_NAME,
    TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K,
    count_params, count_active_params,
)

# arch id -> config module (LM family; Swin detection is separate, see
# repro_torch.configs.swin_t_detection).
_ARCH_MODULES: Dict[str, str] = {
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "starcoder2-15b": "repro_torch.configs.starcoder2_15b",
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
    "qwen3-4b": "repro_torch.configs.qwen3_4b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def get_reduced_config(arch: str) -> ModelConfig:
    return importlib.import_module(_ARCH_MODULES[arch]).reduced()


__all__ = [
    "ModelConfig", "InputShape", "ALL_SHAPES", "SHAPES_BY_NAME",
    "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
    "ARCH_IDS", "get_config", "get_reduced_config",
    "count_params", "count_active_params",
]
