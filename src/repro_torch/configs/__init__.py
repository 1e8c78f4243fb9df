"""Config registry: ``--arch <id>`` resolution for every assigned
architecture (+ the paper's own SpMV matrix suite via
repro_torch.sparse.generate) and the workload-shape set (``shapes.py``).
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.configs.shapes import SHAPE_NAMES, SHAPES, WorkloadShape, applicable, cells_for

# arch id -> module name
_ARCH_MODULES = {
    "deepseek-moe-16b": "deepseek_moe_16b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "llama3-8b": "llama3_8b",
    "qwen3-0.6b": "qwen3_0_6b",
    "stablelm-12b": "stablelm_12b",
    "xlstm-1.3b": "xlstm_1_3b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "musicgen-large": "musicgen_large",
    "paligemma-3b": "paligemma_3b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str, *, reduced_config: bool = False) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.REDUCED if reduced_config else mod.CONFIG


def all_configs(*, reduced_config: bool = False) -> dict[str, ModelConfig]:
    return {a: get_config(a, reduced_config=reduced_config) for a in ARCH_IDS}


__all__ = [
    "ModelConfig",
    "reduced",
    "WorkloadShape",
    "SHAPES",
    "SHAPE_NAMES",
    "applicable",
    "cells_for",
    "ARCH_IDS",
    "get_config",
    "all_configs",
]
