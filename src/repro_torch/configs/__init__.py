"""Copy of ``repro/configs`` for the PyTorch port: this package and its
modules are identical apart from imports.

Architecture registry: one module per assigned architecture.

``get(arch_id)`` returns the exact assigned config; ``get_smoke(arch_id)``
returns the reduced same-family config used by CPU smoke tests.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = [
    "zamba2-1.2b",
    "llama-3.2-vision-90b",
    "mamba2-2.7b",
    "qwen3-moe-235b-a22b",
    "deepseek-v2-lite-16b",
    "h2o-danube-3-4b",
    "minicpm-2b",
    "internlm2-1.8b",
    "llama3-8b",
    "whisper-small",
]

_MOD = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MOD[arch_id]}")
    return mod.CONFIG


def get_smoke(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MOD[arch_id]}")
    return mod.smoke_config()


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get(a) for a in ARCH_IDS}
