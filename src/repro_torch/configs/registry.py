"""Architecture config registry of the port: ``get_config("granite-3-8b")``
etc., the reference's eleven configurations under the reference's names."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "paligemma-3b": "repro_torch.configs.paligemma_3b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "yi-9b": "repro_torch.configs.yi_9b",
    "qwen1.5-0.5b": "repro_torch.configs.qwen15_05b",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_27b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_12b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "llama110m": "repro_torch.configs.llama110m",
}

ASSIGNED_ARCHS = [k for k in _MODULES if k != "llama110m"]


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {k: get_config(k) for k in _MODULES}


def available_configs() -> list[str]:
    """Registered architecture names."""
    return list(_MODULES)
