"""Architecture config registry of the port: ``get_config("llama110m")``.

Registered: the dense ``llama110m`` (the main path) and the SSM
``mamba2-2.7b``; the other nine configurations of the reference arrive with
their model families.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "llama110m": "repro_torch.configs.llama110m",
    "mamba2-2.7b": "repro_torch.configs.mamba2_27b",
}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG


def available_configs() -> list[str]:
    """Registered architecture names."""
    return list(_MODULES)
