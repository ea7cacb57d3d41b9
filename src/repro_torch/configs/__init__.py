"""Config registry of the port: the four dense architectures, the ssm one and
the hybrid one.

``get_config(name)`` returns the full published config; ``get_smoke(name)``
the reduced same-family config the CPU tests use. The other architectures
of ``repro.configs`` belong to families this package does not run yet; asking
for one raises ``NotImplementedError`` naming the ROADMAP item that ports it.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

ARCH_IDS: List[str] = [
    "chatglm3-6b",
    "qwen2-72b",
    "qwen1.5-32b",
    "nemotron-4-15b",
    "falcon-mamba-7b",
    "hymba-1.5b",
]

_MODULES = {
    "chatglm3-6b": "chatglm3_6b",
    "qwen2-72b": "qwen2_72b",
    "qwen1.5-32b": "qwen1_5_32b",
    "nemotron-4-15b": "nemotron_4_15b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "hymba-1.5b": "hymba_1_5b",
}

# architectures of the reference package that wait for a later slice
_NOT_YET: Dict[str, str] = {
    "granite-moe-3b-a800m": "moe family: ROADMAP Queue 1 M10",
    "deepseek-v2-236b": "moe/MLA family: ROADMAP Queue 1 M10",
    "musicgen-large": "audio family: ROADMAP Queue 1 M12",
    "internvl2-76b": "vlm family: ROADMAP Queue 1 M12",
}


def _module(name: str):
    if name in _NOT_YET:
        raise NotImplementedError(
            f"{name!r} is not ported to repro_torch yet ({_NOT_YET[name]})")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE


__all__ = ["ModelConfig", "ARCH_IDS", "get_config", "get_smoke"]
