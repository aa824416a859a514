"""Architecture config registry (``repro/configs/__init__.py``), over the
architectures the port runs so far: the paper's ResNets, mamba2-370m,
zamba2-7b, gemma3-12b, arctic-480b and deepseek-v3-671b.

Every entry exposes ``full()`` (the exact configuration) and ``reduced()``
(the CPU-scale variant the parity tests use); ``get_config(name)`` /
``get_reduced(name)`` look them up.
"""
from __future__ import annotations

import importlib

from repro_torch.common.registry import Registry

ARCHS = Registry("architecture")

_MODULES = ["arctic_480b", "deepseek_v3_671b", "gemma3_12b", "mamba2_370m",
            "resnet", "zamba2_7b"]


def _load():
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


_load()


def get_config(name: str):
    return ARCHS.get(name)["full"]()


def get_reduced(name: str):
    return ARCHS.get(name)["reduced"]()


__all__ = ["ARCHS", "get_config", "get_reduced"]
