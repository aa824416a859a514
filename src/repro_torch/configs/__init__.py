"""Architecture config registry (``repro/configs/__init__.py``): the
paper's ResNets and every assigned LM architecture, each config a copy of
the reference's.

Every entry exposes ``full()`` (the exact configuration) and ``reduced()``
(the CPU-scale variant the parity tests use); ``get_config(name)`` /
``get_reduced(name)`` look them up, and ``arch_ids()`` lists the LM
architectures in the reference's order (``--arch`` of `launch/train.py`).
"""
from __future__ import annotations

import importlib

from repro_torch.common.registry import Registry

ARCHS = Registry("architecture")

_MODULES = [
    "gemma3_27b",
    "gemma3_12b",
    "llama_3_2_vision_90b",
    "qwen2_5_32b",
    "mamba2_370m",
    "minitron_4b",
    "whisper_large_v3",
    "deepseek_v3_671b",
    "zamba2_7b",
    "arctic_480b",
    "resnet",
]

ARCH_IDS = [
    "gemma3-27b",
    "gemma3-12b",
    "llama-3.2-vision-90b",
    "qwen2.5-32b",
    "mamba2-370m",
    "minitron-4b",
    "whisper-large-v3",
    "deepseek-v3-671b",
    "zamba2-7b",
    "arctic-480b",
]


def _load():
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


_load()


def get_config(name: str):
    return ARCHS.get(name)["full"]()


def get_reduced(name: str):
    return ARCHS.get(name)["reduced"]()


def arch_ids():
    return list(ARCH_IDS)


__all__ = ["ARCHS", "ARCH_IDS", "arch_ids", "get_config", "get_reduced"]
