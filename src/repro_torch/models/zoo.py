"""Model zoo: the uniform bundle interface the trainer sees (ResNet half of
``repro/models/zoo.py``; the LM half is a later slice of the port)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.models import resnet as RN


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    name: str
    config: Any  # ResNetConfig
    # torch.Generator -> flat param dict on the CPU; the trainer moves it
    # to its device. (The JAX init draws from jax.random, which torch
    # cannot replay: parity tests hand in bundles whose init returns the
    # reference's params through `checkpoint.io.params_from_jax`.)
    init: Callable[[torch.Generator], Dict[str, torch.Tensor]]
    apply: Callable[..., Dict[str, Any]]  # (params, batch) -> outputs


def build_bundle(cfg: RN.ResNetConfig,
                 dtype: torch.dtype = torch.float32) -> ModelBundle:
    if not isinstance(cfg, RN.ResNetConfig):
        raise NotImplementedError(
            "the port has the ResNet family only; LM bundles are a later "
            "slice")

    def init(gen: torch.Generator):
        return RN.init_resnet(gen, cfg, dtype=dtype, device="cpu")

    def apply(params, batch):
        return RN.apply_resnet(params, cfg, batch["images"])

    return ModelBundle(name=cfg.name, config=cfg, init=init, apply=apply)
