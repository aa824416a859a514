"""Model zoo: the uniform bundle interface the trainer sees (port of
``repro/models/zoo.py``), over the ResNets and the LM skeleton. Decode
entry points (``init_cache``, ``decode_step``) come with serving."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Union

import torch

from repro_torch.models import resnet as RN
from repro_torch.models import transformer as TF
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    name: str
    config: Any  # ModelConfig | ResNetConfig
    # torch.Generator -> flat param dict on the CPU; the trainer moves it
    # to its device. (The JAX init draws from jax.random, which torch
    # cannot replay: parity tests hand in bundles whose init returns the
    # reference's params through `checkpoint.io.params_from_jax`.)
    init: Callable[[torch.Generator], Dict[str, torch.Tensor]]
    apply: Callable[..., Dict[str, Any]]  # (params, batch) -> outputs
    loss: Callable[..., Any]  # (params, batch) -> (loss, metrics)

    @property
    def is_lm(self) -> bool:
        return isinstance(self.config, ModelConfig)


def build_bundle(cfg: Union[ModelConfig, RN.ResNetConfig],
                 dtype: torch.dtype = torch.float32) -> ModelBundle:
    if isinstance(cfg, RN.ResNetConfig):
        return _resnet_bundle(cfg, dtype)
    if isinstance(cfg, ModelConfig):
        return _lm_bundle(cfg, dtype)
    raise TypeError(f"no bundle for config {type(cfg).__name__}")


def _resnet_bundle(cfg: RN.ResNetConfig, dtype) -> ModelBundle:
    def init(gen: torch.Generator):
        return RN.init_resnet(gen, cfg, dtype=dtype, device="cpu")

    def apply(params, batch):
        return RN.apply_resnet(params, cfg, batch["images"])

    def loss(params, batch):
        out = apply(params, batch)
        ce = TF.softmax_xent(out["logits"].float(), batch["labels"])
        acc = (out["logits"].argmax(-1) == batch["labels"]).float().mean()
        return ce, {"ce": ce, "acc": acc}

    return ModelBundle(name=cfg.name, config=cfg, init=init, apply=apply,
                       loss=loss)


def _lm_bundle(cfg: ModelConfig, dtype) -> ModelBundle:
    cfg.validate()

    def init(gen: torch.Generator):
        return TF.init_lm(gen, cfg, dtype=dtype, device="cpu")

    def apply(params, batch):
        return TF.apply_lm(params, cfg, batch)

    def loss(params, batch):
        return TF.lm_loss(params, cfg, batch)

    return ModelBundle(name=cfg.name, config=cfg, init=init, apply=apply,
                       loss=loss)
