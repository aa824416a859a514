"""Model zoo: the uniform bundle interface the trainer and the server see
(port of ``repro/models/zoo.py``), over the ResNets and the LM skeleton.
An LM bundle also decodes: ``init_cache`` and ``decode_step``."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Union

import torch

from repro_torch.models import resnet as RN
from repro_torch.models import transformer as TF
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    name: str
    config: Any  # ModelConfig | ResNetConfig
    # torch.Generator -> flat param dict on the CPU (an LM's on the
    # generator's device: a CUDA generator draws it on the card); the
    # trainer moves it to its device. (The JAX init draws from jax.random,
    # which torch cannot replay: parity tests hand in bundles whose init
    # returns the reference's params through
    # `checkpoint.io.params_from_jax`.)
    init: Callable[[torch.Generator], Dict[str, torch.Tensor]]
    # (params, batch) -> outputs; an LM's batch carries "vision_embeds" or
    # "audio_frames" beside "tokens" where its config has a front end, and
    # its apply also takes mtp=False, which leaves out DeepSeek's MTP
    # branch (`lm_mhd_outputs`)
    apply: Callable[..., Dict[str, Any]]
    loss: Callable[..., Any]  # (params, batch) -> (loss, metrics)
    # (batch, cache_len, cache_dtype=bfloat16, device=None) -> caches
    init_cache: Optional[Callable[..., Any]] = None
    # (params, token (B, 1), caches) -> (logits (B, 1, V), caches)
    decode_step: Optional[Callable[..., Any]] = None

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
        return TF.init_lm(gen, cfg, dtype=dtype, device=gen.device)

    def apply(params, batch, mtp: bool = True):
        return TF.apply_lm(params, cfg, batch, mtp=mtp)

    def loss(params, batch):
        return TF.lm_loss(params, cfg, batch)

    def init_cache(batch, cache_len, cache_dtype=torch.bfloat16,
                   device=None):
        return TF.init_lm_cache(cfg, batch, cache_len, cache_dtype, device)

    def decode_step(params, token, caches):
        return TF.decode_step(params, cfg, token, caches)

    return ModelBundle(name=cfg.name, config=cfg, init=init, apply=apply,
                       loss=loss, init_cache=init_cache,
                       decode_step=decode_step)
