"""Optimizers written out by hand (port of ``repro/optim/optimizers.py``).

``torch.optim`` differs from the reference in the details that decide a
trajectory (dampening, where weight decay enters, AdamW's decay and bias
correction), so the updates are spelled out here. An ``Optimizer`` is the
reference's pair of pure functions over flat param dicts:

    init(params) -> state
    update(grads, state, params, step) -> (new_params, new_state)

``update`` returns new tensors and never writes into ``params``: the legacy
params exchange keeps references to old parameter dicts in the teacher
pools, as the JAX package keeps its immutable arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Params, int], Tuple[Params, Any]]


def global_norm(grads: Params) -> torch.Tensor:
    """f32 global L2 norm over every leaf, summed in key order."""
    return torch.sqrt(torch.stack(
        [g.float().square().sum() for g in grads.values()]).sum())


def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> Tuple[Params, torch.Tensor]:
    """``g · min(1, max_norm / (norm + 1e-9))`` — computed on the device,
    no host sync."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, \
        norm


def sgd_momentum(schedule: Callable, momentum: float = 0.9,
                 nesterov: bool = False, weight_decay: float = 0.0,
                 grad_clip_norm: Optional[float] = None,
                 state_dtype: torch.dtype = torch.float32) -> Optimizer:
    """Heavy-ball momentum without dampening; weight decay is added to the
    gradient (the paper's optimizer)."""

    def init(params):
        return {"momentum": {k: torch.zeros_like(p, dtype=state_dtype)
                             for k, p in params.items()}}

    def update(grads, state, params, step):
        lr = schedule(step)
        if grad_clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, grad_clip_norm)
        new_p, new_m = {}, {}
        for k, p in params.items():
            g = grads[k].float()
            if weight_decay:
                g = g + weight_decay * p.float()
            m = momentum * state["momentum"][k].float() + g
            d = g + momentum * m if nesterov else m
            new_p[k] = (p.float() - lr * d).to(p.dtype)
            new_m[k] = m.to(state_dtype)
        return new_p, {"momentum": new_m}

    return Optimizer(init=init, update=update)


def adamw(schedule: Callable, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          grad_clip_norm: Optional[float] = 1.0,
          state_dtype: torch.dtype = torch.float32) -> Optimizer:
    """AdamW with t = step + 1; the decoupled decay is added to the update
    before the lr multiply."""

    def init(params):
        return {"m": {k: torch.zeros_like(p, dtype=state_dtype)
                      for k, p in params.items()},
                "v": {k: torch.zeros_like(p, dtype=state_dtype)
                      for k, p in params.items()}}

    def update(grads, state, params, step):
        lr = schedule(step)
        if grad_clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, grad_clip_norm)
        t = np.float32(step) + np.float32(1.0)
        bc1 = float(np.float32(1.0) - np.power(np.float32(b1), t))
        bc2 = float(np.float32(1.0) - np.power(np.float32(b2), t))
        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            g = grads[k].float()
            m = b1 * state["m"][k].float() + (1 - b1) * g
            v = b2 * state["v"][k].float() + (1 - b2) * g.square()
            d = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                d = d + weight_decay * p.float()
            new_p[k] = (p.float() - lr * d).to(p.dtype)
            new_m[k] = m.to(state_dtype)
            new_v[k] = v.to(state_dtype)
        return new_p, {"m": new_m, "v": new_v}

    return Optimizer(init=init, update=update)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "sgd_momentum"  # or "adamw"
    init_lr: float = 0.1
    total_steps: int = 60_000
    warmup_steps: int = 0
    momentum: float = 0.9
    weight_decay: float = 0.0
    grad_clip_norm: Optional[float] = None
    state_dtype: str = "float32"


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    from repro_torch.optim.schedules import warmup_cosine_schedule

    schedule = warmup_cosine_schedule(cfg.init_lr, cfg.total_steps,
                                      cfg.warmup_steps)
    state_dtype = getattr(torch, cfg.state_dtype)
    if cfg.name == "sgd_momentum":
        return sgd_momentum(schedule, momentum=cfg.momentum,
                            weight_decay=cfg.weight_decay,
                            grad_clip_norm=cfg.grad_clip_norm,
                            state_dtype=state_dtype)
    if cfg.name == "adamw":
        return adamw(schedule, weight_decay=cfg.weight_decay,
                     grad_clip_norm=cfg.grad_clip_norm,
                     state_dtype=state_dtype)
    raise ValueError(f"unknown optimizer {cfg.name!r}")
