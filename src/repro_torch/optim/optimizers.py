"""Optimizers written out by hand (port of ``repro/optim/optimizers.py``).

``torch.optim`` differs from the reference in the details that decide a
trajectory (dampening, where weight decay enters, AdamW's decay and bias
correction), so the updates are spelled out here. An ``Optimizer`` is the
reference's pair of pure functions over flat param dicts:

    init(params) -> state
    update(grads, state, params, step) -> (new_params, new_state)

``update`` returns new tensors and never writes into ``params``: the legacy
params exchange keeps references to old parameter dicts in the teacher
pools, as the JAX package keeps its immutable arrays. It consumes ``grads``
and ``state``: it takes each leaf out of their dicts as it makes the new
one, so a step holds the old and the new state of one leaf at a time, not
of the whole model (the caller keeps what ``update`` returns): for a
full-width arctic-480b client under AdamW, 11.6 GiB of old moments and
5.8 GiB of clipped gradients that are not held at once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.common import sharding as SH

Params = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Params, int], Tuple[Params, Any]]


def global_norm(grads: Params) -> torch.Tensor:
    """f32 global L2 norm over every leaf, summed in key order. Under an
    active mesh of more than one rank (`common.sharding.use_mesh`, as the
    sharded steps and the pod step run their update) ``grads`` are this
    rank's blocks, and the norm is the whole gradient's: every distinct
    entry the mesh's ranks hold, counted once
    (`common.sharding.global_sum_of_squares`)."""
    part = SH.active_partition()
    if part is not None and math.prod(part.sizes.values()) > 1:
        return torch.sqrt(SH.global_sum_of_squares(grads, part))
    return torch.sqrt(torch.stack(
        [g.float().square().sum() for g in grads.values()]).sum())


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def _clipped(g: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    return g if scale is None else (g.float() * scale).to(g.dtype)


def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> Tuple[Params, torch.Tensor]:
    """``g · min(1, max_norm / (norm + 1e-9))`` — computed on the device,
    no host sync."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {k: _clipped(g, scale) for k, g in grads.items()}, norm


def _grad_scale(grads: Params, max_norm: Optional[float]
                ) -> Optional[torch.Tensor]:
    """The factor `clip_by_global_norm` multiplies every leaf by (None:
    no clipping), applied a leaf at a time by the updates."""
    return None if max_norm is None else _clip_scale(global_norm(grads),
                                                     max_norm)


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
        scale = _grad_scale(grads, grad_clip_norm)
        new_p, new_m = {}, {}
        for k, p in params.items():
            g = _clipped(grads.pop(k), scale).float()
            if weight_decay:
                g = g + weight_decay * p.float()
            m = momentum * state["momentum"].pop(k).float() + g
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
        scale = _grad_scale(grads, grad_clip_norm)
        t = np.float32(step) + np.float32(1.0)
        bc1 = float(np.float32(1.0) - np.power(np.float32(b1), t))
        bc2 = float(np.float32(1.0) - np.power(np.float32(b2), t))
        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            g = _clipped(grads.pop(k), scale).float()
            m = b1 * state["m"].pop(k).float() + (1 - b1) * g
            v = b2 * state["v"].pop(k).float() + (1 - b2) * g.square()
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
