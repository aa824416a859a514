"""Plain reference of AdamW with global-norm clipping
(``"optimizer": {"name": "adamw", ...}``). Imports torch alone.

Frozen from the program's published semantics as of commit
2982e0a3c166b6b3c956e35f80f9ac7deeae8935: clip by the global norm
(scale = min(1, clip / (norm + 1e-9))), then AdamW with b1 0.9, b2 0.95,
eps 1e-8, no decay, t = step + 1; the learning rate warms up linearly
and then follows a cosine to ``total_steps``.

``first_gradient`` reads the program's side: the first gradient as its
optimizer got it, worked out from its state after one step, for the
check to judge against the reference's clipped gradient.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

Tensor = torch.Tensor
B1, B2, EPS = 0.9, 0.95, 1e-8


def lr_at(step: int, opt: dict) -> float:
    init_lr, warmup, total = (opt["init_lr"], opt["warmup_steps"],
                              opt["total_steps"])
    if step < warmup:
        return init_lr * step / max(warmup, 1)
    t = min(step - warmup, total - warmup) / max(total - warmup, 1)
    return init_lr * 0.5 * (1.0 + math.cos(math.pi * t))


def step(params: Dict[str, Tensor], grads: Dict[str, Tensor],
         state: Dict[str, Dict[str, Tensor]], t: int, opt: dict
         ) -> Dict[str, Tensor]:
    """One AdamW step at step ``t`` in place on ``params`` and ``state``;
    returns the clipped gradients."""
    if opt.get("weight_decay", 0.0):
        raise ValueError("optim_adamw follows AdamW without decay alone")
    lr = lr_at(t, opt)
    norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
    scale = torch.clamp(opt["grad_clip_norm"] / (norm + 1e-9), max=1.0)
    n = t + 1
    bc1, bc2 = 1.0 - B1 ** n, 1.0 - B2 ** n
    clipped = {}
    for k, p in params.items():
        g = grads[k] * scale
        clipped[k] = g
        m = state.setdefault("m", {}).setdefault(k, torch.zeros_like(p))
        v = state.setdefault("v", {}).setdefault(k, torch.zeros_like(p))
        m.mul_(B1).add_((1 - B1) * g)
        v.mul_(B2).add_((1 - B2) * g.square())
        p.sub_(lr * (m / bc1) / (torch.sqrt(v / bc2) + EPS))
    return clipped


def first_gradient(opt_state) -> Dict[str, float]:
    """The norm of each leaf's first gradient as the program's AdamW got
    it: its first moment after one step, over 1 − b1."""
    return {k: float(torch.linalg.vector_norm(v.double())) / (1 - B1)
            for k, v in opt_state["m"].items()}
