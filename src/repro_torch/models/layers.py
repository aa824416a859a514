"""Core neural layers for the LM path (port of ``repro/models/layers.py``):
initializers, norms and the Mamba2 causal conv.

Parameters are flat dicts of tensors keyed as the reference's pytrees
flatten (``"scale"``, ``"w"`` ...). Dense weights keep the reference's
(in, out) layout and are applied as ``x @ w``; the conv weight is
(width, channels). Matmuls run in the parameters' dtype (float32 on the
LM path, with TF32 off on the card), as the reference accumulates in f32.

Attention, RoPE and the MLP come with the transformer slice of the port.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
Params = Dict[str, Tensor]


# ---------------------------------------------------------------------------
# initializers (torch.Generator draws; the parity tests load JAX params)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype=torch.float32, scale: float = 1.0) -> Tensor:
    std = scale / math.sqrt(in_dim)
    return (torch.randn(in_dim, out_dim, generator=gen) * std).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype=torch.float32) -> Tensor:
    return (torch.randn(vocab, dim, generator=gen) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(d: int, kind: str = "rmsnorm", dtype=torch.float32) -> Params:
    if kind == "rmsnorm":
        return {"scale": torch.ones(d, dtype=dtype)}
    if kind == "layernorm":
        return {"scale": torch.ones(d, dtype=dtype),
                "bias": torch.zeros(d, dtype=dtype)}
    raise ValueError(kind)


def norm_apply(params: Params, x: Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6) -> Tensor:
    x32 = x.float()
    if kind == "rmsnorm":
        var = x32.square().mean(dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + eps) * params["scale"].float()
        return y.to(x.dtype)
    if kind == "layernorm":
        mu = x32.mean(dim=-1, keepdim=True)
        var = x32.var(dim=-1, unbiased=False, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + eps)
        y = y * params["scale"].float() + params["bias"].float()
        return y.to(x.dtype)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# causal conv1d (mamba2 frontend)
# ---------------------------------------------------------------------------

def init_causal_conv1d(gen: torch.Generator, channels: int, width: int,
                       dtype=torch.float32) -> Params:
    std = 1.0 / math.sqrt(width)
    return {"w": (torch.randn(width, channels, generator=gen) * std
                  ).to(dtype),
            "b": torch.zeros(channels, dtype=dtype)}


def causal_conv1d_apply(params: Params, x: Tensor) -> Tensor:
    """Depthwise causal conv. x: (B, T, C) -> (B, T, C); the taps are summed
    in the reference's order."""
    w = params["w"]
    width, T = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = pad[:, 0:T, :] * w[0]
    for i in range(1, width):
        out = out + pad[:, i:i + T, :] * w[i]
    return out + params["b"]
