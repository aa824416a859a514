"""Core neural layers for the LM path (port of ``repro/models/layers.py``):
initializers, norms, RoPE, the MLP, self-, bidirectional and cross
attention and the Mamba2 causal conv.

Parameters are flat dicts of tensors keyed as the reference's pytrees
flatten (``"scale"``, ``"w"``, ``"wq"``, ``"q_norm/scale"`` ...). Dense
weights keep the reference's (in, out) layout and are applied as
``x @ w``; the conv weight is (width, channels). Matmuls run in the
parameters' dtype (float32 on the LM path, with TF32 off on the card), as
the reference accumulates in f32.

Attention runs through `kernels.ops.flash_attention` at every length: the
reference picks between a dense score matrix and a query-block scan by
size (``attention_scores`` / ``_blockwise_attention``), a memory lever of
the same value that the kernel replaces. Cross attention takes K and V
from ``kv_src`` (B, S, ·) and calls the kernel non-causal with S ≠ T.
``logit_softcap`` raises NotImplementedError naming the ROADMAP item that
ports it; decode comes with serving.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

Tensor = torch.Tensor
Params = Dict[str, Tensor]


# ---------------------------------------------------------------------------
# initializers (torch.Generator draws; the parity tests load JAX params)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype=torch.float32, scale: float = 1.0) -> Tensor:
    std = scale / math.sqrt(in_dim)
    return (torch.randn(in_dim, out_dim, generator=gen,
                        device=gen.device) * std).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype=torch.float32) -> Tensor:
    return (torch.randn(vocab, dim, generator=gen, device=gen.device)
            * 0.02).to(dtype)


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
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: Tensor, positions: Tensor, theta: float = 10_000.0
               ) -> Tensor:
    """x: (..., T, H, hd); positions: broadcastable to (..., T). Rotates
    the split halves (not interleaved pairs), in f32."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)
    ang = positions[..., :, None].float() * inv  # (..., T, hd/2)
    cos = torch.cos(ang)[..., None, :]  # (..., T, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             act: str = "silu", dtype=torch.float32) -> Params:
    params = {"w_up": dense_init(gen, d_model, d_ff, dtype),
              "w_down": dense_init(gen, d_ff, d_model, dtype)}
    if act == "silu":  # gated (SwiGLU) variant
        params["w_gate"] = dense_init(gen, d_model, d_ff, dtype)
    return params


def mlp_apply(params: Params, x: Tensor, act: str = "silu") -> Tensor:
    up = x @ params["w_up"]
    if act == "silu":
        h = F.silu(x @ params["w_gate"]) * up
    elif act == "gelu":
        h = F.gelu(up, approximate="tanh")  # jax.nn.gelu's default
    elif act == "relu2":  # squared ReLU (nemotron/minitron)
        h = torch.square(F.relu(up))
    else:
        raise ValueError(act)
    return (h.to(x.dtype) @ params["w_down"]).to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA; full / sliding-window / bidirectional / cross)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnDims:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    kv_input_dim: Optional[int] = None  # cross-attn: K/V source dim


_SOFTCAP = "ROADMAP Queue 2 item 2.5 (logit_softcap: no configuration " \
           "sets it, and the flash_attention kernel does not apply it)"


def init_attention(gen: torch.Generator, dims: AttnDims,
                   dtype=torch.float32) -> Params:
    H, KV, hd = dims.num_heads, dims.num_kv_heads, dims.head_dim
    kv_in = dims.kv_input_dim or dims.d_model
    params = {"wq": dense_init(gen, dims.d_model, H * hd, dtype),
              "wk": dense_init(gen, kv_in, KV * hd, dtype),
              "wv": dense_init(gen, kv_in, KV * hd, dtype),
              "wo": dense_init(gen, H * hd, dims.d_model, dtype)}
    if dims.qkv_bias:
        params["bq"] = torch.zeros(H * hd, dtype=dtype)
        params["bk"] = torch.zeros(KV * hd, dtype=dtype)
        params["bv"] = torch.zeros(KV * hd, dtype=dtype)
    if dims.qk_norm:
        params["q_norm/scale"] = torch.ones(hd, dtype=dtype)
        params["k_norm/scale"] = torch.ones(hd, dtype=dtype)
    return params


def _project_qkv(params: Params, dims: AttnDims, x: Tensor, kv_src: Tensor,
                 positions: Tensor, kv_positions: Tensor,
                 rope_theta: Optional[float]):
    """q (B, T, H, hd) from x (B, T, D), k and v (B, S, KV, hd) from
    kv_src (B, S, ·): bias, per-head RMSNorm of q and k, then RoPE on both
    (q at ``positions``, k at ``kv_positions``)."""
    H, KV, hd = dims.num_heads, dims.num_kv_heads, dims.head_dim
    q = (x @ params["wq"]).to(x.dtype)
    k = (kv_src @ params["wk"]).to(x.dtype)
    v = (kv_src @ params["wv"]).to(x.dtype)
    if dims.qkv_bias:
        q = q + params["bq"].to(q.dtype)
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    q = q.reshape(q.shape[:-1] + (H, hd))
    k = k.reshape(k.shape[:-1] + (KV, hd))
    v = v.reshape(v.shape[:-1] + (KV, hd))
    if dims.qk_norm:
        q = norm_apply({"scale": params["q_norm/scale"]}, q, "rmsnorm")
        k = norm_apply({"scale": params["k_norm/scale"]}, k, "rmsnorm")
    if rope_theta is not None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, kv_positions, rope_theta)
    return q, k, v


def attention_apply(params: Params, dims: AttnDims, x: Tensor, *,
                    mask_kind: str = "causal", window: int = 0,
                    rope_theta: Optional[float] = 10_000.0,
                    kv_src: Optional[Tensor] = None,
                    positions: Optional[Tensor] = None,
                    kv_positions: Optional[Tensor] = None,
                    logit_softcap: Optional[float] = None) -> Tensor:
    """Self- or cross-attention over full sequences (training / prefill),
    through the ``flash_attention`` kernel. K and V come from ``kv_src``
    (B, S, ·), x itself when None; positions default to 0..T−1 and
    0..S−1. mask_kind: causal | swa (keys within ``window`` of the query)
    | none (every key: the encoder and cross attention)."""
    if logit_softcap is not None:
        raise NotImplementedError(f"attention logit_softcap is not ported "
                                  f"yet: {_SOFTCAP}")
    if mask_kind not in ("causal", "swa", "none"):
        raise ValueError(mask_kind)
    B, T = x.shape[0], x.shape[1]
    kv_src = x if kv_src is None else kv_src
    S = kv_src.shape[1]
    if positions is None:
        positions = torch.arange(T, device=x.device)[None]
    if kv_positions is None:
        kv_positions = torch.arange(S, device=x.device)[None]
    q, k, v = _project_qkv(params, dims, x, kv_src, positions, kv_positions,
                           rope_theta)
    out = ops.flash_attention(q, k, v, causal=mask_kind != "none",
                              window=window if mask_kind == "swa" else 0)
    out = out.reshape(B, T, dims.num_heads * dims.head_dim)
    return (out @ params["wo"]).to(x.dtype)


# ---------------------------------------------------------------------------
# causal conv1d (mamba2 frontend)
# ---------------------------------------------------------------------------

def init_causal_conv1d(gen: torch.Generator, channels: int, width: int,
                       dtype=torch.float32) -> Params:
    std = 1.0 / math.sqrt(width)
    return {"w": (torch.randn(width, channels, generator=gen,
                               device=gen.device) * std
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
