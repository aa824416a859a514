"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) block, in PyTorch
(port of ``repro/models/ssm.py``).

Per head h with state N and head dim P,
    h_t = exp(dt_t A) h_{t−1} + dt_t B_t x_tᵀ,   y_t = C_tᵀ h_t + D x_t,
with B and C shared across heads (ngroups = 1). The scan itself is
`repro_torch.kernels.ops.ssd_scan`: the hand-written CUDA kernels (forward
and backward) for a CUDA tensor, the plain PyTorch version for a CPU tensor
— the chunked math when T is a multiple of the config's chunk, the
sequential recurrence otherwise, as the reference chooses. This module
keeps no second copy of either.

Decode (``init_mamba2_cache``, ``mamba2_decode``) is the recurrence above
for one token a row: the SSM state h (B, H, P, N) in f32 and the conv's
last ``d_conv − 1`` inputs carried in the cache. It runs no scan, so no
kernel: torch ops, as the reference's jnp.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.config import MambaConfig
from repro_torch.models.layers import (
    causal_conv1d_apply,
    causal_conv1d_step,
    dense_init,
    init_causal_conv1d,
    init_norm,
    norm_apply,
)

Tensor = torch.Tensor
Params = Dict[str, Tensor]


def init_mamba2(gen: torch.Generator, d_model: int, cfg: MambaConfig,
                dtype=torch.float32) -> Params:
    """One block's params, flat: in_proj, conv/{w,b}, A_log, D, dt_bias,
    norm/scale, out_proj."""
    d_in = cfg.d_inner(d_model)
    H = cfg.num_heads(d_model)
    N = cfg.d_state
    conv_ch = d_in + 2 * N  # x, B, C all pass through the causal conv
    # dt_bias so that softplus(dt_bias) spans ~[1e-3, 1e-1]: the inverse
    # softplus of a log-uniform draw (the mamba2 default)
    u = torch.rand(H, generator=gen, device=gen.device)
    dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    conv = init_causal_conv1d(gen, conv_ch, cfg.d_conv, dtype)
    norm = init_norm(d_in, "rmsnorm", dtype)
    return {
        "in_proj": dense_init(gen, d_model, 2 * d_in + 2 * N + H, dtype),
        "conv/w": conv["w"],
        "conv/b": conv["b"],
        "A_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32)),
        "D": torch.ones(H, dtype=torch.float32),
        "dt_bias": dt_bias.float(),
        "norm/scale": norm["scale"],
        "out_proj": dense_init(gen, d_in, d_model, dtype),
    }


def _split_in_proj(z_xbc_dt: Tensor, d_in: int, N: int, H: int):
    z = z_xbc_dt[..., :d_in]
    xbc = z_xbc_dt[..., d_in:2 * d_in + 2 * N]
    dt = z_xbc_dt[..., 2 * d_in + 2 * N:]
    return z, xbc, dt


def mamba2_apply(params: Params, x: Tensor, cfg: MambaConfig) -> Tensor:
    """Full-sequence forward. x: (B, T, D) -> (B, T, D)."""
    B_, T, D_model = x.shape
    d_in = cfg.d_inner(D_model)
    H = cfg.num_heads(D_model)
    N = cfg.d_state

    zxd = (x @ params["in_proj"]).to(x.dtype)
    z, xbc, dt_raw = _split_in_proj(zxd, d_in, N, H)
    # the conv runs over the x, B and C channels together, then the split
    xbc = F.silu(causal_conv1d_apply(
        {"w": params["conv/w"], "b": params["conv/b"]}, xbc))
    xc = xbc[..., :d_in].reshape(B_, T, H, cfg.head_dim)
    Bmat = xbc[..., d_in:d_in + N]
    Cmat = xbc[..., d_in + N:]
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])

    # the scan in f32 whatever the model's dtype (the kernel takes f32, as
    # the reference's ssd_chunked computes)
    y, _ = ops.ssd_scan(xc.float(), dt, A, Bmat.float(), Cmat.float(),
                        params["D"], cfg.chunk_size)
    y = y.reshape(B_, T, d_in).to(x.dtype)
    # gated RMSNorm: norm(y * silu(z))
    y = norm_apply({"scale": params["norm/scale"]},
                   y * F.silu(z.float()).to(y.dtype))
    return (y @ params["out_proj"]).to(x.dtype)


def init_mamba2_cache(batch: int, d_model: int, cfg: MambaConfig,
                      dtype=torch.float32, device=None) -> Params:
    """``ssm`` (batch, H, P, N) f32 zeros, ``conv`` (batch, d_conv − 1,
    d_in + 2N) zeros of ``dtype``, ``index`` (batch,) int32."""
    dev = resolve_device(device)
    d_in = cfg.d_inner(d_model)
    H = cfg.num_heads(d_model)
    return {
        "ssm": torch.zeros(batch, H, cfg.head_dim, cfg.d_state,
                           dtype=torch.float32, device=dev),
        "conv": torch.zeros(batch, cfg.d_conv - 1, d_in + 2 * cfg.d_state,
                            dtype=dtype, device=dev),
        "index": torch.zeros(batch, dtype=torch.int32, device=dev),
    }


def mamba2_decode(params: Params, x: Tensor, cache: Params,
                  cfg: MambaConfig):
    """One token a row, x (B, 1, D): h ← exp(dt·A) h + dt·x Bᵀ, y = C·h +
    D·x, through the gated norm and ``out_proj``. Returns (y (B, 1, D), the
    new cache)."""
    B_, _, D_model = x.shape
    d_in = cfg.d_inner(D_model)
    H = cfg.num_heads(D_model)
    N = cfg.d_state

    zxd = (x @ params["in_proj"]).to(x.dtype)[:, 0]
    z, xbc, dt_raw = _split_in_proj(zxd, d_in, N, H)
    xbc, conv_state = causal_conv1d_step(
        {"w": params["conv/w"], "b": params["conv/b"]}, xbc, cache["conv"])
    xbc = F.silu(xbc)
    xc = xbc[..., :d_in].reshape(B_, H, cfg.head_dim).float()
    Bmat = xbc[..., d_in:d_in + N].float()
    Cmat = xbc[..., d_in + N:].float()
    dt = F.softplus(dt_raw.float() + params["dt_bias"])  # (B, H)
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dt * A[None, :])

    h = cache["ssm"] * decay[:, :, None, None] + (
        (dt[:, :, None] * xc)[..., None] * Bmat[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", h, Cmat) + xc * params["D"][None, :,
                                                                  None]
    y = y.reshape(B_, d_in)
    y = norm_apply({"scale": params["norm/scale"]},
                   (y * F.silu(z.float())).to(x.dtype))
    out = (y @ params["out_proj"]).to(x.dtype)
    return out[:, None, :], {"ssm": h, "conv": conv_state,
                             "index": cache["index"] + 1}
