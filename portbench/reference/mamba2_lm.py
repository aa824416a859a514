"""Plain PyTorch reference of the Mamba2 language model a client trains
(arXiv:2405.21060), written from the published description and keyed by
the program's parameter names, so that both sides take the same weights.

  embed -> n_layer x [x + Mamba2(RMSNorm(x))] -> RMSNorm -> tied head
  (logits = h @ embed^T) and ``num_aux_heads`` auxiliary heads (h @ W_k).

Mamba2 (ngroups = 1): in_proj -> (z, xBC, dt); a depthwise causal conv
over xBC and SiLU; dt = softplus(dt + dt_bias), A = -exp(A_log);
h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T, y_t = C_t^T h_t + D x_t,
computed here in its quadratic (attention-like) form over the whole
sequence; then RMSNorm(y * SiLU(z)) and out_proj. Every layer keeps its
leaves stacked over the layers, as the program does.

No kernels, no cache, no batching tricks; the dtype is the caller's
(float64 for the check). Imports torch alone.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Tensor = torch.Tensor
LAYER = "stage0/layer0/"
# a layer's leaves, each stacked over the layers under LAYER
LAYER_LEAVES = ("attn_norm/scale", "attn/in_proj", "attn/conv/w",
                "attn/conv/b", "attn/A_log", "attn/D", "attn/dt_bias",
                "attn/norm/scale", "attn/out_proj")


def dims(cfg: dict) -> Tuple[int, int, int, int, int]:
    """(d_model, d_inner, heads, head dim, state size)."""
    D = cfg["d_model"]
    d_in = cfg["expand"] * D
    return D, d_in, d_in // cfg["headdim"], cfg["headdim"], cfg["d_state"]


def leaves(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's name and shape."""
    D, d_in, H, _, N = dims(cfg)
    L, V, m = cfg["n_layer"], cfg["vocab_size"], cfg["num_aux_heads"]
    conv = d_in + 2 * N
    out = {
        "embed": (V, D),
        "final_norm/scale": (D,),
        LAYER + "attn_norm/scale": (L, D),
        LAYER + "attn/in_proj": (L, D, 2 * d_in + 2 * N + H),
        LAYER + "attn/conv/w": (L, cfg["d_conv"], conv),
        LAYER + "attn/conv/b": (L, conv),
        LAYER + "attn/A_log": (L, H),
        LAYER + "attn/D": (L, H),
        LAYER + "attn/dt_bias": (L, H),
        LAYER + "attn/norm/scale": (L, d_in),
        LAYER + "attn/out_proj": (L, d_in, D),
    }
    if m:
        out["aux_heads"] = (m, D, V)
    return out


def init_kind(name: str, shape: Tuple[int, ...]) -> Tuple[str, float]:
    """How a leaf is drawn: ("normal", std), ("ones" | "zeros", 0),
    ("log_arange", 0) (A_log = log 1..H) or ("dt_bias", 0) (the inverse
    softplus of dt log-uniform in [1e-3, 1e-1]) — Mamba2's initialisation."""
    leaf = name.rsplit("/", 1)[-1]
    if leaf == "scale" or leaf == "D":
        return "ones", 0.0
    if name.endswith("conv/b"):
        return "zeros", 0.0
    if leaf == "A_log":
        return "log_arange", 0.0
    if leaf == "dt_bias":
        return "dt_bias", 0.0
    if name == "embed":
        return "normal", 0.02
    if name.endswith("conv/w"):
        return "normal", 1.0 / math.sqrt(shape[-2])
    # in_proj, out_proj, aux_heads: 1 / sqrt(fan in)
    return "normal", 1.0 / math.sqrt(shape[-2])


def rmsnorm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def ssd(x: Tensor, dt: Tensor, A: Tensor, B: Tensor, C: Tensor,
        D: Tensor) -> Tensor:
    """y (b, T, H, P) of the scan, quadratic form: y_t = sum_{s<=t}
    (C_t . B_s) exp(cs_t - cs_s) dt_s x_s + D x_t with cs the cumulative
    sum of dt A."""
    T = x.shape[1]
    # the decays in float64 whatever the dtype: a float32 cumulative sum
    # over the whole sequence would lose what the chunked scan keeps
    cs = torch.cumsum((dt * A).double(), dim=1)  # (b, T, H)
    seg = cs[:, :, None, :] - cs[:, None, :, :]  # (b, t, s, H)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    causal = causal[None, :, :, None]
    gate = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)),
                       0.0).to(x.dtype)
    M = torch.einsum("btn,bsn->bts", C, B)[..., None] * gate \
        * dt[:, None, :, :]
    return torch.einsum("btsh,bshp->bthp", M, x) + x * D[None, None, :,
                                                          None]


def mamba2(p: Dict[str, Tensor], h: Tensor, cfg: dict) -> Tensor:
    b, T, _ = h.shape
    _, d_in, H, P, N = dims(cfg)
    zxd = h @ p["in_proj"]
    z, xbc, dt = zxd[..., :d_in], zxd[..., d_in:2 * d_in + 2 * N], \
        zxd[..., 2 * d_in + 2 * N:]
    w = p["conv/w"]
    width = w.shape[0]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    conv = sum(pad[:, i:i + T, :] * w[i] for i in range(width)) + p["conv/b"]
    xbc = F.silu(conv)
    x = xbc[..., :d_in].reshape(b, T, H, P)
    Bm, Cm = xbc[..., d_in:d_in + N], xbc[..., d_in + N:]
    dt = F.softplus(dt + p["dt_bias"])
    y = ssd(x, dt, -torch.exp(p["A_log"]), Bm, Cm, p["D"])
    y = rmsnorm(y.reshape(b, T, d_in) * F.silu(z), p["norm/scale"],
                cfg["norm_eps"])
    return y @ p["out_proj"]


def _layer(x: Tensor, cfg: dict, *leaves_l: Tensor) -> Tensor:
    p = dict(zip(LAYER_LEAVES, leaves_l))
    a = {k[len("attn/"):]: v for k, v in p.items() if k.startswith("attn/")}
    return x + mamba2(a, rmsnorm(x, p["attn_norm/scale"], cfg["norm_eps"]),
                      cfg)


def hidden(params: Dict[str, Tensor], cfg: dict, tokens: Tensor) -> Tensor:
    """The final normed hidden states (b, T, d_model); each layer is
    recomputed in the backward (activation checkpointing), which changes no
    value."""
    x = params["embed"][tokens.long()]
    stacked = [params[LAYER + n] for n in LAYER_LEAVES]
    for layer in range(cfg["n_layer"]):
        per = [s[layer] for s in stacked]
        if torch.is_grad_enabled():
            x = checkpoint(_layer, x, cfg, *per, use_reentrant=False)
        else:
            x = _layer(x, cfg, *per)
    return rmsnorm(x, params["final_norm/scale"], cfg["norm_eps"])


def heads(params: Dict[str, Tensor], h: Tensor) -> Tuple[Tensor, Tensor]:
    """(main logits (n, V), aux logits (m, n, V)) of hidden rows h (n, D)."""
    main = h @ params["embed"].t()
    aux = torch.einsum("nd,mdv->mnv", h, params["aux_heads"])
    return main, aux
