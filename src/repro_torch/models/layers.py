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
``logit_softcap`` c caps the scaled scores to c·tanh(s / c) before the
mask, as the reference does: in the kernel on the full-sequence path, in
the dense scores at decode.

Under tensor parallelism (an active ``"tp"`` `common.sharding.Partition`
with 'model' above 1) a rank holds the column blocks of ``wq`` (whole
query heads) and of ``w_up``/``w_gate``, and the matching row blocks of
``wo`` and ``w_down``: attention runs on its heads and the MLP on its
d_ff columns between `tp_enter` and `tp_exit`. Attention takes its local
head count from ``wq``'s block; where ``wk``/``wv`` are whole (their
block would split a KV group, and the layer gathered them), each rank
takes its query heads' groups. The per-head norm scales enter the region
as well, since each rank's heads give a part of their gradient.

Decode (``init_kv_cache``, ``attention_decode``, ``causal_conv1d_step``)
runs one token a row against a cache whose ``index`` holds one position
per row, so the rows of one call may sit at different positions: each row
takes its own RoPE position, its own ring slot ``index mod S`` and its own
validity mask. Its scores are the reference's dense ``attention_scores``
(an einsum there too, no Pallas kernel), torch matmuls here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.common import sharding as SH
from repro_torch.kernels import ops

Tensor = torch.Tensor
Params = Dict[str, Tensor]


# ---------------------------------------------------------------------------
# initializers (torch.Generator draws; the parity tests load JAX params)
# ---------------------------------------------------------------------------

class MetaDraw(torch.Generator):
    """A CPU generator whose draws land on the ``meta`` device: an init run
    with it (every initializer draws on ``gen.device``) gives its params'
    shapes and dtypes and allocates nothing. ``torch.Generator(device=
    "meta")`` does not exist; ``torch.randn(..., generator=<a CPU
    generator>, device="meta")`` does."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


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


def tp_partition() -> Optional[SH.Partition]:
    """The active partition when tensor parallelism is on, else None."""
    part = SH.active_partition()
    return part if part is not None and part.tp else None


def mlp_apply(params: Params, x: Tensor, act: str = "silu",
              tp: bool = False) -> Tensor:
    """The FFN; ``tp``: the weights are this rank's d_ff blocks (column-
    parallel in, row-parallel out) under the active partition."""
    part = tp_partition() if tp else None
    if part is not None:
        x = SH.tp_enter(x, part)
    up = x @ params["w_up"]
    if act == "silu":
        h = F.silu(x @ params["w_gate"]) * up
    elif act == "gelu":
        h = F.gelu(up, approximate="tanh")  # jax.nn.gelu's default
    elif act == "relu2":  # squared ReLU (nemotron/minitron)
        h = torch.square(F.relu(up))
    else:
        raise ValueError(act)
    y = h.to(x.dtype) @ params["w_down"]
    if part is not None:
        y = SH.tp_exit(y, part)
    return y.to(x.dtype)


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


def _local_groups(H: int, dims: AttnDims, part: SH.Partition):
    """The KV heads this model rank's H query heads attend with (a slice,
    or an index a query head where its heads straddle groups)."""
    G = dims.num_heads // dims.num_kv_heads
    q0 = part.index(("model",)) * H
    if H % G == 0:
        return slice(q0 // G, (q0 + H) // G)
    if G % H == 0:
        return slice(q0 // G, q0 // G + 1)
    return torch.arange(q0, q0 + H) // G


def _project_qkv(params: Params, dims: AttnDims, x: Tensor, kv_src: Tensor,
                 positions: Tensor, kv_positions: Tensor,
                 rope_theta: Optional[float],
                 part: Optional[SH.Partition] = None):
    """q (B, T, H, hd) from x (B, T, D), k and v (B, S, KV, hd) from
    kv_src (B, S, ·): bias, per-head RMSNorm of q and k, then RoPE on both
    (q at ``positions``, k at ``kv_positions``). Under ``part`` (tensor
    parallelism) H and KV are this rank's."""
    hd = dims.head_dim
    H, KV = params["wq"].shape[1] // hd, params["wk"].shape[1] // hd
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
    if part is not None and KV == dims.num_kv_heads:
        sel = _local_groups(H, dims, part)
        k, v = k[..., sel, :], v[..., sel, :]
    if dims.qk_norm:
        qs, ks = params["q_norm/scale"], params["k_norm/scale"]
        if part is not None:
            qs, ks = SH.tp_enter(qs, part), SH.tp_enter(ks, part)
        q = norm_apply({"scale": qs}, q, "rmsnorm")
        k = norm_apply({"scale": ks}, k, "rmsnorm")
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
    | none (every key: the encoder and cross attention). ``logit_softcap``
    c caps the scaled scores to c·tanh(s / c) (None: no cap)."""
    if mask_kind not in ("causal", "swa", "none"):
        raise ValueError(mask_kind)
    B, T = x.shape[0], x.shape[1]
    kv_src = x if kv_src is None else kv_src
    S = kv_src.shape[1]
    if positions is None:
        positions = torch.arange(T, device=x.device)[None]
    if kv_positions is None:
        kv_positions = torch.arange(S, device=x.device)[None]
    part = tp_partition()
    if part is not None and \
            params["wq"].shape[1] == dims.num_heads * dims.head_dim:
        part = None  # whole heads do not divide over 'model': no TP
    if part is not None:
        x_in = x
        x = SH.tp_enter(x, part)
        kv_src = x if kv_src is x_in else SH.tp_enter(kv_src, part)
    q, k, v = _project_qkv(params, dims, x, kv_src, positions, kv_positions,
                           rope_theta, part)
    out = ops.flash_attention(q, k, v, causal=mask_kind != "none",
                              window=window if mask_kind == "swa" else 0,
                              softcap=logit_softcap or 0.0)
    out = out.reshape(B, T, q.shape[2] * dims.head_dim) @ params["wo"]
    if part is not None:
        out = SH.tp_exit(out, part)
    return out.to(x.dtype)


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


# ---------------------------------------------------------------------------
# decode (one token a row against a cache; a position per row)
# ---------------------------------------------------------------------------

def attention_scores(q: Tensor, k: Tensor, v: Tensor,
                     mask: Optional[Tensor],
                     logit_softcap: Optional[float] = None) -> Tensor:
    """The reference's dense GQA attention. q (B, T, H, hd), k and v (B, S,
    KV, hd); ``mask`` broadcastable to (B, KV, G, T, S), True where a key
    counts, or None. Scores in f32, capped to c·tanh(s / c) under a
    ``logit_softcap`` c, masked at −1e30 (not −inf, as the reference), the
    output in v's dtype."""
    B, T, H, hd = q.shape
    KV = k.shape[2]
    dt = torch.promote_types(q.dtype, k.dtype)
    q5 = q.reshape(B, T, KV, H // KV, hd).to(dt)
    scores = torch.einsum("btkgh,bskh->bkgts", q5, k.to(dt)).float()
    scores = scores / math.sqrt(hd)
    if logit_softcap is not None:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)
    if mask is not None:
        scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", probs.to(v.dtype), v)
    return out.reshape(B, T, H, hd).to(v.dtype)


def init_kv_cache(batch: int, length: int, num_kv_heads: int,
                  head_dim: int, dtype=torch.bfloat16,
                  device=None) -> Params:
    """k and v (batch, length, KV, hd) zeros, and ``index`` (batch,) int32:
    the position each row's next token takes."""
    dev = resolve_device(device)
    shape = (batch, length, num_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "index": torch.zeros(batch, dtype=torch.int32, device=dev)}


def attention_decode(params: Params, dims: AttnDims, x: Tensor,
                     cache: Params, *, window: int = 0,
                     rope_theta: Optional[float] = 10_000.0,
                     logit_softcap: Optional[float] = None):
    """One token a row, x (B, 1, D), against a ring (sliding-window
    layers: the cache is ``window`` long) or linear (the cache is the
    longest sequence) KV cache. Row b writes its k and v to slot
    ``index[b] mod S`` and attends to the slots whose absolute position
    lies in [0, index[b]] (and within ``window`` of it). Returns (y (B, 1,
    D), the new cache); the old one is left as it was. ``logit_softcap``
    as in `attention_scores`."""
    B = x.shape[0]
    S = cache["k"].shape[1]
    idx = cache["index"]
    positions = idx[:, None]
    q, k_new, v_new = _project_qkv(params, dims, x, x, positions, positions,
                                   rope_theta)
    rows = torch.arange(B, device=x.device)
    slot = torch.remainder(idx, S).long()
    k = cache["k"].index_put((rows, slot), k_new[:, 0].to(cache["k"].dtype))
    v = cache["v"].index_put((rows, slot), v_new[:, 0].to(cache["v"].dtype))
    # the absolute position each slot holds (ring semantics), per row
    pos = idx[:, None].long()
    abs_pos = pos - torch.remainder(
        pos - torch.arange(S, device=x.device), S)
    valid = (abs_pos >= 0) & (abs_pos <= pos)
    if window:
        valid &= abs_pos > pos - window
    out = attention_scores(q, k, v, valid[:, None, None, None, :],
                           logit_softcap)
    out = out.reshape(B, 1, dims.num_heads * dims.head_dim)
    y = (out.to(params["wo"].dtype) @ params["wo"]).to(x.dtype)
    return y, {"k": k, "v": v, "index": idx + 1}


def causal_conv1d_step(params: Params, x_t: Tensor, conv_state: Tensor):
    """One decode step of the depthwise causal conv. x_t (B, C),
    conv_state (B, width − 1, C): the last inputs. Returns (out (B, C),
    the new state)."""
    dt = torch.promote_types(conv_state.dtype, x_t.dtype)
    window = torch.cat([conv_state.to(dt), x_t[:, None, :].to(dt)], dim=1)
    out = torch.einsum("bwc,wc->bc", window, params["w"]) + params["b"]
    return out, window[:, 1:, :]
