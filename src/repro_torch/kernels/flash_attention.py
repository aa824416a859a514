"""Causal / sliding-window attention: the CUDA kernels' wrappers, the
autograd Function around them, and the plain PyTorch version.

Port of ``repro/kernels/flash_attention.py:flash_attention`` (the Pallas
TPU kernel). The kernels are ``csrc/flash_attention.cu`` (CUDA C++ for
sm_90a, loaded with ctypes); see its header for the design and the bound
on the H100. For q (B, T, H, d) and k, v (B, S, KV, d), query head h reads
kv head h // (H // KV):

    o_t = Σ_u softmax_u(s_tu over the mask) v_u,  s_tu = q_t·k_u / √d
    mask: u ≤ t if causal; u > t − window if window > 0
    softcap c > 0: s_tu → c·tanh(s_tu / c) before the mask

in f32 sums, with the output in q's dtype. ``flash_attention(q, k, v,
causal=, window=, softcap=)`` is differentiable in q, k and v. A CUDA tensor
launches the kernels (the forward, which also saves each row's
logsumexp, and the backward when autograd needs it), or raises; a CPU
tensor takes `flash_attention_plain`, differentiated by autograd; a meta
tensor gets empty outputs and gradients. Under a cost counter the forward
and the backward are one entry each, of `cost_fwd` and `cost_bwd`
(`kernels/counted.py`). The TPU kernel has no backward; the port writes
one (FA2: D = rowsum(dO∘O), P = exp(s − lse), dS = P∘(dP − D), times
1 − (s / c)² under a softcap). The TPU kernel applies no softcap; the
reference's XLA attention does (``models/layers.py``), and so do these
kernels. The counted FLOPs are the products' alone, with or without it.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import counted
from repro_torch.kernels.build import LaunchCounter, cuda_library
from repro_torch.roofline import op_cost

Tensor = torch.Tensor

FWD_COUNTER = LaunchCounter("flash_attention_fwd")
BWD_COUNTER = LaunchCounter("flash_attention_bwd")
_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
_REPLACES = "src/repro/kernels/flash_attention.py:99"
INFO_FWD = {"name": "flash_attention_fwd", "route": "cuda",
            "source": _SOURCE, "replaces": _REPLACES}
INFO_BWD = {"name": "flash_attention_bwd", "route": "cuda",
            "source": _SOURCE, "replaces": _REPLACES}

_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 256  # the kernels' largest head dim (flash_attention_max_d())


# ---------------------------------------------------------------------------
# the kernels' cost
# ---------------------------------------------------------------------------

def attn_pairs(T: int, S: int, causal: bool, window: int) -> int:
    """The (query, key) pairs inside the mask: the work of one (b, h)."""
    t = np.arange(T)
    hi = np.minimum(t + 1, S) if causal else np.full(T, S)
    lo = np.maximum(t - window + 1, 0) if window else np.zeros(T, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def cost_fwd(B, T, S, H, KV, d, causal, window, elem):
    """(FLOPs by type, bytes) of the forward: q, k, v read once, o and the
    (B, H, T) f32 lse written; 2 d multiply-adds a pair inside the mask
    (q·k, p·v), on 3×TF32 (three TF32 products for each f32 one)."""
    pairs = attn_pairs(T, S, causal, window) * B * H
    qo, kv, rows = B * T * H * d * elem, B * S * KV * d * elem, B * H * T * 4
    return {"tf32x3": 4.0 * pairs * d}, float(2 * qo + 2 * kv + rows)


def cost_bwd(B, T, S, H, KV, d, causal, window, elem):
    """The backward: q, o, dO, k, v and the lse read, dq, dk and dv
    written; 5 d multiply-adds a pair (s again, dP, dV, dS·K, dSᵀ·Q)."""
    pairs = attn_pairs(T, S, causal, window) * B * H
    qo, kv, rows = B * T * H * d * elem, B * S * KV * d * elem, B * H * T * 4
    return {"tf32x3": 10.0 * pairs * d}, float(3 * qo + 2 * kv + rows
                                               + qo + 2 * kv)


def _costs(q: Tensor, k: Tensor, causal: bool, window: int):
    args = (*q.shape[:2], k.shape[1], q.shape[2], k.shape[2], q.shape[3],
            causal, window, q.element_size())
    return cost_fwd(*args), cost_bwd(*args)


# ---------------------------------------------------------------------------
# the plain version (kernels/ref.py's flash_attention_ref)
# ---------------------------------------------------------------------------

def _acc_dtype(x: Tensor) -> torch.dtype:
    """float32 for f32/bf16/f16 inputs; float64 stays float64 (an oracle)."""
    return torch.promote_types(x.dtype, torch.float32)


def _mask(T: int, S: int, causal: bool, window: int, device) -> Tensor:
    """(T, S): key u is in query t's band."""
    qpos = torch.arange(T, device=device)[:, None]
    kpos = torch.arange(S, device=device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor, *,
                          causal: bool = True, window: int = 0,
                          softcap: float = 0.0) -> Tensor:
    """The function in plain tensor ops, in the layout of
    ``ref.flash_attention_ref``: q (B, T, H, d), k, v (B, S, KV, d) →
    (B, T, H, d) in q's dtype; the dense masked softmax, masked scores
    −1e30 (so a row with no key in its band takes the mean of v); a
    ``softcap`` c > 0 caps the scaled scores to c·tanh(s / c) before the
    mask, as the reference's ``attention_scores`` does."""
    B, T, H, d = q.shape
    S, KV = k.shape[1], k.shape[2]
    acc = _acc_dtype(q)
    qg = q.to(acc).reshape(B, T, KV, H // KV, d)
    s = torch.einsum("btkgd,bskd->bkgts", qg, k.to(acc)) * (1.0 / math.sqrt(d))
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(_mask(T, S, causal, window, q.device), s,
                    torch.full_like(s, _NEG))
    probs = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v.to(acc))
    return out.reshape(B, T, H, d).to(q.dtype)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_library("flash_attention")
    lib.flash_attention_fwd.argtypes = [_I] + [_P] * 5 + [_I] * 8 + [_F, _P]
    lib.flash_attention_fwd.restype = _I
    lib.flash_attention_bwd.argtypes = [_I] + [_P] * 10 + [_I] * 8 + [_F, _P]
    lib.flash_attention_bwd.restype = _I
    lib.flash_attention_max_d.argtypes = []
    lib.flash_attention_max_d.restype = _I
    lib.flash_attention_fwd_tile.argtypes = [_I, _P, _P]
    lib.flash_attention_fwd_tile.restype = None
    return lib


def flash_attention_fwd_tile(d: int) -> Tuple[int, int]:
    """The forward kernel's tile at head dim d: (query rows a block, keys a
    key tile). Builds the kernel's library, so it needs nvcc."""
    rows, keys = _I(), _I()
    _lib().flash_attention_fwd_tile(d, ctypes.byref(rows), ctypes.byref(keys))
    return rows.value, keys.value


def _check(q: Tensor, k: Tensor, v: Tensor, device: str = "cuda"
           ) -> Tuple[int, ...]:
    """The kernels' contract (a meta call checks what the card would
    refuse)."""
    if not q.device.type == k.device.type == v.device.type == device:
        where = "CUDA" if device == "cuda" else device
        raise ValueError(f"flash_attention kernel takes {where} tensors")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16 "
                         f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q (B, T, H, d) and k, v "
                         f"(B, S, KV, d), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, d = q.shape
    S, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != d or KV == 0 or H % KV:
        raise ValueError(f"flash_attention shapes: q {tuple(q.shape)}, "
                         f"k/v {tuple(k.shape)}")
    max_d = _lib().flash_attention_max_d() if device == "cuda" else MAX_D
    if d > max_d:
        raise ValueError(f"flash_attention kernel takes d <= {max_d}, "
                         f"got {d}")
    return B, T, S, H, KV, d


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def flash_attention_fwd_kernel(q: Tensor, k: Tensor, v: Tensor, *,
                               causal: bool = True, window: int = 0,
                               softcap: float = 0.0
                               ) -> Tuple[Tensor, Tensor]:
    """Launch the forward kernel. Returns (o (B, T, H, d) in q's dtype,
    lse (B, H, T) f32, of the capped scores under a ``softcap``)."""
    B, T, S, H, KV, d = _check(q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    dev = q.device
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().flash_attention_fwd(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), B, T, S, H, KV, d, int(causal),
            int(window), float(softcap), _stream(dev))
    if err:
        raise RuntimeError(
            f"flash_attention forward launch failed: cudaError {err}")
    FWD_COUNTER.bump()
    return o, lse


def flash_attention_bwd_kernel(q: Tensor, k: Tensor, v: Tensor, o: Tensor,
                               lse: Tensor, do: Tensor, *, causal: bool,
                               window: int, softcap: float = 0.0
                               ) -> Tuple[Tensor, Tensor, Tensor]:
    """Launch the backward kernels (D, then one fused kernel for dK, dV and
    dQ, which adds dQ into a zeroed f32 buffer with atomics). Returns (dq,
    dk, dv) in the inputs' dtype."""
    B, T, S, H, KV, d = _check(q, k, v)
    q, k, v, o = (t.contiguous() for t in (q, k, v, o))
    do = do.to(q.dtype).contiguous()
    lse = lse.float().contiguous()
    dev = q.device
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dq = torch.zeros((B, T, H, d), dtype=torch.float32, device=dev)
    Dv = torch.empty((B, H, T), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().flash_attention_bwd(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), do.data_ptr(), Dv.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, T, S, H, KV, d,
            int(causal), int(window), float(softcap), _stream(dev))
    if err:
        raise RuntimeError(
            f"flash_attention backward launch failed: cudaError {err}")
    BWD_COUNTER.bump()
    return dq.to(q.dtype), dk, dv


class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v) on the kernels, differentiable in q, k and
    v."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, softcap: float):
        with op_cost.kernel(INFO_FWD["name"], _costs(q, k, causal,
                                                      window)[0]):
            o, lse = flash_attention_fwd_kernel(q, k, v, causal=causal,
                                                window=window,
                                                softcap=softcap)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window, ctx.softcap = causal, window, softcap
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        with op_cost.kernel(INFO_BWD["name"], _costs(q, k, ctx.causal,
                                                      ctx.window)[1]):
            dq, dk, dv = flash_attention_bwd_kernel(
                q, k, v, o, lse, do, causal=ctx.causal, window=ctx.window,
                softcap=ctx.softcap)
        return dq, dk, dv, None, None, None


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: int = 0, softcap: float = 0.0) -> Tensor:
    """q (B, T, H, d), k, v (B, S, KV, d) → (B, T, H, d) in q's dtype;
    ``softcap`` c > 0 caps the scaled scores to c·tanh(s / c)."""
    softcap = float(softcap or 0.0)
    if q.is_cuda:
        return FlashAttention.apply(q, k, v, bool(causal), int(window),
                                    softcap)
    if counted.counting_route(q):
        if q.device.type == "meta":
            _check(q, k, v, "meta")
            call = counted.Call(
                (INFO_FWD["name"], INFO_BWD["name"]),
                _costs(q, k, causal, window),
                lambda q, k, v: (torch.empty_like(q),), counted.empty_grads)
        else:
            def plain(q, k, v):
                return flash_attention_plain(q, k, v, causal=causal,
                                             window=window, softcap=softcap)

            call = counted.Call((INFO_FWD["name"], INFO_BWD["name"]),
                                _costs(q, k, causal, window),
                                lambda *x: (plain(*x),),
                                counted.plain_grads(plain))
        return counted.run(call, q, k, v)[0]
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
