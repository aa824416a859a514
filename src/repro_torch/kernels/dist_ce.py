"""Fused distillation cross-entropy: the Triton kernels' wrapper, the
autograd Function around them, and the plain PyTorch version.

Port of ``repro/kernels/dist_ce.py:dist_ce`` (the Pallas TPU kernel). The
kernels are ``csrc/dist_ce_triton.py``; see its header for the design and
the bound on the H100. Per row of (B, V) student and teacher logits:

    ce     = −Σ_v softmax(t)_v · log softmax(s)_v
    t_conf = max_v softmax(t)_v,   s_conf = max_v softmax(s)_v   (Λ, Eq. 4)

``dist_ce(s, t)`` is differentiable in ``s`` only (the teacher is a
constant of the distillation loss): ∂ce/∂s = softmax(s) − softmax(t). The
TPU kernel has no backward, so the port writes one as a second kernel, and
`dist_ce_bwd_plain` is its formula in plain ops. A CUDA tensor launches the
kernels (or raises); a CPU tensor takes the plain versions; a meta tensor
gets empty outputs. Under a cost counter the forward and the backward are
one entry each, of `cost_fwd` and `cost_bwd`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.build import LaunchCounter, triton_module
from repro_torch.roofline import op_cost

Tensor = torch.Tensor

FWD_COUNTER = LaunchCounter("dist_ce_fwd")
BWD_COUNTER = LaunchCounter("dist_ce_bwd")
_SOURCE = "src/repro_torch/kernels/csrc/dist_ce_triton.py"
_REPLACES = "src/repro/kernels/dist_ce.py:107"
INFO_FWD = {"name": "dist_ce_fwd", "route": "triton", "source": _SOURCE,
            "replaces": _REPLACES}
INFO_BWD = {"name": "dist_ce_bwd", "route": "triton", "source": _SOURCE,
            "replaces": _REPLACES}


def cost_fwd(B: int, V: int, s_bytes: int, t_bytes: int = 4):
    """(FLOPs by type, bytes) of the forward on (B, V) rows of ``s_bytes``
    and ``t_bytes`` an element: both read once, ce, the two confidences
    and the (B, 4) stats written in f32; eight f32 operations an element
    pair (two maxima, two exps, two sums, the product and its sum)."""
    return {"f32": 8.0 * B * V}, float(B * V * (s_bytes + t_bytes)
                                       + 7 * B * 4)


def cost_bwd(B: int, V: int, s_bytes: int, t_bytes: int = 4):
    """The backward: s, t and the stats and upstream gradient read, the
    gradient (B, V) written in s's dtype; six f32 operations an element
    pair (two exps, two scalings, the difference and its scale)."""
    return {"f32": 6.0 * B * V}, float(B * V * (2 * s_bytes + t_bytes)
                                       + 5 * B * 4)


def _acc(x: Tensor) -> Tensor:
    """f32 accumulation for f32/bf16/f16 inputs; float64 stays float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def dist_ce_fwd_plain(s: Tensor, t: Tensor
                      ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(ce, t_conf, s_conf, stats) with stats (B, 4) = (m_s, Z_s, m_t, Z_t),
    the kernel's arithmetic in plain ops."""
    s, t = _acc(s), _acc(t)
    m_s = s.amax(dim=-1)
    z_s = torch.exp(s - m_s[:, None]).sum(dim=-1)
    m_t = t.amax(dim=-1)
    e_t = torch.exp(t - m_t[:, None])
    z_t = e_t.sum(dim=-1)
    a = (e_t * s).sum(dim=-1)
    ce = m_s + torch.log(z_s) - a / z_t
    stats = torch.stack([m_s, z_s, m_t, z_t], dim=-1)
    return ce, 1.0 / z_t, 1.0 / z_s, stats


def dist_ce_bwd_plain(s: Tensor, t: Tensor, stats: Tensor, g: Tensor
                      ) -> Tensor:
    """∂(Σ g·ce)/∂s = g·(softmax(s) − softmax(t)) from the saved stats."""
    s32, t32 = _acc(s), _acc(t)
    m_s, z_s, m_t, z_t = (stats[:, i:i + 1] for i in range(4))
    gs = g[:, None] * (torch.exp(s32 - m_s) / z_s
                       - torch.exp(t32 - m_t) / z_t)
    return gs.to(s.dtype)


def _check(s: Tensor, t: Tensor, device: str = "cuda") -> None:
    """The kernel's contract (a meta call checks what the card would
    refuse)."""
    if s.dim() != 2 or s.shape != t.shape:
        raise ValueError(f"dist_ce takes two (B, V) tensors of one shape, "
                         f"got {tuple(s.shape)} and {tuple(t.shape)}")
    if s.dtype not in (torch.float32, torch.bfloat16, torch.float16) or \
            t.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"dist_ce kernel takes f32/bf16/f16, got "
                         f"{s.dtype}, {t.dtype}")
    if not s.device.type == t.device.type == device:
        where = "CUDA" if device == "cuda" else device
        raise ValueError(f"dist_ce kernel takes {where} tensors")


def _blocks(V: int, cap: int) -> Tuple[int, int]:
    block = min(max(16, 1 << (V - 1).bit_length()), cap)
    return block, (4 if block <= 1024 else 8)


def dist_ce_fwd_kernel(s: Tensor, t: Tensor
                       ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    _check(s, t)
    s, t = s.contiguous(), t.contiguous()
    B, V = s.shape
    out = torch.empty((3, B), dtype=torch.float32, device=s.device)
    stats = torch.empty((B, 4), dtype=torch.float32, device=s.device)
    if B:
        mod = triton_module("dist_ce")
        block, warps = _blocks(V, 4096)
        with torch.cuda.device(s.device):
            mod.dist_ce_fwd_kernel[(B,)](
                s, t, out[0], out[1], out[2], stats, V, s.stride(0),
                t.stride(0), BLOCK_V=block, num_warps=warps)
        FWD_COUNTER.bump()
    return out[0], out[1], out[2], stats


def dist_ce_bwd_kernel(s: Tensor, t: Tensor, stats: Tensor, g: Tensor
                       ) -> Tensor:
    _check(s, t)
    s, t = s.contiguous(), t.contiguous()
    g = g.float().contiguous()
    B, V = s.shape
    gs = torch.empty_like(s)
    if B:
        mod = triton_module("dist_ce")
        block, warps = _blocks(V, 1024)
        with torch.cuda.device(s.device):
            mod.dist_ce_bwd_kernel[(B, -(-V // block))](
                s, t, stats, g, gs, V, s.stride(0), t.stride(0),
                gs.stride(0), BLOCK_V=block, num_warps=warps)
        BWD_COUNTER.bump()
    return gs


class DistCE(torch.autograd.Function):
    """(ce, t_conf, s_conf) with a gradient for the student logits only."""

    @staticmethod
    def forward(ctx, s, t):
        with op_cost.kernel(INFO_FWD["name"], cost_fwd(
                *s.shape, s.element_size(), t.element_size())):
            if s.is_cuda:
                ce, t_conf, s_conf, stats = dist_ce_fwd_kernel(s, t)
            elif s.device.type == "meta" and t.device.type == "meta":
                _check(s, t, "meta")
                ce, t_conf, s_conf = (s.new_empty(s.shape[0],
                                                  dtype=torch.float32)
                                      for _ in range(3))
                stats = s.new_empty((s.shape[0], 4), dtype=torch.float32)
            elif s.device.type == "cpu" and t.device.type == "cpu":
                ce, t_conf, s_conf, stats = dist_ce_fwd_plain(s, t)
            else:
                raise ValueError(f"dist_ce: no kernel for {s.device}")
        ctx.save_for_backward(s, t, stats)
        ctx.mark_non_differentiable(t_conf, s_conf)
        return ce, t_conf, s_conf

    @staticmethod
    def backward(ctx, g_ce, g_tconf, g_sconf):
        s, t, stats = ctx.saved_tensors
        if g_ce is None or not ctx.needs_input_grad[0]:
            return None, None
        with op_cost.kernel(INFO_BWD["name"], cost_bwd(
                *s.shape, s.element_size(), t.element_size())):
            if s.is_cuda:
                return dist_ce_bwd_kernel(s, t, stats, g_ce), None
            if s.device.type == "meta":
                return s.new_empty(s.shape), None
            # contiguous, as the kernel's: what follows sees one layout
            return dist_ce_bwd_plain(s, t, stats, g_ce).contiguous(), None


def dist_ce(student_logits: Tensor, teacher_logits: Tensor
            ) -> Tuple[Tensor, Tensor, Tensor]:
    """(B, V) × (B, V) -> (ce (B,), teacher_conf (B,), student_conf (B,))."""
    return DistCE.apply(student_logits, teacher_logits)
