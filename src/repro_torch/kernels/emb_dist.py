"""Normalized embedding distance (Eq. 2): the Triton kernels' wrapper, the
autograd Function around them, and the plain PyTorch version.

Port of ``repro/kernels/emb_dist.py:emb_dist`` (the Pallas TPU kernel). The
kernels are ``csrc/emb_dist_triton.py``; see its header for the design,
the backward's formula and the bound on the H100. Per row of (B, E):

    ‖s/(‖s‖+ε) − t/(‖t‖+ε)‖²,   ε = 1e-8

Note ``F.normalize`` divides by max(‖x‖, ε), not ‖x‖+ε, so it is not
used. Differentiable in ``s`` only. A CUDA tensor launches the kernels (or
raises); a CPU tensor takes the plain versions; a meta tensor gets empty
outputs. Under a cost counter the forward and the backward are one entry
each, of `cost_fwd` and `cost_bwd`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import LaunchCounter, triton_module
from repro_torch.roofline import op_cost

Tensor = torch.Tensor

EPS = 1e-8
MAX_E = 8192
FWD_COUNTER = LaunchCounter("emb_dist_fwd")
BWD_COUNTER = LaunchCounter("emb_dist_bwd")
_SOURCE = "src/repro_torch/kernels/csrc/emb_dist_triton.py"
_REPLACES = "src/repro/kernels/emb_dist.py:39"
INFO_FWD = {"name": "emb_dist_fwd", "route": "triton", "source": _SOURCE,
            "replaces": _REPLACES}
INFO_BWD = {"name": "emb_dist_bwd", "route": "triton", "source": _SOURCE,
            "replaces": _REPLACES}


def cost_fwd(B: int, E: int, s_bytes: int = 4, t_bytes: int = 4):
    """(FLOPs by type, bytes) of the forward on (B, E) rows: both read
    once, the (B,) distances written in f32; eight f32 operations an
    element pair (two squares and sums for the norms, two scalings, the
    difference, its square and sum)."""
    return {"f32": 8.0 * B * E}, float(B * E * (s_bytes + t_bytes) + B * 4)


def cost_bwd(B: int, E: int, s_bytes: int = 4, t_bytes: int = 4):
    """The backward: s, t and the upstream gradient read, the gradient
    written in s's dtype; fourteen f32 operations an element pair."""
    return {"f32": 14.0 * B * E}, float(B * E * (2 * s_bytes + t_bytes)
                                        + B * 4)


def _acc(x: Tensor) -> Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def emb_dist_plain(s: Tensor, t: Tensor, eps: float = EPS) -> Tensor:
    s, t = _acc(s), _acc(t)
    s = s / (torch.linalg.vector_norm(s, dim=-1, keepdim=True) + eps)
    t = t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + eps)
    return torch.square(s - t).sum(dim=-1)


def emb_dist_bwd_plain(s: Tensor, t: Tensor, g: Tensor,
                       eps: float = EPS) -> Tensor:
    """∂(Σ g·out)/∂s, the formula the backward kernel computes."""
    s32, t32 = _acc(s), _acc(t)
    n = torch.linalg.vector_norm(s32, dim=-1, keepdim=True)
    nt = torch.linalg.vector_norm(t32, dim=-1, keepdim=True)
    r = 2.0 * (s32 / (n + eps) - t32 / (nt + eps))
    sr = (s32 * r).sum(dim=-1, keepdim=True)
    coef = torch.where(n > 0, sr / ((n + eps) * (n + eps) * n),
                       torch.zeros_like(n))
    return (g[:, None] * (r / (n + eps) - s32 * coef)).to(s.dtype)


def _check(s: Tensor, t: Tensor, device: str = "cuda") -> None:
    """The kernel's contract (a meta call checks what the card would
    refuse)."""
    if s.dim() != 2 or s.shape != t.shape:
        raise ValueError(f"emb_dist takes two (B, E) tensors of one shape, "
                         f"got {tuple(s.shape)} and {tuple(t.shape)}")
    if s.shape[1] > MAX_E:
        raise ValueError(f"emb_dist kernel holds a row of E <= {MAX_E}, "
                         f"got {s.shape[1]}")
    if s.dtype not in (torch.float32, torch.bfloat16, torch.float16) or \
            t.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"emb_dist kernel takes f32/bf16/f16, got "
                         f"{s.dtype}, {t.dtype}")
    if not s.device.type == t.device.type == device:
        where = "CUDA" if device == "cuda" else device
        raise ValueError(f"emb_dist kernel takes {where} tensors")


def _block(E: int):
    block = max(16, 1 << (E - 1).bit_length())
    return block, (4 if block <= 1024 else 8)


def emb_dist_fwd_kernel(s: Tensor, t: Tensor) -> Tensor:
    _check(s, t)
    s, t = s.contiguous(), t.contiguous()
    B, E = s.shape
    out = torch.empty((B,), dtype=torch.float32, device=s.device)
    if B:
        mod = triton_module("emb_dist")
        block, warps = _block(E)
        with torch.cuda.device(s.device):
            mod.emb_dist_fwd_kernel[(B,)](
                s, t, out, E, s.stride(0), t.stride(0), EPS,
                BLOCK_E=block, num_warps=warps)
        FWD_COUNTER.bump()
    return out


def emb_dist_bwd_kernel(s: Tensor, t: Tensor, g: Tensor) -> Tensor:
    _check(s, t)
    s, t = s.contiguous(), t.contiguous()
    g = g.float().contiguous()
    B, E = s.shape
    gs = torch.empty_like(s)
    if B:
        mod = triton_module("emb_dist")
        block, warps = _block(E)
        with torch.cuda.device(s.device):
            mod.emb_dist_bwd_kernel[(B,)](
                s, t, g, gs, E, s.stride(0), t.stride(0), gs.stride(0), EPS,
                BLOCK_E=block, num_warps=warps)
        BWD_COUNTER.bump()
    return gs


class EmbDist(torch.autograd.Function):
    """Per-row distance with a gradient for the student embedding only."""

    @staticmethod
    def forward(ctx, s, t):
        with op_cost.kernel(INFO_FWD["name"], cost_fwd(
                *s.shape, s.element_size(), t.element_size())):
            if s.is_cuda:
                out = emb_dist_fwd_kernel(s, t)
            elif s.device.type == "meta":
                _check(s, t, "meta")
                out = s.new_empty(s.shape[0], dtype=torch.float32)
            elif s.device.type == "cpu" and t.device.type == "cpu":
                out = emb_dist_plain(s, t)
            else:
                raise ValueError(f"emb_dist: no kernel for {s.device}")
        ctx.save_for_backward(s, t)
        return out

    @staticmethod
    def backward(ctx, g):
        s, t = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None
        with op_cost.kernel(INFO_BWD["name"], cost_bwd(
                *s.shape, s.element_size(), t.element_size())):
            if s.is_cuda:
                return emb_dist_bwd_kernel(s, t, g), None
            if s.device.type == "meta":
                return s.new_empty(s.shape), None
            # contiguous, as the kernel's: what follows sees one layout
            return emb_dist_bwd_plain(s, t, g).contiguous(), None


def emb_dist(student_emb: Tensor, teacher_emb: Tensor) -> Tensor:
    """(B, E) × (B, E) -> per-row squared normalized distance (B,)."""
    return EmbDist.apply(student_emb, teacher_emb)
