"""Normalized embedding distance (Eq. 2): the CUDA kernels' wrapper, the
autograd Function around them, and the plain PyTorch version.

Port of ``repro/kernels/emb_dist.py:emb_dist`` (the Pallas TPU kernel). The
kernels are ``csrc/emb_dist.cu`` (CUDA C++ for sm_90a, loaded with
ctypes); see its header for the design, the backward's formula and the
bound on the H100. Per row of (B, E):

    ‖s/(‖s‖+ε) − t/(‖t‖+ε)‖²,   ε = 1e-8

Note ``F.normalize`` divides by max(‖x‖, ε), not ‖x‖+ε, so it is not
used. Differentiable in ``s`` only. A CUDA tensor launches the kernels (or
raises); a CPU tensor takes the plain versions; a meta tensor gets empty
outputs. Under a cost counter the forward and the backward are one entry
each, of `cost_fwd` and `cost_bwd`. `launch_geometry` gives the kernels'
launch shape, which the wrapper passes and the CPU tests walk.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.build import LaunchCounter, cuda_library
from repro_torch.roofline import op_cost

Tensor = torch.Tensor

EPS = 1e-8
MAX_E = 8192
FWD_COUNTER = LaunchCounter("emb_dist_fwd")
BWD_COUNTER = LaunchCounter("emb_dist_bwd")
_SOURCE = "src/repro_torch/kernels/csrc/emb_dist.cu"
_REPLACES = "src/repro/kernels/emb_dist.py:39"
INFO_FWD = {"name": "emb_dist_fwd", "route": "cuda", "source": _SOURCE,
            "replaces": _REPLACES}
INFO_BWD = {"name": "emb_dist_bwd", "route": "cuda", "source": _SOURCE,
            "replaces": _REPLACES}

# the kernels' codes of the element types
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
WARP_SPAN = 1024  # elements of a row one warp holds (csrc: kWarpSpan)
BLOCK_WARPS = 4   # a block's warps when a row takes fewer


class Geometry(NamedTuple):
    """How the kernels cut a (B, E) problem: each row is held by a group
    of ``warps_per_row`` warps, ``rows_per_block`` groups a block of
    ``threads``; lane ``l`` of the group's warp ``w`` holds ``vec``
    contiguous elements at `element_index` for each chunk ``c <
    chunks`` (those at E or past it are not loaded). ``path`` is "vec16"
    (16-byte loads of the wider type) or "scalar"."""
    path: str
    vec: int
    chunks: int
    warps_per_row: int
    rows_per_block: int
    threads: int

    def grid(self, B: int) -> int:
        return -(-B // self.rows_per_block)


def vector_width(s_bytes: int, t_bytes: int) -> int:
    """Elements that one 16-byte load of the wider element type holds."""
    return 16 // max(s_bytes, t_bytes)


@functools.lru_cache(maxsize=None)
def launch_geometry(E: int, s_bytes: int, t_bytes: int,
                    aligned: bool) -> Geometry:
    """The kernels' geometry for rows of E elements of s_bytes and t_bytes
    each. ``aligned``: every row of s and t starts on a multiple of its
    vector (the gradient's too, being contiguous, when the vector width
    divides E); with it and E a multiple of the vector width the loads are
    16-byte wide, else one element."""
    wide = vector_width(s_bytes, t_bytes)
    vec = wide if aligned and E % wide == 0 else 1
    wpr = 1 << (-(-max(E, 1) // WARP_SPAN) - 1).bit_length()
    block = max(BLOCK_WARPS, wpr)
    return Geometry("vec16" if vec > 1 else "scalar", vec,
                    WARP_SPAN // (32 * vec), wpr, block // wpr, 32 * block)


def element_index(geom: Geometry, warp: int, lane: int, chunk: int,
                  v: int) -> int:
    """The column that element ``v`` of chunk ``chunk`` of ``lane`` of the
    row group's warp ``warp`` holds (``RowTile::col`` in the source)."""
    return ((chunk * geom.warps_per_row + warp) * 32 + lane) * geom.vec + v


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


_FNS: Optional[tuple] = None


def _fns() -> tuple:
    """The library's two entries, bound once with their argument types."""
    global _FNS
    if _FNS is None:
        lib = cuda_library("emb_dist")
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fwd, bwd = lib.emb_dist_fwd, lib.emb_dist_bwd
        fwd.argtypes = [p, p, p, ll, i, ll, ll, i, i, i, i, i,
                        ctypes.c_float, p]
        bwd.argtypes = [p, p, p, p, ll, i, ll, ll, ll, i, i, i, i, i,
                        ctypes.c_float, p]
        fwd.restype = bwd.restype = ctypes.c_int
        _FNS = fwd, bwd
    return _FNS


def _rows(x: Tensor) -> Tensor:
    """x itself where its columns are adjacent (the kernels take any row
    stride), else a contiguous copy."""
    return x if x.stride(1) == 1 or x.shape[1] <= 1 else x.contiguous()


def _geometry(s: Tensor, t: Tensor) -> Geometry:
    """`launch_geometry` of two (B, E) tensors: aligned when each one's
    base address and row stride are multiples of its vector."""
    sb, tb = s.element_size(), t.element_size()
    vec = vector_width(sb, tb)
    aligned = (s.data_ptr() % (vec * sb) == 0 and s.stride(0) % vec == 0
               and t.data_ptr() % (vec * tb) == 0 and t.stride(0) % vec == 0)
    return launch_geometry(s.shape[1], sb, tb, aligned)


def _launch(fn, name: str, device: torch.device, *args) -> None:
    """``fn(*args, stream)`` on the tensors' card and its current stream
    (entering the card only when it is not the current one); raises on a
    refused launch."""
    other = device.index != torch.cuda.current_device()
    with torch.cuda.device(device) if other else contextlib.nullcontext():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def emb_dist_fwd_kernel(s: Tensor, t: Tensor) -> Tensor:
    _check(s, t)
    s, t = _rows(s), _rows(t)
    B, E = s.shape
    out = torch.empty((B,), dtype=torch.float32, device=s.device)
    if B:
        geo = _geometry(s, t)
        _launch(_fns()[0], "emb_dist_fwd", s.device, s.data_ptr(),
                t.data_ptr(), out.data_ptr(), B, E, s.stride(0), t.stride(0),
                DTYPES[s.dtype], DTYPES[t.dtype], geo.vec, geo.warps_per_row,
                geo.threads, EPS)
        FWD_COUNTER.bump()
    return out


def emb_dist_bwd_kernel(s: Tensor, t: Tensor, g: Tensor) -> Tensor:
    _check(s, t)
    s, t = _rows(s), _rows(t)
    g = g.float().contiguous()
    B, E = s.shape
    gs = torch.empty((B, E), dtype=s.dtype, device=s.device)
    if B:
        geo = _geometry(s, t)
        _launch(_fns()[1], "emb_dist_bwd", s.device, s.data_ptr(),
                t.data_ptr(), g.data_ptr(), gs.data_ptr(), B, E, s.stride(0),
                t.stride(0), E, DTYPES[s.dtype], DTYPES[t.dtype], geo.vec,
                geo.warps_per_row, geo.threads, EPS)
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
