"""Triton kernels of the normalized embedding distance, Eq. 2 (Hopper).

Replaces the Pallas TPU kernel ``repro/kernels/emb_dist.py:emb_dist``
(``pallas_call`` at emb_dist.py:39). Loaded from this file by
``repro_torch/kernels/build.py`` only when a kernel is launched.

One program per row holds the whole row (E ≤ 8192, padded to a power of
two) in registers, as the TPU kernel holds one block along E:

    out = ‖s/(‖s‖+ε) − t/(‖t‖+ε)‖²,  ε = 1e-8.

The backward (the TPU kernel has none) is a kernel on s only: with
n = ‖s‖, u = s/(n+ε), w = t/(‖t‖+ε) and r = 2(u − w),

    ∂out/∂s = g·( r/(n+ε) − s·(s·r) / ((n+ε)²·n) ),

whose second term is 0 at n = 0.

Bound on the H100: bytes. Forward reads 2·B·E elements and writes B
floats; backward reads 2·B·E and writes B·E.
"""
import triton
import triton.language as tl


@triton.jit
def emb_dist_fwd_kernel(s_ptr, t_ptr, out_ptr, E, stride_s, stride_t, eps,
                        BLOCK_E: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK_E)
    valid = cols < E
    s = tl.load(s_ptr + row * stride_s + cols, mask=valid,
                other=0.0).to(tl.float32)
    t = tl.load(t_ptr + row * stride_t + cols, mask=valid,
                other=0.0).to(tl.float32)
    ns = tl.sqrt(tl.sum(s * s, axis=0))
    nt = tl.sqrt(tl.sum(t * t, axis=0))
    d = s / (ns + eps) - t / (nt + eps)
    tl.store(out_ptr + row, tl.sum(d * d, axis=0))


@triton.jit
def emb_dist_bwd_kernel(s_ptr, t_ptr, g_ptr, gs_ptr, E, stride_s, stride_t,
                        stride_gs, eps, BLOCK_E: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK_E)
    valid = cols < E
    s = tl.load(s_ptr + row * stride_s + cols, mask=valid,
                other=0.0).to(tl.float32)
    t = tl.load(t_ptr + row * stride_t + cols, mask=valid,
                other=0.0).to(tl.float32)
    n = tl.sqrt(tl.sum(s * s, axis=0))
    nt = tl.sqrt(tl.sum(t * t, axis=0))
    r = 2.0 * (s / (n + eps) - t / (nt + eps))
    sr = tl.sum(s * r, axis=0)
    coef = tl.where(n > 0.0, sr / ((n + eps) * (n + eps) * n), 0.0)
    g = tl.load(g_ptr + row)
    gs = g * (r / (n + eps) - s * coef)
    tl.store(gs_ptr + row * stride_gs + cols,
             gs.to(gs_ptr.dtype.element_ty), mask=valid)
