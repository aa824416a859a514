"""Triton kernels of the fused distillation cross-entropy (Hopper).

Replaces the Pallas TPU kernel ``repro/kernels/dist_ce.py:dist_ce``
(``pallas_call`` at dist_ce.py:107). Loaded from this file by
``repro_torch/kernels/build.py`` only when a kernel is launched.

Forward, one program per row: one streaming pass over blocks of V with an
online max and sum-exp for both sides, as the TPU kernel does across its
sequential grid axis; here the V loop runs inside the program, since
Hopper's blocks run in no order. Per row it writes

    ce     = (m_s + log Z_s) − a / Z_t,    a = Σ_v exp(t_v − m_t)·s_v
    t_conf = 1 / Z_t,   s_conf = 1 / Z_s   (the max softmax probability)

and the statistics (m_s, Z_s, m_t, Z_t) the backward needs.

Backward, one program per (row, block of V): ∂ce/∂s = g·(softmax(s) −
softmax(t)), rebuilt from the saved statistics; the teacher gets no
gradient. The TPU kernel has no backward.

Bound on the H100: bytes. The forward reads 2·B·V elements and writes
7·B floats; the backward reads 2·B·V and writes B·V. Each element is
loaded once and costs a handful of flops, far under the card's 295
flop-per-byte ridge.
"""
import triton
import triton.language as tl


@triton.jit
def dist_ce_fwd_kernel(s_ptr, t_ptr, ce_ptr, tconf_ptr, sconf_ptr, stats_ptr,
                       V, stride_s, stride_t, BLOCK_V: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    s_row = s_ptr + row * stride_s
    t_row = t_ptr + row * stride_t
    m_t = -1e30
    z_t = 0.0
    a = 0.0
    m_s = -1e30
    z_s = 0.0
    for off in range(0, V, BLOCK_V):
        cols = off + tl.arange(0, BLOCK_V)
        valid = cols < V
        s_raw = tl.load(s_row + cols, mask=valid, other=0.0).to(tl.float32)
        t_raw = tl.load(t_row + cols, mask=valid, other=0.0).to(tl.float32)
        s = tl.where(valid, s_raw, -1e30)
        t = tl.where(valid, t_raw, -1e30)
        # teacher online softmax + weighted sum of student logits
        mt_new = tl.maximum(m_t, tl.max(t, axis=0))
        scale = tl.exp(m_t - mt_new)
        e_t = tl.exp(t - mt_new)
        z_t = z_t * scale + tl.sum(e_t, axis=0)
        a = a * scale + tl.sum(e_t * s_raw, axis=0)
        m_t = mt_new
        # student online logsumexp
        ms_new = tl.maximum(m_s, tl.max(s, axis=0))
        z_s = z_s * tl.exp(m_s - ms_new) + tl.sum(tl.exp(s - ms_new), axis=0)
        m_s = ms_new
    tl.store(ce_ptr + row, m_s + tl.log(z_s) - a / z_t)
    tl.store(tconf_ptr + row, 1.0 / z_t)
    tl.store(sconf_ptr + row, 1.0 / z_s)
    tl.store(stats_ptr + row * 4 + 0, m_s)
    tl.store(stats_ptr + row * 4 + 1, z_s)
    tl.store(stats_ptr + row * 4 + 2, m_t)
    tl.store(stats_ptr + row * 4 + 3, z_t)


@triton.jit
def dist_ce_bwd_kernel(s_ptr, t_ptr, stats_ptr, g_ptr, gs_ptr, V, stride_s,
                       stride_t, stride_gs, BLOCK_V: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.program_id(1) * BLOCK_V + tl.arange(0, BLOCK_V)
    valid = cols < V
    s = tl.load(s_ptr + row * stride_s + cols, mask=valid,
                other=0.0).to(tl.float32)
    t = tl.load(t_ptr + row * stride_t + cols, mask=valid,
                other=0.0).to(tl.float32)
    m_s = tl.load(stats_ptr + row * 4 + 0)
    z_s = tl.load(stats_ptr + row * 4 + 1)
    m_t = tl.load(stats_ptr + row * 4 + 2)
    z_t = tl.load(stats_ptr + row * 4 + 3)
    g = tl.load(g_ptr + row)
    gs = g * (tl.exp(s - m_s) / z_s - tl.exp(t - m_t) / z_t)
    tl.store(gs_ptr + row * stride_gs + cols,
             gs.to(gs_ptr.dtype.element_ty), mask=valid)
