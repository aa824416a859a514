"""Mamba2 SSD scan: the CUDA kernels' wrappers, the autograd Function
around them, and the plain PyTorch version.

Port of ``repro/kernels/ssd_scan.py:ssd_scan`` (the Pallas TPU kernel). The
kernels are ``csrc/ssd_scan.cu`` (CUDA C++ for sm_90a, loaded with
ctypes); see its header for the design and the bound on the H100. Per
(batch, head), with the state h (P × N) carried along the sequence:

    h_t = exp(dt_t A) h_{t−1} + dt_t x_t B_tᵀ,    y_t = h_t C_t + D x_t

x (Bt, T, H, P), dt (Bt, T, H), A and D (H,), B and C (Bt, T, N) shared by
the heads → (y (Bt, T, H, P), final state (Bt, H, P, N) f32).

``ssd_scan(x, dt, A, B, C, D, chunk)``: a CUDA tensor launches the kernels
(the forward, and the backward when autograd needs it), a CPU tensor takes
`ssd_scan_plain`, a meta tensor gets empty outputs and gradients. Under a
cost counter the forward and the backward are one entry each, of
`cost_fwd` and `cost_bwd` (`kernels/counted.py`). The TPU kernel has no
backward (the reference trains by
differentiating the jnp ``ssd_chunked``); the port's forward kernel saves
the state entering each of its chunks, and a second kernel runs the chunks
in reverse from them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import counted
from repro_torch.kernels.build import LaunchCounter, cuda_library
from repro_torch.roofline import op_cost

Tensor = torch.Tensor

FWD_COUNTER = LaunchCounter("ssd_scan_fwd")
BWD_COUNTER = LaunchCounter("ssd_scan_bwd")
_SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"
_REPLACES = "src/repro/kernels/ssd_scan.py:88"
INFO_FWD = {"name": "ssd_scan_fwd", "route": "cuda", "source": _SOURCE,
            "replaces": _REPLACES}
INFO_BWD = {"name": "ssd_scan_bwd", "route": "cuda", "source": _SOURCE,
            "replaces": _REPLACES}


# the kernels' chunk length and largest P and N (ssd_scan_chunk(),
# ssd_scan_max_p(), ssd_scan_max_n())
CHUNK, MAX_P, MAX_N = 64, 64, 128


# ---------------------------------------------------------------------------
# the kernels' cost
# ---------------------------------------------------------------------------

def _io(Bt, T, H, P, N):
    """Bytes of the inputs (x, dt, A, B, C, D) and of one state, f32."""
    return (4 * (2 * Bt * T * N + Bt * T * H * P + Bt * T * H + 2 * H),
            4 * Bt * H * P * N)


def cost_fwd(Bt, T, H, P, N, save_states: bool = False):
    """(FLOPs by type, bytes) of the forward: every input read once, y and
    the final state written (and the state entering each chunk when the
    training call saves them). Operations: the products the function needs
    at the kernel's chunk length L, per (row b, chunk): B and C are shared
    by the heads, so C·Bᵀ (tri·N multiply-adds) once, not once per head;
    per head the masked product with x (tri·P), C·h and the state update
    (L·N·P each); on 3×TF32."""
    L, nc = CHUNK, -(-T // CHUNK)
    io_in, state_b = _io(Bt, T, H, P, N)
    tri = L * (L + 1) / 2
    rows, heads = Bt * nc, Bt * nc * H
    flops = 2 * rows * tri * N + 2 * heads * (tri * P + 2 * L * N * P)
    nbytes = io_in + 4 * Bt * T * H * P + state_b
    if save_states:
        nbytes += nc * state_b
    return {"tf32x3": float(flops)}, float(nbytes)


def cost_bwd(Bt, T, H, P, N):
    """The backward: the inputs, dy and the chunk states read; dx, ddt, dB,
    dC, dA and dD written. Operations: C·Bᵀ again, and dC = dCB·B and
    dB = dCBᵀ·C once on the head-summed dCB (its tri·H additions); per head
    dx and dCB from the masked product (2·tri·P) and the four state
    products (4·L·N·P). What the kernel does beyond that (dB and dC per
    head) belongs to its design, not to the function."""
    L, nc = CHUNK, -(-T // CHUNK)
    io_in, state_b = _io(Bt, T, H, P, N)
    tri = L * (L + 1) / 2
    rows, heads = Bt * nc, Bt * nc * H
    flops = (2 * rows * 3 * tri * N + rows * tri * H
             + 2 * heads * (2 * tri * P + 4 * L * N * P))
    nbytes = (io_in + 4 * Bt * T * H * P + nc * state_b
              + 4 * (Bt * T * H * P + Bt * T * H + 2 * Bt * T * N + 2 * H))
    return {"tf32x3": float(flops)}, float(nbytes)


# ---------------------------------------------------------------------------
# plain versions (models/ssm.py's ssd_chunked and ssd_reference)
# ---------------------------------------------------------------------------

def _acc_dtype(x: Tensor) -> torch.dtype:
    """float32 for f32/bf16/f16 inputs; float64 stays float64 (an oracle)."""
    return torch.promote_types(x.dtype, torch.float32)


def ssd_chunked_plain(x, dt, A, B, C, D, chunk_size: int
                      ) -> Tuple[Tensor, Tensor]:
    """Chunked SSD, T a multiple of ``chunk_size``: dense (L × L) masked
    products inside a chunk, the state carried across chunks."""
    Bt, T, H, P = x.shape
    N = B.shape[-1]
    L = chunk_size
    nc = T // L
    acc = _acc_dtype(x)
    xs = x.to(acc).reshape(Bt, nc, L, H, P)
    dts = dt.to(acc).reshape(Bt, nc, L, H)
    Bs = B.to(acc).reshape(Bt, nc, L, N)
    Cs = C.to(acc).reshape(Bt, nc, L, N)
    A, D = A.to(acc), D.to(acc)

    a = dts * A[None, None, None, :]
    s = torch.cumsum(a, dim=2)
    total = s[:, :, -1, :]  # (Bt, nc, H)

    CB = torch.einsum("bcln,bcmn->bclm", Cs, Bs)
    seg = s[:, :, :, None, :] - s[:, :, None, :, :]  # (Bt, nc, L, L, H)
    tri = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    tri = tri[None, None, :, :, None]
    # mask BEFORE exp: the upper triangle of seg is positive and overflows,
    # and a gradient through where() of an inf is NaN
    gate = torch.where(tri, torch.exp(torch.where(tri, seg,
                                                  torch.zeros_like(seg))),
                       torch.zeros_like(seg))
    M = CB[..., None] * gate * dts[:, :, None, :, :]
    y_intra = torch.einsum("bclmh,bcmhp->bclhp", M, xs)

    w = torch.exp(total[:, :, None, :] - s) * dts  # (Bt, nc, L, H)
    G = torch.einsum("bclh,bcln,bclhp->bchpn", w, Bs, xs)

    h = x.new_zeros((Bt, H, P, N), dtype=acc)
    starts = []
    for c in range(nc):
        starts.append(h)
        h = h * torch.exp(total[:, c])[:, :, None, None] + G[:, c]
    h_starts = torch.stack(starts, dim=1)  # (Bt, nc, H, P, N)

    y_inter = torch.einsum("bcln,bclh,bchpn->bclhp", Cs, torch.exp(s),
                           h_starts)
    y = (y_intra + y_inter).reshape(Bt, T, H, P)
    y = y + x.to(acc) * D[None, None, :, None]
    return y.to(x.dtype), h


def ssd_reference_plain(x, dt, A, B, C, D) -> Tuple[Tensor, Tensor]:
    """The sequential recurrence, one step per position."""
    Bt, T, H, P = x.shape
    N = B.shape[-1]
    acc = _acc_dtype(x)
    xf, dtf, Bf, Cf = (t.to(acc) for t in (x, dt, B, C))
    A, D = A.to(acc), D.to(acc)
    decay = torch.exp(dtf * A[None, None, :])
    h = x.new_zeros((Bt, H, P, N), dtype=acc)
    ys = []
    for t in range(T):
        h = h * decay[:, t, :, None, None] + (
            (dtf[:, t, :, None] * xf[:, t])[..., None]
            * Bf[:, t, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cf[:, t]))
    y = torch.stack(ys, dim=1) + xf * D[None, None, :, None]
    return y.to(x.dtype), h


def ssd_scan_plain(x, dt, A, B, C, D, chunk_size: int
                   ) -> Tuple[Tensor, Tensor]:
    """The chunked math when T is a multiple of ``chunk_size``, the
    sequential recurrence otherwise — ``mamba2_apply``'s choice. The CPU
    path, and the oracle the kernels are held against on the card."""
    if x.shape[1] % chunk_size == 0:
        return ssd_chunked_plain(x, dt, A, B, C, D, chunk_size)
    return ssd_reference_plain(x, dt, A, B, C, D)


def ssd_chunk_states_plain(x, dt, A, B, C, D, chunk: int = 64) -> Tensor:
    """The state entering each chunk of ``chunk`` steps, (Bt, H, ceil(T /
    chunk), P, N): zero, then the final state of `ssd_scan_plain` on each
    prefix of ``chunk``·c steps. What the forward kernel saves for the
    backward, at its own chunk length (64)."""
    Bt, T, H, P = x.shape
    N = B.shape[-1]
    nc = -(-T // chunk)
    states = [x.new_zeros((Bt, H, P, N), dtype=_acc_dtype(x))]
    for c in range(1, nc):
        t = c * chunk
        states.append(ssd_scan_plain(x[:, :t], dt[:, :t], A, B[:, :t],
                                     C[:, :t], D, chunk)[1])
    return torch.stack(states, dim=2)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_library("ssd_scan")
    lib.ssd_scan_fwd_f32.argtypes = [_P] * 10 + [_I] * 5 + [_P]
    lib.ssd_scan_fwd_f32.restype = _I
    lib.ssd_scan_bwd_f32.argtypes = [_P] * 16 + [_I] * 5 + [_P]
    lib.ssd_scan_bwd_f32.restype = _I
    lib.ssd_scan_fwd_scratch_floats.argtypes = [_I] * 3
    lib.ssd_scan_fwd_scratch_floats.restype = ctypes.c_longlong
    for fn in (lib.ssd_scan_chunk, lib.ssd_scan_max_p, lib.ssd_scan_max_n):
        fn.argtypes = []
        fn.restype = _I
    return lib


def kernel_chunk() -> int:
    """The kernel's own chunk length (64)."""
    return int(_lib().ssd_scan_chunk())


def _check(x, dt, A, B, C, D, device: str = "cuda"
           ) -> Tuple[int, int, int, int, int]:
    """The kernels' contract (a meta call checks what the card would
    refuse)."""
    ts = (x, dt, A, B, C, D)
    if not all(t.device.type == device for t in ts):
        where = "CUDA" if device == "cuda" else device
        raise ValueError(f"ssd_scan kernel takes {where} tensors")
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError(f"ssd_scan kernel takes float32, got "
                         f"{[t.dtype for t in ts]}")
    if x.dim() != 4:
        raise ValueError(f"x must be (Bt, T, H, P), got {tuple(x.shape)}")
    Bt, T, H, P = x.shape
    N = B.shape[-1]
    if dt.shape != (Bt, T, H) or A.shape != (H,) or D.shape != (H,) or \
            B.shape != (Bt, T, N) or C.shape != (Bt, T, N):
        raise ValueError(
            f"ssd_scan shapes: x {tuple(x.shape)} dt {tuple(dt.shape)} "
            f"A {tuple(A.shape)} B {tuple(B.shape)} C {tuple(C.shape)} "
            f"D {tuple(D.shape)}")
    if device == "cuda":
        max_p, max_n = _lib().ssd_scan_max_p(), _lib().ssd_scan_max_n()
    else:
        max_p, max_n = MAX_P, MAX_N
    if P > max_p or N > max_n:
        raise ValueError(f"ssd_scan kernel takes P <= {max_p} and N <= "
                         f"{max_n}, got P={P}, N={N}")
    return Bt, T, H, P, N


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def ssd_scan_fwd_kernel(x, dt, A, B, C, D, save_states: bool = False
                        ) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """Launch the forward kernels. Returns (y, final state, chunk-start
    states (Bt, H, ceil(T/64), P, N) or None)."""
    Bt, T, H, P, N = _check(x, dt, A, B, C, D)
    x, dt, A, B, C, D = (t.contiguous() for t in (x, dt, A, B, C, D))
    dev = x.device
    y = torch.empty_like(x)
    fin = torch.empty((Bt, H, P, N), dtype=torch.float32, device=dev)
    states = None
    if save_states:
        nc = -(-T // kernel_chunk())
        states = torch.empty((Bt, H, nc, P, N), dtype=torch.float32,
                             device=dev)
    lib = _lib()
    scratch = torch.empty(lib.ssd_scan_fwd_scratch_floats(Bt, T, H),
                          dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.ssd_scan_fwd_f32(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), y.data_ptr(), fin.data_ptr(),
            states.data_ptr() if states is not None else None,
            scratch.data_ptr(), Bt, T, H, P, N, _stream(dev))
    if err:
        raise RuntimeError(f"ssd_scan forward launch failed: cudaError {err}")
    FWD_COUNTER.bump()
    return y, fin, states


def ssd_scan_bwd_kernel(x, dt, A, B, C, D, states, dy, dfin=None):
    """Launch the backward kernels (the prep kernel again, then the
    backward scan). Returns (dx, ddt, dA, dB, dC, dD); the
    per-head partials of dB and dC and the per-batch partials of dA and dD
    are summed here, in a fixed order."""
    Bt, T, H, P, N = _check(x, dt, A, B, C, D)
    x, dt, A, B, C, D = (t.contiguous() for t in (x, dt, A, B, C, D))
    dy = dy.float().contiguous()
    if dfin is not None:
        dfin = dfin.float().contiguous()
    dev = x.device
    dx = torch.empty_like(x)
    ddt = torch.empty_like(dt)
    dA_part = torch.empty((Bt, H), dtype=torch.float32, device=dev)
    dD_part = torch.empty((Bt, H), dtype=torch.float32, device=dev)
    dB_part = torch.empty((Bt, H, T, N), dtype=torch.float32, device=dev)
    dC_part = torch.empty((Bt, H, T, N), dtype=torch.float32, device=dev)
    lib = _lib()
    scratch = torch.empty(lib.ssd_scan_fwd_scratch_floats(Bt, T, H),
                          dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.ssd_scan_bwd_f32(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), states.data_ptr(), dy.data_ptr(),
            dfin.data_ptr() if dfin is not None else None, dx.data_ptr(),
            ddt.data_ptr(), dA_part.data_ptr(), dB_part.data_ptr(),
            dC_part.data_ptr(), dD_part.data_ptr(), scratch.data_ptr(), Bt, T,
            H, P, N, _stream(dev))
    if err:
        raise RuntimeError(
            f"ssd_scan backward launch failed: cudaError {err}")
    BWD_COUNTER.bump()
    return (dx, ddt, dA_part.sum(0), dB_part.sum(1), dC_part.sum(1),
            dD_part.sum(0))


class SSDScan(torch.autograd.Function):
    """(y, final state) on the kernels, differentiable in every input."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D):
        with op_cost.kernel(INFO_FWD["name"], cost_fwd(
                *x.shape, B.shape[-1], save_states=True)):
            y, fin, states = ssd_scan_fwd_kernel(x, dt, A, B, C, D,
                                                 save_states=True)
        ctx.save_for_backward(x, dt, A, B, C, D, states)
        ctx.set_materialize_grads(False)
        return y, fin

    @staticmethod
    def backward(ctx, dy, dfin):
        x, dt, A, B, C, D, states = ctx.saved_tensors
        with op_cost.kernel(INFO_BWD["name"], cost_bwd(*x.shape,
                                                        B.shape[-1])):
            if dy is None:
                dy = torch.zeros_like(x)
            return ssd_scan_bwd_kernel(x, dt, A, B, C, D, states, dy, dfin)


def ssd_scan(x, dt, A, B, C, D, chunk_size: int) -> Tuple[Tensor, Tensor]:
    """(y (Bt, T, H, P), final state (Bt, H, P, N)). ``chunk_size`` is the
    model's: it picks the plain version's path on the CPU; the kernel uses
    its own chunk length, which changes only the rounding."""
    ts = (x, dt, A, B, C, D)
    train = torch.is_grad_enabled() and any(t.requires_grad for t in ts)
    if x.is_cuda:
        if train:
            return SSDScan.apply(*ts)
        with op_cost.kernel(INFO_FWD["name"], cost_fwd(*x.shape,
                                                        B.shape[-1])):
            y, fin, _ = ssd_scan_fwd_kernel(*ts)
        return y, fin
    if counted.counting_route(x):
        Bt, T, H, P, N = (*x.shape, B.shape[-1])
        costs = (cost_fwd(Bt, T, H, P, N, save_states=train),
                 cost_bwd(Bt, T, H, P, N))
        names = (INFO_FWD["name"], INFO_BWD["name"])
        if x.device.type == "meta":
            _check(*ts, device="meta")
            call = counted.Call(names, costs, lambda x, *_: (
                torch.empty_like(x), x.new_empty((Bt, H, P, N))),
                counted.empty_grads)
        else:
            def plain(*ts):
                return ssd_scan_plain(*ts, chunk_size)

            call = counted.Call(names, costs, plain,
                                counted.plain_grads(plain))
        return counted.run(call, *ts)
    if x.device.type != "cpu":
        raise ValueError(f"ssd_scan: no kernel for {x.device}")
    return ssd_scan_plain(x, dt, A, B, C, D, chunk_size)
