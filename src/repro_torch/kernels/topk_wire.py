"""Top-k wire-format packing: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of ``repro/kernels/topk_wire.py:topk_wire`` (the Pallas TPU kernel).
The kernel is ``csrc/topk_wire.cu`` (CUDA C++ for sm_90a, loaded with
ctypes); see its header for the design and its bound on the H100.

``topk_wire(logits, k)`` maps (B, V) to (vals (B, k) f32, idx (B, k) i32,
lse (B,) f32): a CUDA tensor launches the kernel (or raises), a CPU tensor
takes `topk_wire_plain`. A tie goes to the lowest column, as in the
reference's kernel and ``lax.top_k``; ``torch.topk`` does not promise that,
so the plain version sorts stably instead.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels.build import LaunchCounter, cuda_library

Tensor = torch.Tensor

COUNTER = LaunchCounter("topk_wire")
INFO = {"name": "topk_wire", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/topk_wire.cu",
        "replaces": "src/repro/kernels/topk_wire.py:60"}


def topk_wire_plain(logits: Tensor, k: int) -> Tuple[Tensor, Tensor, Tensor]:
    """The same function in plain PyTorch ops (the CPU path and the
    oracle the kernel is held against on the card)."""
    x = logits.float()
    vals, order = torch.sort(x, dim=-1, descending=True, stable=True)
    m = x.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    lse = torch.log(torch.exp(x - m).sum(dim=-1)) + m[..., 0]
    return (vals[..., :k].contiguous(),
            order[..., :k].to(torch.int32).contiguous(), lse)


def _lib():
    lib = cuda_library("topk_wire")
    fn = lib.topk_wire_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def topk_wire_kernel(logits: Tensor, k: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Launch the CUDA kernel on a (B, V) CUDA tensor."""
    if not logits.is_cuda or logits.dim() != 2:
        raise ValueError(f"topk_wire kernel takes a 2-D CUDA tensor, got "
                         f"{tuple(logits.shape)} on {logits.device}")
    B, V = logits.shape
    if not 1 <= k <= V:
        raise ValueError(f"topk_wire needs 1 <= k <= V, got k={k}, V={V}")
    x = logits.float().contiguous()
    vals = torch.empty((B, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((B, k), dtype=torch.int32, device=x.device)
    lse = torch.empty((B,), dtype=torch.float32, device=x.device)
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                 lse.data_ptr(), B, V, k, stream)
    if err:
        raise RuntimeError(f"topk_wire kernel launch failed: cudaError {err}")
    COUNTER.bump()
    return vals, idx, lse


def topk_wire(logits: Tensor, k: int) -> Tuple[Tensor, Tensor, Tensor]:
    if logits.is_cuda:
        return topk_wire_kernel(logits, k)
    if logits.device.type != "cpu":
        raise ValueError(f"topk_wire: no kernel for {logits.device}")
    return topk_wire_plain(logits, k)
