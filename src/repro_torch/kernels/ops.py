"""Dispatch over the port's Hopper kernels (``repro/kernels/ops.py``).

Dispatch is by the device of the tensor given, with no option and no
fallback: a CUDA tensor launches the kernel, or raises if the kernel
cannot build or launch; a CPU tensor takes the plain PyTorch version.

  dist_ce          Triton (csrc/dist_ce_triton.py), forward + backward
  emb_dist         Triton (csrc/emb_dist_triton.py), forward + backward
  topk_wire        CUDA C++ (csrc/topk_wire.cu)
  topk_wire_frame  topk_wire plus the wire epilogue in PyTorch ops

`KERNELS` lists each kernel with its launch counter, so a run can set the
counts to 0, drive a path and read which kernels it went through.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import dist_ce as _dce
from repro_torch.kernels import emb_dist as _emb
from repro_torch.kernels import topk_wire as _topk
from repro_torch.kernels.dist_ce import dist_ce
from repro_torch.kernels.emb_dist import emb_dist
from repro_torch.kernels.topk_wire import topk_wire

Tensor = torch.Tensor

# (metadata, counter) of every kernel the port launches
KERNELS = (
    (_topk.INFO, _topk.COUNTER),
    (_dce.INFO_FWD, _dce.FWD_COUNTER),
    (_dce.INFO_BWD, _dce.BWD_COUNTER),
    (_emb.INFO_FWD, _emb.FWD_COUNTER),
    (_emb.INFO_BWD, _emb.BWD_COUNTER),
)


def launch_counts() -> Dict[str, int]:
    return {info["name"]: c.launches for info, c in KERNELS}


def reset_launch_counts() -> None:
    for _, c in KERNELS:
        c.reset()


def topk_wire_frame(heads: Tensor, emb: Optional[Tensor], k: int, *,
                    val_dtype: str = "float16", emb_encoding: str = "int8"
                    ) -> Tuple[Dict[str, Tensor], Tensor]:
    """Fused wire-frame encode from stacked head logits (W, H, B, C): the
    top-k kernel, the f16 value cast, the f32 logsumexp, int8 embedding
    quantization and the codec's finiteness flag, all on the tensors'
    device. Returns (arrays, finite) with ``idx`` as int32 — the codec
    narrows it to u16/u32 on the host. ``emb=None`` skips the embedding
    lane.

    The int8 lane is the bit-for-bit twin of ``wire.quantize_emb_int8``:
    scale = amax / 127 + 1e-30 as a true IEEE division (the divisor is a
    tensor: PyTorch turns division by a host scalar into a reciprocal
    multiply on CUDA, 1 ulp off numpy), round half to even, clip ±127."""
    W, H, B, C = heads.shape
    flat = heads.float().reshape(W * H * B, C)
    vals, idx, lse = topk_wire(flat, k)
    wire_vals = vals.reshape(W, H, B, k).to(
        torch.float16 if val_dtype == "float16" else torch.float32)
    arrays = {"vals": wire_vals, "idx": idx.reshape(W, H, B, k),
              "lse": lse.reshape(W, H, B)}
    finite = torch.isfinite(heads).all() & \
        torch.isfinite(wire_vals.float()).all()
    if emb is not None:
        emb32 = emb.float()
        finite = finite & torch.isfinite(emb32).all()
        if emb_encoding == "int8":
            amax = emb32.abs().amax(dim=-1)
            scale = amax / torch.full_like(amax, 127.0) + 1e-30
            arrays["emb_q"] = torch.clamp(
                torch.round(emb32 / scale[..., None]), -127, 127
            ).to(torch.int8)
            arrays["emb_scale"] = scale
        else:
            arrays["embedding"] = emb32
    return arrays, finite


__all__ = ["KERNELS", "dist_ce", "emb_dist", "launch_counts",
           "reset_launch_counts", "topk_wire", "topk_wire_frame"]
