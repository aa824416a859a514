"""Dispatch over the port's Hopper kernels (``repro/kernels/ops.py``).

Dispatch is by the device of the tensor given, with no option and no
fallback: a CUDA tensor launches the kernel, or raises if the kernel
cannot build or launch; a CPU tensor takes the plain PyTorch version; a
meta tensor (the dry run, the roofline's counts) gets outputs of the
kernel's shapes and dtypes, checked against the kernel's contract, and
nothing is computed. Under a cost counter (`roofline.op_cost`) every call,
on any device, is one entry of its kernel module's ``cost`` for each of
its forward and backward (`kernels/counted.py` on meta and on the CPU).

  dist_ce          Triton (csrc/dist_ce_triton.py), forward + backward
  emb_dist         CUDA C++ (csrc/emb_dist.cu), forward + backward
  flash_attention  CUDA C++ (csrc/flash_attention.cu), forward + backward
  ssd_scan         CUDA C++ (csrc/ssd_scan.cu), forward + backward
  topk_wire        CUDA C++ (csrc/topk_wire.cu)
  topk_wire_frame  topk_wire plus the wire epilogue in PyTorch ops
  adaptive_topk_wire_frame
                   topk_wire plus the entropy-weighted budget allocation
                   and the wire epilogue in PyTorch ops

`KERNELS` lists each kernel with its launch counter, so a run can set the
counts to 0, drive a path and read which kernels it went through.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import dist_ce as _dce
from repro_torch.kernels import emb_dist as _emb
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import topk_wire as _topk
from repro_torch.kernels.dist_ce import dist_ce
from repro_torch.kernels.emb_dist import emb_dist
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels.topk_wire import topk_wire

Tensor = torch.Tensor

# (metadata, counter) of every kernel the port launches
KERNELS = (
    (_topk.INFO, _topk.COUNTER),
    (_dce.INFO_FWD, _dce.FWD_COUNTER),
    (_dce.INFO_BWD, _dce.BWD_COUNTER),
    (_emb.INFO_FWD, _emb.FWD_COUNTER),
    (_emb.INFO_BWD, _emb.BWD_COUNTER),
    (_ssd.INFO_FWD, _ssd.FWD_COUNTER),
    (_ssd.INFO_BWD, _ssd.BWD_COUNTER),
    (_fa.INFO_FWD, _fa.FWD_COUNTER),
    (_fa.INFO_BWD, _fa.BWD_COUNTER),
)


def launch_counts() -> Dict[str, int]:
    return {info["name"]: c.launches for info, c in KERNELS}


def reset_launch_counts() -> None:
    for _, c in KERNELS:
        c.reset()


def _emb_lane(arrays: Dict[str, Tensor], finite: Tensor,
              emb: Optional[Tensor], emb_encoding: str) -> Tensor:
    """The embedding lane of a frame (int8 or f32), and the finiteness flag
    with the embedding folded in."""
    if emb is None:
        return finite
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
    return finite


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
    return arrays, _emb_lane(arrays, finite, emb, emb_encoding)


def adaptive_topk_wire_frame(heads: Tensor, emb: Optional[Tensor], k: int,
                             *, k_min: int = 1,
                             budget_bytes_per_token: int = 0,
                             entry_bytes: int = 6,
                             val_dtype: str = "float16",
                             emb_encoding: str = "int8"
                             ) -> Tuple[Dict[str, Tensor], Tensor]:
    """Entropy-adaptive frame encode (``repro/kernels/ops.py:
    adaptive_topk_wire_frame``), on the tensors' device: the rectangular
    top-k frame at the codec's k ceiling (the ``topk_wire`` kernel), and
    the retention plan ``k_per_token`` (W, B) u16 — how many of the k
    entries each token puts on the wire, entropy-weighted under
    ``budget_bytes_per_token`` with a ``k_min`` floor.

    The allocation follows the reference's f32 operations in order: the
    main head's entropy H = −Σ p·(x − lse) in f32, the integer budget
    K_total = budget·N // (H·entry), quotas floor(float32(R)·w / Σw), and
    the leftover entries one each to the largest fractional parts, ranked
    by a stable argsort (ties by token order); each k is clipped to
    [k_min, k]. Returns (arrays, finite) with ``idx`` as int32."""
    W, H, B, C = heads.shape
    flat = heads.float().reshape(W * H * B, C)
    vals, idx, lse = topk_wire(flat, k)
    wire_vals = vals.reshape(W, H, B, k).to(
        torch.float16 if val_dtype == "float16" else torch.float32)
    lse3 = lse.reshape(W, H, B)

    # per-token entropy of the main head, in nats
    xs = heads[:, 0].float() - lse3[:, 0][..., None]  # (W, B, C)
    ent = -(torch.exp(xs) * xs).sum(dim=-1)

    N = W * B
    K_total = (budget_bytes_per_token * N) // (H * entry_bytes)
    R = max(K_total - N * k_min, 0)
    ent_flat = torch.clamp(ent.reshape(N), min=0.0)
    if R == 0:
        # budget exhausted (or exactly the floor): every token still gets
        # k_min — never less than the top-1 prediction
        k_tok = torch.full((N,), k_min, dtype=torch.int32,
                           device=heads.device)
    else:
        s = ent_flat.sum()
        pos = s > 0
        w = torch.where(pos, ent_flat, torch.ones_like(ent_flat))
        sw = torch.where(pos, s, torch.full_like(s, float(N)))
        quota_f = torch.full_like(w, float(R)) * w / sw
        fl = torch.floor(quota_f)
        quota = fl.to(torch.int32)
        rem = torch.clamp(R - quota.sum(), min=0)
        order = torch.argsort(-(quota_f - fl), stable=True)
        rank = torch.empty_like(order)
        rank[order] = torch.arange(N, device=heads.device)
        bonus = (rank < rem).to(torch.int32)
        k_tok = torch.clamp(k_min + quota + bonus, k_min, k)
    arrays = {"vals": wire_vals, "idx": idx.reshape(W, H, B, k),
              "lse": lse3,
              "k_per_token": k_tok.reshape(W, B).to(torch.int32)}
    # finiteness of the inputs and of the wire cast, over the whole
    # k-rectangle (entries beyond a token's k never travel, but a
    # non-finite teacher is refused as a whole, as by the fixed codecs)
    finite = torch.isfinite(heads).all() & \
        torch.isfinite(wire_vals.float()).all()
    return arrays, _emb_lane(arrays, finite, emb, emb_encoding)


__all__ = ["KERNELS", "adaptive_topk_wire_frame", "dist_ce", "emb_dist",
           "flash_attention", "launch_counts", "reset_launch_counts",
           "ssd_scan", "topk_wire", "topk_wire_frame"]
