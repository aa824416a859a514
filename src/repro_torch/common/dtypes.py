"""Mixed-precision policy (port of ``repro/common/dtypes.py``).

Params stored bf16 or f32, compute bf16, reductions f32 on the card's
bf16 policy; everything f32 by default (the CPU tests, the paths that
hold f32 parity).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    accum_dtype: torch.dtype = torch.float32

    @staticmethod
    def tpu_bf16() -> "DtypePolicy":
        """The reference's bf16 policy under its name: bf16 params and
        compute, f32 accumulation (the same on the card)."""
        return DtypePolicy(param_dtype=torch.bfloat16,
                           compute_dtype=torch.bfloat16,
                           accum_dtype=torch.float32)

    @staticmethod
    def fp32() -> "DtypePolicy":
        return DtypePolicy()

    def cast_compute(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)
