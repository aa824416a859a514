"""Roofline terms from a counted step (port of
``repro/roofline/analysis.py``).

The counts are per card (`op_cost.OpCounter`), so:

    compute term    = Σ_type device_flops_type / peak_type
    memory term     = device_bytes / hbm_bw
    collective term = device_collective_bytes / ici_bw

The reference has one ``peak_flops``; the port's FLOPs carry their type
(f32 GEMMs with TF32 off, the hand kernels' 3×TF32, bf16), each at its own
peak. A count without types (``flops`` alone) is priced at ``peak_flops``,
the f32 rate, as the reference prices its one count. The default card is
the H100 SXM 80GB HBM3 at 700 W (NVIDIA's data sheet, dense rates).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch.roofline.op_cost import FLOP_TYPES


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str = "h100-sxm-80gb-hbm3"
    peak_flops: float = 67e12  # f32 FLOP/s, no tensor cores
    hbm_bw: float = 3.35e12  # bytes/s
    ici_bw: float = 450e9  # bytes/s a direction, NVLink 4
    hbm_bytes: float = 80e9
    peak_tf32: float = 495e12  # TF32 tensor-core FLOP/s
    peak_bf16: float = 989e12  # bf16 tensor-core FLOP/s

    @property
    def peaks(self) -> Dict[str, float]:
        """FLOP/s of each counted type: a 3×TF32 FLOP is three TF32
        products."""
        return {"f32": self.peak_flops, "tf32x3": self.peak_tf32 / 3,
                "bf16": self.peak_bf16}

    def compute_s(self, cost: Dict[str, float]) -> float:
        """Σ flops_type / peak_type, or flops / peak_flops for an untyped
        count."""
        typed = {k: cost[f"flops_{k}"] for k in FLOP_TYPES
                 if f"flops_{k}" in cost}
        if not typed:
            return float(cost.get("flops", 0.0)) / self.peak_flops
        return sum(float(f) / self.peaks[k] for k, f in typed.items())

    def attainable_flops_per_s(self, cost: Dict[str, float]) -> float:
        """The roofline's rate for this mix: min(typed peak, hbm_bw ·
        intensity), i.e. flops over the larger of the two terms."""
        t = max(self.compute_s(cost), float(cost.get("bytes", 0.0))
                / self.hbm_bw)
        return float(cost.get("flops", 0.0)) / t if t else 0.0


H100 = HardwareSpec()


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    device_flops: float
    device_bytes: float
    device_collective_bytes: float
    model_flops_global: float
    useful_flops_ratio: float  # MODEL_FLOPS / (device_flops * chips)
    device_arg_bytes: float  # params + optimizer state + inputs
    device_temp_bytes: float
    fits_hbm: bool
    note: str = ""

    def to_row(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def active_params(cfg, total_params: int) -> int:
    """Active parameter count (MoE: only top-k routed experts per token)."""
    moe = getattr(cfg, "moe", None)
    if moe is None or getattr(cfg, "family", "") not in ("moe",):
        return total_params
    # expert weights per MoE layer: 3 matrices (gate/up/down)
    n_moe_layers = 0
    for st in cfg.stages:
        for spec in st.block:
            if spec.ffn in ("moe", "moe_dense_parallel"):
                n_moe_layers += st.repeats
    per_expert = 3 * cfg.d_model * moe.d_ff_expert
    routed_total = n_moe_layers * moe.num_experts * per_expert
    routed_active = n_moe_layers * moe.top_k * per_expert
    return total_params - routed_total + routed_active


def model_flops(cfg, total_params: int, tokens: int, mode: str) -> float:
    """6·N·D (train) or 2·N·D (inference), N = active params."""
    n_active = active_params(cfg, total_params)
    mult = 6.0 if mode == "train" else 2.0
    return mult * n_active * tokens


def roofline_from_artifacts(
    arch: str,
    shape_name: str,
    mesh_name: str,
    chips: int,
    cost: Dict[str, float],
    collectives: Dict[str, int],
    memory: Optional[Dict[str, float]],
    cfg,
    total_params: int,
    tokens: int,
    mode: str,
    hw: HardwareSpec = H100,
    note: str = "",
) -> RooflineReport:
    flops = float(cost.get("flops", 0.0))
    bytes_acc = float(cost.get("bytes accessed", 0.0))
    coll = float(collectives.get("total", 0))

    compute_s = hw.compute_s(cost)
    memory_s = bytes_acc / hw.hbm_bw
    collective_s = coll / hw.ici_bw
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)

    mf = model_flops(cfg, total_params, tokens, mode)
    global_flops = flops * chips
    ratio = mf / global_flops if global_flops else 0.0

    arg_b = float(memory.get("argument_size_in_bytes", 0)) if memory else 0.0
    tmp_b = float(memory.get("temp_size_in_bytes", 0)) if memory else 0.0
    out_b = float(memory.get("output_size_in_bytes", 0)) if memory else 0.0
    fits = (arg_b + tmp_b + out_b) <= hw.hbm_bytes

    return RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_name,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant,
        device_flops=flops, device_bytes=bytes_acc,
        device_collective_bytes=coll,
        model_flops_global=mf, useful_flops_ratio=ratio,
        device_arg_bytes=arg_b, device_temp_bytes=tmp_b,
        fits_hbm=fits, note=note,
    )


def format_table(reports) -> str:
    hdr = (f"{'arch':<22} {'shape':<12} {'mesh':<9} {'compute_s':>10} "
           f"{'memory_s':>10} {'coll_s':>10} {'dominant':>10} "
           f"{'6ND/HLO':>8} {'fits':>5}")
    lines = [hdr, "-" * len(hdr)]
    for r in reports:
        lines.append(
            f"{r.arch:<22} {r.shape:<12} {r.mesh:<9} {r.compute_s:>10.4f} "
            f"{r.memory_s:>10.4f} {r.collective_s:>10.4f} {r.dominant:>10} "
            f"{r.useful_flops_ratio:>8.3f} {str(r.fits_hbm):>5}")
    return "\n".join(lines)
