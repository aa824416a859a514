"""repro_torch.roofline — cost counting and the roofline on one card (port
of ``repro.roofline``).

  op_cost.py   `OpCounter`: a step's FLOPs by type, bytes, peak memory and
               collective bytes, counted by a dispatch mode (on the meta
               device, with no card); stands for the reference's
               ``hlo_cost.py`` and ``hlo_parse.py``.
  analysis.py  `HardwareSpec` (the H100 by default), `RooflineReport`,
               `active_params`, `model_flops`, `roofline_from_artifacts`,
               `format_table`.
"""
from repro_torch.roofline.analysis import (
    H100,
    HardwareSpec,
    RooflineReport,
    active_params,
    format_table,
    model_flops,
    roofline_from_artifacts,
)
from repro_torch.roofline.op_cost import OpCounter, count

__all__ = [
    "H100",
    "HardwareSpec",
    "OpCounter",
    "RooflineReport",
    "active_params",
    "count",
    "format_table",
    "model_flops",
    "roofline_from_artifacts",
]
