"""repro_torch.launch — launchers (port of ``repro.launch``).

  gossip.py   one OS process per client over TCP (`launch_gossip`), each
              on the card unless the caller passes ``device="cpu"``.
  serve.py    the serving launcher: ``python -m repro_torch.launch.serve``
              (a decode demo, or ``--preset serve_loop``; ``--device cpu``
              for the CPU).
  steps.py    the train step and the train state (`make_train_step`,
              `init_train_state`), the prefill and serve steps.
  train.py    the training launcher: ``python -m repro_torch.launch.train
              --mode supervised|mhd`` (``--device cpu`` for the CPU).

The reference's mesh, sharding and dry-run launchers,
``train_state_shapes`` and ``mhd_train_step`` are ROADMAP Queue 1 item 15.
"""
from __future__ import annotations

from repro_torch.launch.gossip import (
    delivery_gaps,
    fleet_summary,
    launch_gossip,
)

__all__ = ["delivery_gaps", "fleet_summary", "launch_gossip"]
