"""repro_torch.launch — launchers (port of ``repro.launch``).

  dryrun.py   every (architecture × input shape) step counted on the
              meta device, no card: ``python -m
              repro_torch.launch.dryrun --arch … --shape …`` or ``--all``;
              ``--step mhd`` the pod step of one of two pods.
  gossip.py   one OS process per client over TCP (`launch_gossip`), each
              on the card unless the caller passes ``device="cpu"``.
  mesh.py     the production and test meshes (``DeviceMesh``es with the
              reference's axis names over the running process group).
  serve.py    the serving launcher: ``python -m repro_torch.launch.serve``
              (a decode demo, or ``--preset serve_loop``; ``--device cpu``
              for the CPU).
  shardings.py the reference's param / batch / cache sharding rules as
              pure functions over flat names; a leaf's blocks.
  steps.py    the train step and the train state (`make_train_step`,
              `init_train_state`, `train_state_shapes` on meta), the
              prefill and serve steps, `make_mhd_train_step`.
  train.py    the training launcher: ``python -m repro_torch.launch.train
              --mode supervised|mhd`` (``--device cpu`` for the CPU).

The reference's multi-pod meshes partition the dense layers within a pod
(tensor parallelism and FSDP): ROADMAP Queue 1 item 15c.
"""
from __future__ import annotations

from repro_torch.launch.gossip import (
    delivery_gaps,
    fleet_summary,
    launch_gossip,
)

__all__ = ["delivery_gaps", "fleet_summary", "launch_gossip"]
