"""repro_torch.launch — launchers (port of ``repro.launch``).

  dryrun.py   every (architecture × input shape) step counted on the
              meta device, no card: ``python -m
              repro_torch.launch.dryrun --arch … --shape …`` or ``--all``
              (one card), ``--multi-pod`` / ``--both-meshes`` (rank 0 of
              the 2×16×16 / 16×16 meshes under a fake group,
              ``--sharding tp|fsdp``); ``--step mhd`` the pod step of one
              of two pods on the 2×16×16 mesh.
  gossip.py   one OS process per client over TCP (`launch_gossip`), each
              on the card unless the caller passes ``device="cpu"``.
  mesh.py     the production and test meshes (``DeviceMesh``es with the
              reference's axis names over the running process group).
  serve.py    the serving launcher: ``python -m repro_torch.launch.serve``
              (a decode demo, or ``--preset serve_loop``; ``--device cpu``
              for the CPU).
  shardings.py the reference's param / batch / cache sharding rules as
              pure functions over flat names, its strategies
              (`apply_sharding_strategy`); a leaf's blocks.
  steps.py    the train step and the train state (`make_train_step`,
              `init_train_state`, `train_state_shapes` on meta), the
              prefill and serve steps, `make_mhd_train_step`; each runs
              per rank on its blocks under an active mesh.
  train.py    the training launcher: ``python -m repro_torch.launch.train
              --mode supervised|mhd`` (``--device cpu`` for the CPU).

Within a pod the steps partition every leaf by the reference's rules:
tensor parallelism over 'model' and FSDP over 'data' (``"tp"``), or the
'model' axis joining data parallelism (``"fsdp"``).
"""
from __future__ import annotations

from repro_torch.launch.gossip import (
    delivery_gaps,
    fleet_summary,
    launch_gossip,
)

__all__ = ["delivery_gaps", "fleet_summary", "launch_gossip"]
