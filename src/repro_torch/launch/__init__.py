"""repro_torch.launch — launchers (port of ``repro.launch``).

  gossip.py   one OS process per client over TCP (`launch_gossip`), each
              on the card unless the caller passes ``device="cpu"``.

The reference's mesh, sharding, dry-run, train and serve launchers are
ROADMAP Queue 1 items 14 and 15.
"""
from __future__ import annotations

from repro_torch.launch.gossip import (
    delivery_gaps,
    fleet_summary,
    launch_gossip,
)

__all__ = ["delivery_gaps", "fleet_summary", "launch_gossip"]
