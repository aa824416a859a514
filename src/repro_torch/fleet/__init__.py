"""repro_torch.fleet — the elastic fleet runtime (port of
``repro.fleet``):

  * `snapshot` — versioned full-fleet snapshots (params + opt state,
    scheduler clocks, bus mailboxes + per-client clocks, comm-meter
    books, data-stream positions, pool rngs and windows, in-process
    transport in-flight) with per-client and per-process restore units,
    in the reference's npz layout;
  * `events` — a scripted churn timeline (kill / restart / join /
    rewire) and the `ChurnDriver` that applies it to a live trainer;
  * `membership` — the passive view of that timeline: liveness,
    configuration epochs, and the dynamic graph the bus and trainer
    consult.
"""
from repro_torch.fleet.events import (
    ChurnDriver,
    ChurnEvent,
    Join,
    Kill,
    Restart,
    Rewire,
    events_from_spec,
)
from repro_torch.fleet.membership import Membership
from repro_torch.fleet.snapshot import (
    SNAPSHOT_VERSION,
    latest_step,
    load_client_params,
    restore_clients,
    restore_fleet,
    save_fleet,
    snapshot_steps,
)

__all__ = [
    "ChurnDriver",
    "ChurnEvent",
    "Join",
    "Kill",
    "Membership",
    "Restart",
    "Rewire",
    "SNAPSHOT_VERSION",
    "events_from_spec",
    "latest_step",
    "load_client_params",
    "restore_clients",
    "restore_fleet",
    "save_fleet",
    "snapshot_steps",
]
