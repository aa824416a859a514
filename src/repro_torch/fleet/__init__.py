"""repro_torch.fleet — the churn timeline and its passive membership view
(copies of ``repro.fleet.events`` / ``repro.fleet.membership``), which the
experiment API validates a spec's `ChurnSpec` against. Fleet snapshots and
``ChurnDriver``, which applies churn to a live trainer, are not ported
yet."""
from repro_torch.fleet.events import (
    ChurnEvent,
    Join,
    Kill,
    Restart,
    Rewire,
    events_from_spec,
)
from repro_torch.fleet.membership import Membership

__all__ = [
    "ChurnEvent",
    "Join",
    "Kill",
    "Membership",
    "Restart",
    "Rewire",
    "events_from_spec",
]
