"""Scripted client-churn events (copy of the timeline half of
``repro/fleet/events.py``).

A churn *timeline* is a list of events — `Kill(client, step)`,
`Restart(client, step, from_snapshot)`, `Join(client, step, arch)`,
`Rewire(step, edges)` — in wall steps. `repro_torch.fleet.membership`
turns it into the passive view (who is alive when, which graph applies);
`repro_torch.exp` validates a spec's `ChurnSpec` through it.
``ChurnDriver``, which applies a timeline to a live trainer, needs the
trainer's fleet methods and the fleet snapshots, which the port does not
have yet: a churn timeline raises at the experiment's setup.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple, Union


@dataclasses.dataclass(frozen=True)
class Kill:
    client: int
    step: int


@dataclasses.dataclass(frozen=True)
class Restart:
    client: int
    step: int
    from_snapshot: bool = True


@dataclasses.dataclass(frozen=True)
class Join:
    client: int
    step: int
    arch: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class Rewire:
    step: int
    edges: Tuple[Tuple[int, ...], ...]


ChurnEvent = Union[Kill, Restart, Join, Rewire]

_KINDS = {"kill": Kill, "restart": Restart, "join": Join, "rewire": Rewire}


def events_from_spec(churn: Any) -> List[ChurnEvent]:
    """Build runtime events from a `repro_torch.exp.spec.ChurnSpec`-shaped
    object (duck-typed: ``.events`` of records with ``kind``/``step``/
    ``client``/``from_snapshot``/``arch``/``edges``) — `repro_torch.fleet`
    never imports `repro_torch.exp`."""
    out: List[ChurnEvent] = []
    for ev in churn.events:
        kind = ev.kind
        if kind == "kill":
            out.append(Kill(int(ev.client), int(ev.step)))
        elif kind == "restart":
            out.append(Restart(int(ev.client), int(ev.step),
                               bool(ev.from_snapshot)))
        elif kind == "join":
            out.append(Join(int(ev.client), int(ev.step), ev.arch))
        elif kind == "rewire":
            out.append(Rewire(int(ev.step),
                              tuple(tuple(int(j) for j in nbrs)
                                    for nbrs in ev.edges)))
        else:
            raise ValueError(f"unknown churn event kind {kind!r}; "
                             f"known: {sorted(_KINDS)}")
    return out


def sort_events(events: Sequence[ChurnEvent]) -> List[ChurnEvent]:
    """Stable sort by step — same-step events apply in script order
    (so ``kill(c, t)`` followed by ``restart(c, t)`` is a state swap)."""
    return sorted(events, key=lambda e: e.step)
