"""Scripted client-churn events and the `ChurnDriver` that applies them
(port of ``repro/fleet/events.py``).

A churn *timeline* is a list of events, in wall steps:

  * `Kill(client, step)` — the client's process dies before ``step``: it
    stops stepping and publishing, and its mailbox, pending pulls and
    teacher pool are lost.
  * `Restart(client, step, from_snapshot)` — it comes back at ``step``,
    from its newest fleet snapshot (`repro_torch.fleet.snapshot`) or as
    a fresh process (re-drawn params, rewound private stream).
  * `Join(client, step, arch)` — a late joiner, dead until ``step``.
  * `Rewire(step, edges)` — the graph becomes ``edges`` from ``step``
    on (``edges[i]`` = who client i receives from).

`repro_torch.fleet.membership.Membership` turns the timeline into the
passive view (who is alive when, which graph applies); `ChurnDriver`
applies the active side to a live trainer, each event once, before the
step it names. Both consume the same event list.
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


class ChurnDriver:
    """Applies a churn timeline to a live `DecentralizedTrainer`.

    Call ``before_step(t)`` once per wall step, *before* the step runs:
    every not-yet-applied event with ``event.step <= t`` fires in timeline
    order. Events for clients this process does not drive
    (``trainer.local_ids``) are skipped — in a multi-process fleet each
    rank reacts only to its own clients' churn, while `Membership` gives
    every rank the same graph/liveness view.

    ``start_step`` fast-forwards the timeline after a snapshot restore:
    events strictly before it are considered already applied.
    """

    def __init__(self, trainer: Any, events: Sequence[ChurnEvent],
                 snapshot_dir: Optional[str] = None, start_step: int = 0):
        self.trainer = trainer
        self.events = sort_events(events)
        self.snapshot_dir = snapshot_dir
        self._idx = 0
        while self._idx < len(self.events) and \
                self.events[self._idx].step < start_step:
            self._idx += 1
        self.applied: List[str] = []

    def before_step(self, t: int) -> List[str]:
        """Fire due events; returns human-readable descriptions of what
        was applied (also appended to ``self.applied``)."""
        fired: List[str] = []
        while self._idx < len(self.events) and \
                self.events[self._idx].step <= t:
            ev = self.events[self._idx]
            self._idx += 1
            desc = self._apply(ev, t)
            if desc:
                fired.append(desc)
                self.applied.append(desc)
        return fired

    def _apply(self, ev: ChurnEvent, t: int) -> Optional[str]:
        tr = self.trainer
        if isinstance(ev, Rewire):
            # passive: the Membership graph view flips on its own
            return f"rewire@{ev.step}"
        if ev.client not in tr.local_ids:
            return None
        if isinstance(ev, Kill):
            tr.deactivate_client(ev.client)
            return f"kill(c{ev.client})@{ev.step}"
        if isinstance(ev, Restart):
            if ev.from_snapshot:
                from repro_torch.fleet.snapshot import restore_clients

                if not self.snapshot_dir:
                    raise ValueError(
                        f"restart of client {ev.client} from snapshot "
                        "needs a snapshot_dir")
                steps = restore_clients(self.snapshot_dir, tr,
                                        [ev.client], step=t)
                tr.activate_client(ev.client)
                return (f"restart(c{ev.client})@{ev.step} from "
                        f"snapshot step {steps[ev.client]}")
            tr.reinit_client(ev.client)
            tr.activate_client(ev.client)
            return f"restart(c{ev.client})@{ev.step} fresh"
        if isinstance(ev, Join):
            if tr.clients[ev.client].params is None:
                tr.reinit_client(ev.client)
            tr.activate_client(ev.client)
            return f"join(c{ev.client})@{ev.step}"
        raise TypeError(f"unknown churn event {ev!r}")
