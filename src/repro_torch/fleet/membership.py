"""Membership (a copy of ``repro/fleet/membership.py``): the passive view
of a churn timeline — who is alive at which wall step, and which
communication graph applies.

A `Membership` is built from the fleet's *base* graph plus the scripted
churn events (`repro_torch.fleet.events`) and is fully deterministic: every
process in a fleet computes the identical view from the spec, with no
coordination. Time is measured in wall steps (the synchronous trainer's
global step, or the async scheduler's wall tick).

Liveness
  A client is alive from step 0 unless it has a `Join` event (then it is
  dead until its join step). `Kill`/`Restart` toggle liveness from their
  step on: a client killed at T does not step at T; one restarted at T
  steps at T.

Epochs
  ``epoch(step)`` counts the events in effect by ``step`` — a monotone
  version number for the fleet's configuration. Any two processes that
  agree on the step agree on the epoch, so it doubles as a cheap
  consistency stamp in logs and metrics.

Graph view
  ``graph_view(step)`` is a `core.graph.GraphFn`-compatible callable:
  the latest `Rewire` edges (or the base graph), with edges *from* dead
  clients removed — a dead client publishes nothing, and keeping it as a
  pull candidate would waste pulls on a silent peer. Edges *toward* dead
  clients are kept: senders still offer mail to them (they cannot know
  the peer died), and the bus tombstones the delivery — the metered
  offered-vs-delivered gap that makes churn costs visible
  (`CommMeter.record_tombstone`). This mirrors the real-socket behavior,
  where sends to a dead peer fail on the sender's side.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, List, Sequence, Tuple, Union

from repro_torch.core.graph import (Adjacency, GraphFn, as_graph_fn,
                                    validate_adjacency)
from repro_torch.fleet.events import (ChurnEvent, Join, Kill, Restart,
                                      Rewire, sort_events)


class Membership:
    def __init__(self, base_graph: Union[Adjacency, GraphFn],
                 num_clients: int,
                 events: Sequence[ChurnEvent] = ()):
        if not callable(base_graph):
            validate_adjacency(base_graph)
        self.base_fn = as_graph_fn(base_graph)
        self.num_clients = int(num_clients)
        self.events = sort_events(events)
        self._validate_events()

        # per-client liveness timeline: [(step, alive)] in apply order;
        # scanning for the last change with change_step <= t answers
        # is_alive in O(#events-for-client)
        self._status: Dict[int, List[Tuple[int, bool]]] = {
            i: [(0, True)] for i in range(self.num_clients)}
        for ev in self.events:
            if isinstance(ev, Join):
                self._status[ev.client][0] = (0, False)
        for ev in self.events:
            if isinstance(ev, Kill):
                self._status[ev.client].append((ev.step, False))
            elif isinstance(ev, (Restart, Join)):
                self._status[ev.client].append((ev.step, True))

        self._rewires: List[Tuple[int, Adjacency]] = []
        for ev in self.events:
            if isinstance(ev, Rewire):
                adj = [tuple(int(j) for j in nbrs) for nbrs in ev.edges]
                if len(adj) != self.num_clients:
                    raise ValueError(
                        f"rewire@{ev.step} has {len(adj)} rows for a "
                        f"{self.num_clients}-client fleet")
                validate_adjacency(adj)
                self._rewires.append((ev.step, adj))

    def _validate_events(self) -> None:
        """Reject incoherent scripts: out-of-range clients, double joins,
        kill of a dead client, restart/join of an alive one."""
        has_join = {ev.client for ev in self.events
                    if isinstance(ev, Join)}
        if len(has_join) != sum(1 for ev in self.events
                                if isinstance(ev, Join)):
            raise ValueError("a client joins twice in the churn script")
        alive: Dict[int, bool] = {}
        for ev in self.events:
            if isinstance(ev, Rewire):
                continue
            if not (0 <= ev.client < self.num_clients):
                raise ValueError(
                    f"churn event {ev} names client {ev.client} outside "
                    f"a {self.num_clients}-client fleet")
            cur = alive.get(ev.client, ev.client not in has_join)
            if isinstance(ev, Kill) and not cur:
                raise ValueError(f"kill of already-dead client "
                                 f"{ev.client} at step {ev.step}")
            if isinstance(ev, (Restart, Join)) and cur:
                raise ValueError(
                    f"{type(ev).__name__.lower()} of alive client "
                    f"{ev.client} at step {ev.step} (missing kill?)")
            alive[ev.client] = not isinstance(ev, Kill)

    # -- liveness ---------------------------------------------------------

    def is_alive(self, client: int, step: int) -> bool:
        alive = True
        for change_step, state in self._status[int(client)]:
            if change_step <= step:
                alive = state
            else:
                break
        return alive

    def alive(self, step: int) -> FrozenSet[int]:
        return frozenset(i for i in range(self.num_clients)
                         if self.is_alive(i, step))

    def epoch(self, step: int) -> int:
        """Number of churn events in effect by ``step`` — the fleet's
        monotone configuration version."""
        return sum(1 for ev in self.events if ev.step <= step)

    # -- graph view -------------------------------------------------------

    def graph_view(self, step: int) -> Adjacency:
        """The effective adjacency at ``step``: latest rewire (or base),
        minus edges from dead sources; edges toward dead destinations
        stay (their mail becomes metered tombstoned losses)."""
        adj = None
        for rw_step, edges in self._rewires:
            if rw_step <= step:
                adj = edges
        if adj is None:
            adj = self.base_fn(step)
        live = self.alive(step)
        return [tuple(j for j in nbrs if j in live) for nbrs in adj]
