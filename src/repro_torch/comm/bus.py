"""Prediction bus: per-edge mailboxes driven by the communication graph.

``publish(src, payload, step)`` fans one client's encoded prediction
message out along the current graph G_t: every client that lists ``src``
as an in-neighbor (``src ∈ adj[dst]`` — the same convention as
`core/graph.py`: adj[i] are the clients i *receives from*) gets a copy on
its (src, dst) edge. ``deliver(step)`` drains the transport into per-client
mailboxes; a mailbox keeps the *latest* message per sender together with
its staleness stamps (sent/received step).

The bus also keeps a *per-client logical clock* for the async runtime
(`core/scheduler.py`): ``advance(client, t)`` records the last wall tick
at which a client took a local step, and ``poll_fresh(client,
max_staleness)`` filters that client's mailbox down to mail whose age —
measured against the client's own clock, in wall ticks — is within the
staleness bound. Under the synchronous trainer every clock advances in
lockstep, so both APIs degenerate to the global-step behavior.

`PredictionPool` is the prediction-mode twin of the param
`CheckpointPool`: identical capacity / random-replacement / Δ-sampling
behavior (it *is* a subclass, sharing the rng stream), but entries hold
decoded prediction windows instead of parameters — so a lossless
zero-latency prediction run replays the param-pool run's teacher
schedule exactly, while params never leave their client.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.checkpoint.pool import CheckpointPool, PoolEntry
from repro_torch.core.graph import Adjacency, GraphFn, as_graph_fn
from repro_torch.comm.metering import CommMeter
from repro_torch.comm.transport import Delivery, Transport
from repro_torch.obs import tracer as trace
from repro_torch.obs.tracer import flow_id


@dataclasses.dataclass
class Mail:
    src: int
    payload: bytes
    sent_step: int
    recv_step: int

    def staleness(self, step: int) -> int:
        return step - self.sent_step


class PredictionBus:
    def __init__(self, transport: Transport, graph, num_clients: int,
                 meter: Optional[CommMeter] = None,
                 membership: Optional[Any] = None):
        # ``membership`` (repro.fleet.Membership, duck-typed via
        # ``is_alive(client, step)``) makes the bus churn-aware: a message
        # arriving for a dead client is dropped and metered as a
        # *tombstoned* loss — the sender offered it, the student never
        # sees it, delivered stays ≤ offered. None = everyone always
        # alive (the static-fleet behavior, unchanged).
        self.transport = transport
        self.graph_fn: GraphFn = as_graph_fn(graph)
        self.num_clients = num_clients
        self.meter = meter
        self.membership = membership
        self._mailboxes: Dict[int, Dict[int, Mail]] = {
            i: {} for i in range(num_clients)}
        self._clocks: Dict[int, int] = {i: 0 for i in range(num_clients)}

    def publish(self, src: int, payload: bytes, step: int) -> None:
        adj: Adjacency = self.graph_fn(step)
        for dst in range(self.num_clients):
            if dst == src or src not in adj[dst]:
                continue
            self.transport.send(src, dst, payload, step)
            if self.meter is not None:
                self.meter.record(step, src, dst, len(payload))

    def deliver(self, step: int) -> int:
        """Drain arrived messages into mailboxes; returns #deliveries.
        Each arrival is metered as *delivered* traffic — the receiver-side
        book, which excludes messages the transport dropped (those were
        metered as offered at ``publish`` time and nowhere else)."""
        t0 = trace.now()
        n = 0
        for dst in range(self.num_clients):
            for d in self.transport.poll(dst, step):
                if self.membership is not None and \
                        not self.membership.is_alive(dst, step):
                    # dead destination: the mail is a tombstoned loss —
                    # offered (metered at publish), never delivered
                    if self.meter is not None:
                        self.meter.record_tombstone(step, d.src, dst,
                                                    len(d.payload))
                    trace.instant("bus/tombstone", src=d.src, dst=dst,
                                  step=step, nbytes=len(d.payload))
                    continue
                cur = self._mailboxes[dst].get(d.src)
                if cur is None or d.sent_step >= cur.sent_step:
                    self._mailboxes[dst][d.src] = Mail(
                        d.src, d.payload, d.sent_step, d.recv_step)
                if self.meter is not None:
                    self.meter.record_delivery(step, d.src, dst,
                                               len(d.payload))
                trace.flow_end(flow_id(d.src, dst, d.sent_step))
                n += 1
        # emitted only when mail moved: the every-tick drain (and the
        # gossip finish barrier's busy loop) must not flood the buffer
        if n:
            trace.complete("bus/deliver", t0, step=step, delivered=n)
        return n

    def quiesce(self, step: int) -> int:
        """Flush the wire into mailboxes: ask the transport to drain any
        frames still sitting in kernel/parse buffers (transports without a
        ``quiesce`` hook — loopback, simulated — have nothing buried), then
        deliver what arrived. Used before fleet snapshots and at the gossip
        finish barrier so `delivered == offered` holds on a lossless wire.
        Returns the number of deliveries flushed."""
        q = getattr(self.transport, "quiesce", None)
        if q is not None:
            q()
        return self.deliver(step)

    def mailbox(self, dst: int) -> Dict[int, Mail]:
        return self._mailboxes[dst]

    def clear_mailbox(self, dst: int) -> None:
        """Wipe a client's mailbox — its mail dies with it (client churn:
        a killed process loses everything not in its snapshot)."""
        self._mailboxes[dst] = {}

    # -- per-client clocks (async runtime) -------------------------------

    def advance(self, client: int, t: int) -> None:
        """Record that ``client`` reached wall tick ``t``. Clocks are
        monotone: a stale advance (t below the recorded clock) is a no-op,
        so replays/retries can't move time backwards."""
        if t > self._clocks[client]:
            self._clocks[client] = t

    def clock(self, client: int) -> int:
        """The last wall tick ``client`` advanced to (0 before any step)."""
        return self._clocks[client]

    def poll_fresh(self, client: int,
                   max_staleness: Optional[int]) -> Dict[int, Mail]:
        """The subset of ``client``'s mailbox fresh enough to distill from,
        judged against the client's *own* clock: mail m survives iff
        ``clock(client) - m.sent_step <= max_staleness``. ``None`` means
        unbounded (the whole mailbox)."""
        box = self._mailboxes[client]
        if max_staleness is None:
            return dict(box)
        t = self._clocks[client]
        return {src: m for src, m in box.items()
                if m.staleness(t) <= max_staleness}

    # -- snapshot/restore (repro.fleet) ----------------------------------

    def client_state(self, dst: int) -> Dict[str, Any]:
        """One client's bus slice — mailbox + logical clock — the unit a
        per-process fleet snapshot captures."""
        return {
            "clock": int(self._clocks[dst]),
            "mail": {int(src): (m.payload, int(m.sent_step),
                                int(m.recv_step))
                     for src, m in self._mailboxes[dst].items()},
        }

    def load_client_state(self, dst: int, state: Dict[str, Any]) -> None:
        self._clocks[dst] = int(state["clock"])
        self._mailboxes[dst] = {
            int(src): Mail(int(src), bytes(payload), int(sent), int(recv))
            for src, (payload, sent, recv) in state["mail"].items()}

    EMPTY_STALENESS = -1.0  # sentinel: no mail has ever arrived

    def staleness(self, dst: int, step: int) -> float:
        """Mean staleness (steps) of dst's mailbox.

        Returns ``EMPTY_STALENESS`` (-1.0) when the mailbox is empty —
        callers reading this as a metric before any mail exists (e.g.
        `runtime.step()` on a chain's sink client) get a documented
        sentinel instead of a value indistinguishable from perfectly
        fresh mail."""
        box = self._mailboxes[dst]
        if not box:
            return self.EMPTY_STALENESS
        return float(np.mean([m.staleness(step) for m in box.values()]))


@dataclasses.dataclass
class PredictionWindow:
    """A decoded message: dense-view outputs for steps [t0, t0 + W)."""
    t0: int
    outs: Dict[str, np.ndarray]  # embedding? (W,B,E), logits (W,B,C), aux…

    @property
    def window(self) -> int:
        return int(self.outs["logits"].shape[0])

    def covers(self, t: int) -> bool:
        return self.t0 <= t < self.t0 + self.window

    def frame(self, t: int) -> Dict[str, np.ndarray]:
        w = t - self.t0
        return {k: v[w] for k, v in self.outs.items()}


class PredictionPool(CheckpointPool):
    """A `CheckpointPool` whose entries carry `PredictionWindow`s in the
    ``params`` slot. Same seed ⇒ same insert/replace/sample rng stream as
    the param pool, which is what makes the lossless-transport equivalence
    test exact."""

    def usable(self, entries: List[PoolEntry], t: int) -> List[PoolEntry]:
        """Entries whose window still covers step t (expired windows can't
        score the current public batch — predictions, unlike params, are
        sample-bound)."""
        return [e for e in entries if e.params.covers(t)]
