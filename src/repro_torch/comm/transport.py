"""Transports: how encoded prediction messages move between clients.

A transport is addressed by directed edges (src, dst) and measures time in
*global training steps* (the runtime's clock). Two implementations:

  * ``LoopbackTransport`` — in-process, lossless, zero latency: a message
    sent at step t is deliverable at step t. This is the reference
    transport under which prediction exchange must reproduce the
    param-pool trainer exactly.
  * ``SimulatedNetwork`` — store-and-forward edges with per-edge latency
    (steps), bandwidth caps (bytes per step; messages serialize FIFO on
    the edge, so a saturated edge delays later messages) and i.i.d. drop
    probability. Deterministic given its seed.

Both are deliberately synchronous-polling: the runtime calls ``poll(dst,
step)`` at step boundaries, mirroring how a real deployment would drain a
message queue between optimization steps.

Async-runtime clock convention: when the trainer is driven by
`core/scheduler.AsyncScheduler`, the ``step`` arguments are *wall ticks*
(real time), not any client's local step count. Latency and bandwidth are
therefore wall-tick quantities: a fixed 2-tick propagation delay spans two
local steps of a 1× client but only half a local step of a 4× (slow)
client — heterogeneity changes how much *training progress* a message
misses, not how long the wire holds it. ``client_rates`` adds the
sender-side half of that interaction: a client that steps r× slower is
modeled with an r× slower uplink (its transmissions occupy the edge r×
as many wall ticks), so slow clients both publish rarely *and* ship
slowly.
"""
from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

Edge = Tuple[int, int]  # (src, dst)


@dataclasses.dataclass
class Delivery:
    src: int
    dst: int
    payload: bytes
    sent_step: int
    recv_step: int


class Transport:
    def send(self, src: int, dst: int, payload: bytes, step: int) -> None:
        raise NotImplementedError

    def poll(self, dst: int, step: int) -> List[Delivery]:
        """Messages for ``dst`` that have arrived by ``step`` (FIFO)."""
        raise NotImplementedError

    def close(self) -> None:
        """Release held resources. In-process transports hold none; the
        socket transport overrides this to close real listeners."""

    # -- snapshot/restore (repro.fleet) ----------------------------------

    def state_dict(self) -> Optional[Dict]:
        """In-flight state for a fleet snapshot, or ``None`` when the
        transport's wire state cannot be captured (real sockets: frames on
        the kernel's wire are simply lost on restore — the staleness
        machinery absorbs the gap). In-process transports override."""
        return None

    def load_state_dict(self, state: Dict) -> None:
        raise NotImplementedError(
            f"{type(self).__name__} does not support state restore")


class LoopbackTransport(Transport):
    """Lossless, zero-latency, infinite-bandwidth in-process queues."""

    def __init__(self):
        self._queues: Dict[int, List[Delivery]] = defaultdict(list)

    def send(self, src, dst, payload, step) -> None:
        self._queues[dst].append(Delivery(src, dst, payload, step, step))

    def poll(self, dst, step) -> List[Delivery]:
        out = [d for d in self._queues[dst] if d.sent_step <= step]
        self._queues[dst] = [d for d in self._queues[dst]
                             if d.sent_step > step]
        for d in out:
            d.recv_step = step
        return out

    def state_dict(self) -> Dict:
        return {"queues": {
            int(dst): [(d.src, d.payload, d.sent_step, d.recv_step)
                       for d in q]
            for dst, q in self._queues.items() if q}}

    def load_state_dict(self, state: Dict) -> None:
        self._queues = defaultdict(list)
        for dst, q in state["queues"].items():
            dst = int(dst)
            self._queues[dst] = [
                Delivery(int(src), dst, bytes(payload), int(sent), int(recv))
                for src, payload, sent, recv in q]


@dataclasses.dataclass(frozen=True)
class EdgeSpec:
    """Per-edge link model. ``bandwidth`` is bytes per training step
    (None = unlimited); ``latency`` is propagation delay in steps."""
    latency: int = 0
    bandwidth: Optional[int] = None
    drop_prob: float = 0.0


@dataclasses.dataclass
class _InFlight:
    payload: bytes
    sent_step: int
    arrival_step: int


class SimulatedNetwork(Transport):
    """Store-and-forward network simulation.

    Each edge transmits FIFO at ``bandwidth`` bytes/step: a message sent
    at t starts transmitting when the edge frees up, takes
    ceil(len/bandwidth) steps on the wire, then ``latency`` steps of
    propagation. Drops are decided at send time (the message simply never
    arrives — the bus's staleness stamps surface the gap).
    """

    def __init__(self, latency: int = 0, bandwidth: Optional[int] = None,
                 drop_prob: float = 0.0, seed: int = 0,
                 per_edge: Optional[Dict[Edge, EdgeSpec]] = None,
                 client_rates: Optional[Dict[int, int]] = None):
        self.default = EdgeSpec(latency, bandwidth, drop_prob)
        self.per_edge = dict(per_edge or {})
        # wall ticks per local step of each client (1 = full speed); a
        # slow sender's uplink serializes r× slower in wall-tick terms
        self.client_rates = {int(c): int(r)
                             for c, r in (client_rates or {}).items()}
        self.rng = np.random.default_rng(seed)
        self._inflight: Dict[Edge, List[_InFlight]] = defaultdict(list)
        self._edge_free_at: Dict[Edge, int] = defaultdict(int)
        self.sent_count = 0
        self.dropped_count = 0

    def spec(self, edge: Edge) -> EdgeSpec:
        return self.per_edge.get(edge, self.default)

    def rate(self, client: int) -> int:
        return max(self.client_rates.get(client, 1), 1)

    def send(self, src, dst, payload, step) -> None:
        edge = (src, dst)
        spec = self.spec(edge)
        self.sent_count += 1
        dropped = spec.drop_prob > 0.0 and self.rng.random() < spec.drop_prob
        start = max(step, self._edge_free_at[edge])
        # effective uplink of a rate-r sender is bandwidth/r bytes per
        # wall tick; propagation latency is a link property and doesn't
        # scale with the sender's compute
        tx_steps = 0 if not spec.bandwidth else \
            int(math.ceil(len(payload) * self.rate(src) / spec.bandwidth))
        finish = start + tx_steps
        # the uplink is occupied for dropped messages too: on a real wire
        # the sender spends the transmit time either way (the loss happens
        # downstream), so a drop still delays the edge's later messages
        self._edge_free_at[edge] = finish
        if dropped:
            self.dropped_count += 1
            return
        self._inflight[edge].append(
            _InFlight(payload, step, finish + spec.latency))

    def poll(self, dst, step) -> List[Delivery]:
        out: List[Delivery] = []
        for (src, d), msgs in list(self._inflight.items()):
            if d != dst:
                continue
            ready = [m for m in msgs if m.arrival_step <= step]
            self._inflight[(src, d)] = [m for m in msgs
                                        if m.arrival_step > step]
            for m in ready:
                out.append(Delivery(src, dst, m.payload, m.sent_step, step))
        out.sort(key=lambda m: (m.sent_step, m.src))
        return out

    def state_dict(self) -> Dict:
        return {
            "inflight": {
                f"{s}-{d}": [(m.payload, m.sent_step, m.arrival_step)
                             for m in msgs]
                for (s, d), msgs in self._inflight.items() if msgs},
            "edge_free_at": {f"{s}-{d}": int(v)
                             for (s, d), v in self._edge_free_at.items()},
            "rng": self.rng.bit_generator.state,
            "sent_count": self.sent_count,
            "dropped_count": self.dropped_count,
        }

    def load_state_dict(self, state: Dict) -> None:
        def edge(key: str) -> Edge:
            s, d = key.split("-")
            return (int(s), int(d))

        self._inflight = defaultdict(list)
        for key, msgs in state["inflight"].items():
            self._inflight[edge(key)] = [
                _InFlight(bytes(p), int(sent), int(arr))
                for p, sent, arr in msgs]
        self._edge_free_at = defaultdict(int)
        for key, v in state["edge_free_at"].items():
            self._edge_free_at[edge(key)] = int(v)
        self.rng.bit_generator.state = state["rng"]
        self.sent_count = int(state["sent_count"])
        self.dropped_count = int(state["dropped_count"])
