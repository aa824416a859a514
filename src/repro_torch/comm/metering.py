"""Bytes-per-edge-per-step ledger for the prediction exchange.

The ledger keeps two books:

  * **offered** traffic — every ``bus.publish`` send is recorded as
    (step, src, dst, nbytes) via ``record``: the sender-side cost, spent
    whether or not the network drops the message.
  * **delivered** traffic — every message that actually reaches a
    mailbox is recorded via ``record_delivery`` (called by
    ``bus.deliver``): the receiver-side §3.2 accounting. On a lossless
    transport the books agree; with drops, delivered ≤ offered and the
    gap is exactly the lost bytes.

It answers the paper's §3.2 accounting questions from *measured*
traffic: total bytes, per-edge totals, per-step totals, and amortized
bytes-per-client-step (publishes happen every S_P steps but cover S_P
public batches, so the amortized figure is the one comparable to
`benchmarks/comm_efficiency._mhd_bytes_per_step`).

The ledger also tracks the *bounded-staleness gate* of the async runtime
(`RunConfig.max_staleness`): every time a client assembles teachers,
``record_gate`` counts how many sampled pool entries were fresh enough to
distill from and how many were skipped as stale/expired — the per-client
freshness economy that `benchmarks/async_staleness.py` sweeps.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

Edge = Tuple[int, int]


class CommMeter:
    def __init__(self):
        self.total_bytes = 0
        self.num_messages = 0
        self.by_edge: Dict[Edge, int] = defaultdict(int)
        self.by_step: Dict[int, int] = defaultdict(int)
        self.by_src: Dict[int, int] = defaultdict(int)
        self.by_dst: Dict[int, int] = defaultdict(int)
        # delivered (receiver-side) book — see record_delivery
        self.delivered_bytes = 0
        self.delivered_messages = 0
        self.by_edge_delivered: Dict[Edge, int] = defaultdict(int)
        self.by_dst_delivered: Dict[int, int] = defaultdict(int)
        # bounded-staleness gate counters (async runtime)
        self.gate_fresh: Dict[int, int] = defaultdict(int)
        self.gate_stale: Dict[int, int] = defaultdict(int)
        self.rejected_publishes = 0  # non-finite payloads refused by codecs
        # tombstoned book (elastic fleets): messages addressed to a client
        # that was dead at delivery time — offered, never delivered; the
        # churn analogue of a transport drop (`repro.fleet.membership`)
        self.tombstoned_messages = 0
        self.tombstoned_bytes = 0
        self.by_dst_tombstoned: Dict[int, int] = defaultdict(int)
        self.by_edge_tombstoned: Dict[Edge, int] = defaultdict(int)

    def record(self, step: int, src: int, dst: int, nbytes: int) -> None:
        """One *offered* send (sender-side cost; drops included)."""
        self.total_bytes += nbytes
        self.num_messages += 1
        self.by_edge[(src, dst)] += nbytes
        self.by_step[step] += nbytes
        self.by_src[src] += nbytes
        self.by_dst[dst] += nbytes

    def record_delivery(self, step: int, src: int, dst: int,
                        nbytes: int) -> None:
        """One message that actually arrived in ``dst``'s mailbox —
        dropped/in-flight messages never reach this book, so receiver-side
        statistics exclude them."""
        self.delivered_bytes += nbytes
        self.delivered_messages += 1
        self.by_edge_delivered[(src, dst)] += nbytes
        self.by_dst_delivered[dst] += nbytes

    def record_tombstone(self, step: int, src: int, dst: int,
                         nbytes: int) -> None:
        """One message whose destination was dead when it arrived (client
        churn): the sender paid for it (offered book), the student never
        saw it. Keeps delivered ≤ offered with the gap attributable."""
        self.tombstoned_messages += 1
        self.tombstoned_bytes += nbytes
        self.by_dst_tombstoned[dst] += nbytes
        self.by_edge_tombstoned[(src, dst)] += nbytes

    def record_gate(self, client: int, fresh: int, stale: int) -> None:
        """One teacher-assembly event: ``fresh`` sampled pool entries
        passed the staleness gate, ``stale`` were skipped (expired window
        or older than ``max_staleness``)."""
        self.gate_fresh[client] += fresh
        self.gate_stale[client] += stale

    def stale_fraction(self, client: int) -> float:
        """Fraction of this client's sampled teachers skipped as stale
        (0.0 when the client never sampled any)."""
        total = self.gate_fresh[client] + self.gate_stale[client]
        return self.gate_stale[client] / total if total else 0.0

    def gate_summary(self) -> Dict[int, Dict[str, float]]:
        clients = sorted(set(self.gate_fresh) | set(self.gate_stale))
        return {c: {"fresh": float(self.gate_fresh[c]),
                    "stale": float(self.gate_stale[c]),
                    "stale_frac": self.stale_fraction(c)}
                for c in clients}

    def bytes_per_step(self, num_steps: int) -> float:
        """Total traffic amortized over the run length."""
        return self.total_bytes / max(num_steps, 1)

    def received_per_client_step(self, num_steps: int) -> Dict[int, float]:
        """Amortized *delivered* inbound bytes per client — the
        per-student cost the paper compares against FedAvg's full-model
        transfer. Counts the delivered book: a dropped message costs the
        sender (offered) but never the student."""
        return {dst: b / max(num_steps, 1)
                for dst, b in sorted(self.by_dst_delivered.items())}

    def summary(self) -> Dict[str, float]:
        return {
            "total_bytes": float(self.total_bytes),
            "num_messages": float(self.num_messages),
            "delivered_bytes": float(self.delivered_bytes),
            "delivered_messages": float(self.delivered_messages),
            "num_edges": float(len(self.by_edge)),
            "max_edge_bytes": float(max(self.by_edge.values(), default=0)),
            "stale_skips": float(sum(self.gate_stale.values())),
            "rejected_publishes": float(self.rejected_publishes),
            "tombstoned_messages": float(self.tombstoned_messages),
            "tombstoned_bytes": float(self.tombstoned_bytes),
        }

    # -- snapshot/restore (repro.fleet) ----------------------------------

    def state_dict(self) -> Dict[str, object]:
        """Both books + gate/tombstone counters, JSON-pure (edge-tuple
        keys become "src-dst" strings)."""
        def edges(d: Dict[Edge, int]) -> Dict[str, int]:
            return {f"{s}-{t}": int(v) for (s, t), v in d.items()}

        def ints(d: Dict[int, int]) -> Dict[str, int]:
            return {str(k): int(v) for k, v in d.items()}

        return {
            "total_bytes": self.total_bytes,
            "num_messages": self.num_messages,
            "by_edge": edges(self.by_edge),
            "by_step": ints(self.by_step),
            "by_src": ints(self.by_src),
            "by_dst": ints(self.by_dst),
            "delivered_bytes": self.delivered_bytes,
            "delivered_messages": self.delivered_messages,
            "by_edge_delivered": edges(self.by_edge_delivered),
            "by_dst_delivered": ints(self.by_dst_delivered),
            "gate_fresh": ints(self.gate_fresh),
            "gate_stale": ints(self.gate_stale),
            "rejected_publishes": self.rejected_publishes,
            "tombstoned_messages": self.tombstoned_messages,
            "tombstoned_bytes": self.tombstoned_bytes,
            "by_dst_tombstoned": ints(self.by_dst_tombstoned),
            "by_edge_tombstoned": edges(self.by_edge_tombstoned),
        }

    def load_state_dict(self, state: Dict[str, object]) -> None:
        def edges(d) -> Dict[Edge, int]:
            out: Dict[Edge, int] = defaultdict(int)
            for k, v in d.items():
                s, t = k.split("-")
                out[(int(s), int(t))] = int(v)
            return out

        def ints(d) -> Dict[int, int]:
            out: Dict[int, int] = defaultdict(int)
            for k, v in d.items():
                out[int(k)] = int(v)
            return out

        self.total_bytes = int(state["total_bytes"])
        self.num_messages = int(state["num_messages"])
        self.by_edge = edges(state["by_edge"])
        self.by_step = ints(state["by_step"])
        self.by_src = ints(state["by_src"])
        self.by_dst = ints(state["by_dst"])
        self.delivered_bytes = int(state["delivered_bytes"])
        self.delivered_messages = int(state["delivered_messages"])
        self.by_edge_delivered = edges(state["by_edge_delivered"])
        self.by_dst_delivered = ints(state["by_dst_delivered"])
        self.gate_fresh = ints(state["gate_fresh"])
        self.gate_stale = ints(state["gate_stale"])
        self.rejected_publishes = int(state["rejected_publishes"])
        self.tombstoned_messages = int(state["tombstoned_messages"])
        self.tombstoned_bytes = int(state["tombstoned_bytes"])
        self.by_dst_tombstoned = ints(state["by_dst_tombstoned"])
        # absent in SNAPSHOT_VERSION=1 fleet snapshots (pre-obs)
        self.by_edge_tombstoned = edges(state.get("by_edge_tombstoned", {}))

    def format_table(self) -> str:
        lines = ["edge         offered bytes   delivered    tombstoned"]
        # union of all three books: a multi-process per-rank meter has
        # outbound-only offered edges and inbound-only delivered edges;
        # a churned fleet has tombstone-only edges (dst died mid-run)
        edges = sorted(set(self.by_edge) | set(self.by_edge_delivered)
                       | set(self.by_edge_tombstoned))
        for (src, dst) in edges:
            b = self.by_edge.get((src, dst), 0)
            d = self.by_edge_delivered.get((src, dst), 0)
            ts = self.by_edge_tombstoned.get((src, dst), 0)
            lines.append(
                f"{src:>3} -> {dst:<3}  {b:>12,}  {d:>12,}  {ts:>12,}")
        lines.append(f"total        {self.total_bytes:>12,}  "
                     f"{self.delivered_bytes:>12,}  "
                     f"{self.tombstoned_bytes:>12,} "
                     f"({self.num_messages} sent, "
                     f"{self.delivered_messages} delivered, "
                     f"{self.tombstoned_messages} tombstoned)")
        return "\n".join(lines)
