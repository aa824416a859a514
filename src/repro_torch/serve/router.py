"""Request router: which personalized client model answers a query (port
of ``repro/serve/router.py``, on the port's tracer).

The fleet that comes out of a gossip run is not one model — it is K
*personalized* models, each strongest on its own primary labels (the
paper's β_priv axis). Routing is therefore a first-class serving
decision:

  * ``"client_id"`` — the request pins a client (a returning user hits
    their own model); unpinned requests fall back to round-robin.
  * ``"label_affinity"`` — route by the request's label hint to the
    client whose private shard is densest in that label (the partition's
    label histogram, the same affinity map `DecentralizedTrainer` keeps
    as ``ClientState.label_hist``); hintless requests round-robin.
  * ``"round_robin"`` — plain load spreading.

`Router.from_partition` builds the affinity map from the run's
`Partition`, so the router and the trainer agree on who owns what.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional

import numpy as np

from repro_torch.obs import tracer as trace
from repro_torch.serve.request import ServeRequest

POLICIES = ("client_id", "label_affinity", "round_robin")


class Router:
    def __init__(self, num_clients: int,
                 affinity: Optional[np.ndarray] = None,
                 policy: str = "label_affinity"):
        if policy not in POLICIES:
            raise ValueError(f"unknown routing policy {policy!r}; "
                             f"known: {POLICIES}")
        if policy == "label_affinity":
            if affinity is None:
                raise ValueError(
                    "label_affinity routing needs the (K, num_labels) "
                    "affinity map; build via Router.from_partition")
            affinity = np.asarray(affinity, dtype=np.float64)
            if affinity.ndim != 2 or affinity.shape[0] != num_clients:
                raise ValueError(
                    f"affinity shape {affinity.shape} does not cover "
                    f"{num_clients} clients")
        self.num_clients = num_clients
        self.affinity = affinity
        self.policy = policy
        self._rr = 0
        self.by_client: Dict[int, int] = defaultdict(int)

    @classmethod
    def from_partition(cls, partition, labels: np.ndarray,
                       num_labels: int,
                       policy: str = "label_affinity") -> "Router":
        """Affinity rows are each client's private-shard label histogram —
        identical to the trainer's per-client ``label_hist``."""
        from repro_torch.core.evaluation import label_histogram

        affinity = np.stack([
            label_histogram(labels, idx, num_labels)
            for idx in partition.client_indices])
        return cls(len(partition.client_indices), affinity=affinity,
                   policy=policy)

    def _round_robin(self) -> int:
        cid = self._rr % self.num_clients
        self._rr += 1
        return cid

    def route(self, request: ServeRequest) -> int:
        with trace.span("serve/route", request=request.request_id,
                        policy=self.policy):
            cid = self._decide(request)
        self.by_client[cid] += 1
        return cid

    def _decide(self, request: ServeRequest) -> int:
        if request.client_id is not None:
            cid = int(request.client_id)
            if not 0 <= cid < self.num_clients:
                raise ValueError(f"request {request.request_id} pins "
                                 f"client {cid} of {self.num_clients}")
            return cid
        if self.policy == "label_affinity" and \
                request.label_hint is not None:
            # argmax ties resolve to the lowest client id — deterministic
            return int(np.argmax(self.affinity[:, int(request.label_hint)]))
        return self._round_robin()

    def summary(self) -> Dict[str, float]:
        total = sum(self.by_client.values())
        out = {"routed": float(total)}
        for cid in range(self.num_clients):
            out[f"c{cid}"] = float(self.by_client.get(cid, 0))
        return out
