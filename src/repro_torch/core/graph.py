"""Communication graph topologies G_t (paper §3.1, §4.4, Fig. 5).

A graph is a list of out-neighbor tuples: ``adj[i]`` are the clients whose
checkpoints client i may receive (directed edges i -> e_t(i)). Graphs may be
static or a per-step callable (dynamic G_t).
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple, Union

import numpy as np

Adjacency = List[Tuple[int, ...]]
GraphFn = Callable[[int], Adjacency]  # step -> adjacency


def complete_graph(k: int) -> Adjacency:
    return [tuple(j for j in range(k) if j != i) for i in range(k)]


def cycle_graph(k: int, hops: int = 1) -> Adjacency:
    """Directed ring: i learns from (i+1..i+hops) mod k."""
    return [tuple((i + h) % k for h in range(1, hops + 1)) for i in range(k)]


def chain_graph(k: int) -> Adjacency:
    """Open chain: i learns from i+1; the last client learns from nobody."""
    return [((i + 1,) if i + 1 < k else ()) for i in range(k)]


def islands_graph(k: int, num_islands: int) -> Adjacency:
    """Disjoint complete subgraphs (paper Fig. 5 'Islands')."""
    assert k % num_islands == 0
    size = k // num_islands
    adj: Adjacency = []
    for i in range(k):
        isl = i // size
        members = range(isl * size, (isl + 1) * size)
        adj.append(tuple(j for j in members if j != i))
    return adj


def isolated_graph(k: int) -> Adjacency:
    """No communication — the paper's 'Separate' baseline."""
    return [() for _ in range(k)]


def random_regular_graph_fn(k: int, degree: int = 1, seed: int = 0,
                            reshuffle_every: int = 200) -> GraphFn:
    """Dynamic G_t (paper §3.1 allows per-step edge sets): every
    ``reshuffle_every`` steps each client gets ``degree`` fresh random
    out-neighbors. Models gossip-style decentralized systems where pairings
    rotate — beyond the paper's static topologies."""
    def graph(step: int) -> Adjacency:
        epoch = step // reshuffle_every
        rng = np.random.default_rng((seed << 16) ^ epoch)
        adj = []
        for i in range(k):
            others = [j for j in range(k) if j != i]
            picks = rng.choice(others, size=min(degree, len(others)),
                               replace=False)
            adj.append(tuple(int(j) for j in picks))
        return adj

    return graph


def as_graph_fn(graph: Union[Adjacency, GraphFn]) -> GraphFn:
    if callable(graph):
        return graph
    return lambda step: graph


def validate_adjacency(adj: Adjacency) -> None:
    k = len(adj)
    for i, nbrs in enumerate(adj):
        for j in nbrs:
            if not (0 <= j < k) or j == i:
                raise ValueError(f"bad edge {i}->{j} in a {k}-client graph")


def graph_distance_matrix(adj: Adjacency) -> np.ndarray:
    """Hop distances (BFS over directed edges). Used by the topology bench
    to report teacher-student distance effects (paper Fig. 6)."""
    k = len(adj)
    dist = np.full((k, k), np.inf)
    for s in range(k):
        dist[s, s] = 0
        frontier = [s]
        d = 0
        while frontier:
            d += 1
            nxt = []
            for u in frontier:
                for v in adj[u]:
                    if dist[s, v] == np.inf:
                        dist[s, v] = d
                        nxt.append(v)
            frontier = nxt
    return dist
