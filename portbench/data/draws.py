"""The order in which the program's pipeline hands out the data, for the
reference to take its own batches and teachers: frozen copies, as of
commit 2982e0a3c166b6b3c956e35f80f9ac7deeae8935, of the documented
sampling of ``repro_torch.data.pipeline`` (``BatchIterator``: one
permutation of a client's private indices an epoch, drawn from
``default_rng(seed + 13·client)``; ``PublicPool.sample_ids``:
``default_rng((seed << 20) ^ step)``), of ``repro_torch.core.graph``'s
graphs, and of the trainer's pools (``core/runtime.py``: client i's pool
is seeded ``seed + 101·i`` and filled in its neighbours' order up to its
capacity; ``checkpoint/pool.py``: each step samples Δ distinct entries,
padded to Δ by cycling). numpy only. ``seed`` is the traffic's
``schedule_seed``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

PRIVATE_STREAM_STRIDE = 13
POOL_STRIDE = 101


def graph(name: str, clients: int) -> List[tuple]:
    """Each client's in-neighbours, in the program's order."""
    if name == "complete":
        return [tuple(j for j in range(clients) if j != i)
                for i in range(clients)]
    raise ValueError(f"unknown graph {name!r}")


def take(arrays: Dict[str, np.ndarray], sel: np.ndarray
         ) -> Dict[str, np.ndarray]:
    return {k: v[sel] for k, v in arrays.items()}


def private_indices(indices: np.ndarray, batch: int, seed: int,
                    client: int, steps: int) -> List[np.ndarray]:
    """The dataset indices of a client's first ``steps`` private
    batches."""
    rng = np.random.default_rng(seed + PRIVATE_STREAM_STRIDE * client)
    n = indices.shape[0]
    order, pos, out = rng.permutation(n), 0, []
    for _ in range(steps):
        parts, need = [], batch
        while need > 0:
            if pos >= n:
                order, pos = rng.permutation(n), 0
            grab = min(need, n - pos)
            parts.append(order[pos:pos + grab])
            pos += grab
            need -= grab
        out.append(indices[np.concatenate(parts)])
    return out


def public_indices(indices: np.ndarray, batch: int, seed: int,
                   step: int) -> np.ndarray:
    """The dataset indices of the public batch of ``step``."""
    rng = np.random.default_rng((seed << 20) ^ step)
    return indices[rng.integers(0, indices.shape[0], size=batch)]


def pool(neighbours: Sequence[int], capacity: int) -> List[int]:
    """The teachers a client's pool holds after the seed round."""
    return list(neighbours)[:capacity]


def teachers(entries: Sequence[int], delta: int, seed: int, client: int,
             steps: int) -> List[List[int]]:
    """The teachers a client samples at each of its first ``steps`` steps
    (no pool update falls among them)."""
    rng = np.random.default_rng(seed + POOL_STRIDE * client)
    out = []
    for _ in range(steps):
        if not entries:
            out.append([])
            continue
        idx = rng.choice(len(entries), size=min(delta, len(entries)),
                         replace=False)
        got = [entries[int(i)] for i in idx]
        out.append([got[i % len(got)] for i in range(delta)])
    return out
