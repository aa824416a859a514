"""Batching pipeline: private per-client iterators + the public pool.

Host-side numpy batching (the realistic layout for a decentralized system:
each client owns its input pipeline); device transfer happens at the jit
boundary. Deterministic given seeds.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

# Stride between per-client private-batch rng streams. Every algorithm
# (MHD runtime, FedMD, FedAvg, supervised baselines) must derive client
# iterator seeds through `client_stream_seed` so that cross-algorithm
# comparisons train on *identical* private sample orders — the paper's
# tables are comparative, and a different shuffle is a confound.
PRIVATE_STREAM_STRIDE = 13


def client_stream_seed(seed: int, client_id: int) -> int:
    """Seed of client ``client_id``'s private `BatchIterator` stream."""
    return seed + PRIVATE_STREAM_STRIDE * client_id


class BatchIterator:
    """Infinite shuffled minibatch iterator over index-selected arrays."""

    def __init__(
        self,
        arrays: Dict[str, np.ndarray],
        indices: np.ndarray,
        batch_size: int,
        seed: int = 0,
        drop_remainder: bool = True,
    ):
        if indices.shape[0] == 0:
            raise ValueError("BatchIterator got an empty index set")
        self.arrays = arrays
        self.indices = np.asarray(indices)
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self._order = self.rng.permutation(self.indices.shape[0])
        self._pos = 0

    def next(self) -> Dict[str, np.ndarray]:
        n = self.indices.shape[0]
        take = []
        need = self.batch_size
        while need > 0:
            if self._pos >= n:
                self._order = self.rng.permutation(n)
                self._pos = 0
            grab = min(need, n - self._pos)
            take.append(self._order[self._pos : self._pos + grab])
            self._pos += grab
            need -= grab
        sel = self.indices[np.concatenate(take)]
        return {k: v[sel] for k, v in self.arrays.items()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next()

    # -- snapshot/restore (repro.fleet) ---------------------------------

    def state_dict(self) -> Dict[str, object]:
        """The iterator's resumable state: shuffle order, cursor, and the
        rng that generates future epochs' permutations. Restoring it makes
        the stream continue bit-for-bit (a fleet snapshot)."""
        return {"order": self._order.copy(), "pos": int(self._pos),
                "rng": self.rng.bit_generator.state}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        self._order = np.asarray(state["order"])
        self._pos = int(state["pos"])
        self.rng.bit_generator.state = state["rng"]


class PublicPool:
    """The shared public unlabeled pool D_* (labels stripped).

    ``sample(step)`` is deterministic in (seed, step) so that *all clients
    draw the same public batch at the same global step* — exactly the
    paper's setup where teachers and students score the same samples. In the
    multi-pod runtime the same property lets each pod materialize the batch
    locally with zero communication (samples are identified by a hash —
    paper §"Communication efficiency").
    """

    def __init__(self, arrays: Dict[str, np.ndarray], indices: np.ndarray,
                 batch_size: int, seed: int = 0):
        self.arrays = {k: v for k, v in arrays.items() if k != "labels"}
        self.indices = np.asarray(indices)
        self.batch_size = batch_size
        self.seed = seed

    def sample(self, step: int) -> Dict[str, np.ndarray]:
        sel = self.sample_ids(step)
        return {k: v[sel] for k, v in self.arrays.items()}

    def sample_ids(self, step: int) -> np.ndarray:
        """Dataset indices of the step-t public batch — the per-sample
        identifiers of the exchange wire format (paper §3.2: samples are
        referenced by hash, never shipped)."""
        rng = np.random.default_rng((self.seed << 20) ^ step)
        return self.indices[rng.integers(0, self.indices.shape[0],
                                         size=self.batch_size)]

    @property
    def size(self) -> int:
        return int(self.indices.shape[0])
