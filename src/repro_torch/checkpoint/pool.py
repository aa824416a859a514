"""The paper's rolling checkpoint pool (§4.1).

Each client C_i keeps a pool P_i of N_P checkpoints of *other* clients.
Every S_P steps one new checkpoint (of a client adjacent in the current
communication graph) is inserted, replacing a random existing entry. Each
training step the client samples Δ pool entries as distillation teachers.

The pool stores (client_id, params) pairs; params may be stale — that lag is
part of the method (the paper: "infrequent pool updates would typically
introduce a time lag causing the model to distill knowledge from somewhat
outdated checkpoints").
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class PoolEntry:
    client_id: int
    params: Any
    step: int  # global step at which this checkpoint was taken


class CheckpointPool:
    def __init__(self, capacity: int, update_every: int, seed: int = 0):
        if capacity < 1:
            raise ValueError("pool capacity must be >= 1")
        self.capacity = capacity
        self.update_every = update_every
        self.entries: List[PoolEntry] = []
        self.rng = np.random.default_rng(seed)

    def should_update(self, step: int) -> bool:
        return step % self.update_every == 0

    def insert(self, entry: PoolEntry) -> None:
        """Insert, replacing a random entry once at capacity (paper §4.1)."""
        if len(self.entries) < self.capacity:
            self.entries.append(entry)
        else:
            slot = int(self.rng.integers(len(self.entries)))
            self.entries[slot] = entry

    def sample(self, delta: int) -> List[PoolEntry]:
        """Sample Δ distinct teachers for this step (fewer if pool is small)."""
        if not self.entries:
            return []
        k = min(delta, len(self.entries))
        idx = self.rng.choice(len(self.entries), size=k, replace=False)
        return [self.entries[int(i)] for i in idx]

    def __len__(self) -> int:
        return len(self.entries)

    def staleness(self, step: int) -> float:
        """Mean age (in steps) of pool entries — a telemetry signal."""
        if not self.entries:
            return 0.0
        return float(np.mean([step - e.step for e in self.entries]))
