"""The paper's data-partition protocol (§3.3).

Given a labeled dataset with sample labels ``y``:

1. A fraction ``gamma_pub`` of samples is held out as the *public unlabeled
   pool* D_*.
2. Each client C_i is assigned a set of *primary labels* l_i, either
   - ``even``:   every label has exactly ``m`` primary clients, or
   - ``random``: each client draws a random fixed-size label subset
     (so labels may have 0..K primary clients — the paper's Fig. in §3.3).
3. Remaining (private) samples are distributed *without repetition*: a sample
   with label l goes to client i with probability proportional to
   ``1 + s`` if l is primary for i, else ``1`` — ``s`` is the *skewness*
   (s=0 → iid; s→∞ → samples only to primary clients).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class PartitionConfig:
    num_clients: int = 8
    num_labels: int = 1000
    labels_per_client: int = 250
    assignment: str = "random"  # "random" | "even"
    skew: float = 100.0  # the paper's s
    gamma_pub: float = 0.1  # public pool fraction
    even_multiplicity: int = 2  # m for "even" assignment
    seed: int = 0


@dataclasses.dataclass
class Partition:
    """Result of partitioning: index arrays into the source dataset."""

    public_indices: np.ndarray  # (N_pub,)
    client_indices: List[np.ndarray]  # K arrays of private sample indices
    primary_labels: List[np.ndarray]  # K arrays of primary label ids
    config: PartitionConfig

    @property
    def num_clients(self) -> int:
        return len(self.client_indices)

    def primary_mask(self, client: int) -> np.ndarray:
        """Boolean (num_labels,) mask of the client's primary labels."""
        mask = np.zeros(self.config.num_labels, dtype=bool)
        mask[self.primary_labels[client]] = True
        return mask


def assign_primary_labels(cfg: PartitionConfig, rng: np.random.Generator) -> List[np.ndarray]:
    """Primary label sets per client, per the paper's 'even'/'random' schemes."""
    K, L = cfg.num_clients, cfg.num_labels
    if cfg.assignment == "random":
        return [
            np.sort(rng.choice(L, size=min(cfg.labels_per_client, L), replace=False))
            for _ in range(K)
        ]
    if cfg.assignment == "even":
        # Each label gets exactly `m` primary clients: lay out labels repeated m
        # times, shuffle, deal round-robin into K equal hands.
        m = cfg.even_multiplicity
        deck = np.repeat(np.arange(L), m)
        rng.shuffle(deck)
        hands: List[List[int]] = [[] for _ in range(K)]
        # Deal while avoiding duplicate label in the same hand where possible.
        for idx, label in enumerate(deck):
            order = np.argsort([len(h) for h in hands])
            for c in order:
                if label not in hands[c]:
                    hands[c].append(int(label))
                    break
            else:  # all hands already contain it — allowed fallback
                hands[int(order[0])].append(int(label))
        return [np.sort(np.unique(np.asarray(h, dtype=np.int64))) for h in hands]
    raise ValueError(f"unknown assignment {cfg.assignment!r}")


def partition_dataset(labels: np.ndarray, cfg: PartitionConfig) -> Partition:
    """Split sample indices into public pool + K skewed private shards."""
    labels = np.asarray(labels)
    n = labels.shape[0]
    rng = np.random.default_rng(cfg.seed)

    perm = rng.permutation(n)
    n_pub = int(round(cfg.gamma_pub * n))
    public_indices = perm[:n_pub]
    private_pool = perm[n_pub:]

    primary = assign_primary_labels(cfg, rng)
    # (K, L) primary indicator
    K, L = cfg.num_clients, cfg.num_labels
    is_primary = np.zeros((K, L), dtype=bool)
    for i, labs in enumerate(primary):
        is_primary[i, labs] = True

    # Per-label client weights: 1 + s for primary clients, 1 otherwise.
    weights = 1.0 + cfg.skew * is_primary.astype(np.float64)  # (K, L)
    probs = weights / weights.sum(axis=0, keepdims=True)  # normalized over clients

    priv_labels = labels[private_pool]
    assignment = np.empty(private_pool.shape[0], dtype=np.int64)
    for l in np.unique(priv_labels):
        sel = np.nonzero(priv_labels == l)[0]
        assignment[sel] = rng.choice(K, size=sel.shape[0], p=probs[:, l])

    client_indices = [
        private_pool[assignment == i] for i in range(K)
    ]
    return Partition(
        public_indices=public_indices,
        client_indices=client_indices,
        primary_labels=primary,
        config=cfg,
    )


def shared_test_split(labels: np.ndarray, per_label: int, num_labels: int,
                      seed: int = 1234) -> np.ndarray:
    """Uniform-label-distribution eval set (the paper's 'shared' test set)."""
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    picks = []
    for l in range(num_labels):
        idx = np.nonzero(labels == l)[0]
        if idx.shape[0] == 0:
            continue
        take = min(per_label, idx.shape[0])
        picks.append(rng.choice(idx, size=take, replace=False))
    return np.concatenate(picks) if picks else np.empty((0,), dtype=np.int64)
