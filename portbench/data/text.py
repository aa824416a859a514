"""The benchmark's own text data: per-domain bigram languages and the
paper's skewed partition (§3.3).

Frozen copies, so that a change to the program cannot change the work a
cell measures: ``make_text`` is ``repro_torch.data.synthetic.
make_synthetic_text`` and ``partition`` is ``repro_torch.data.partition.
partition_dataset`` with ``assignment="random"``, both as of commit
2982e0a3c166b6b3c956e35f80f9ac7deeae8935. numpy only. ``make`` is what
traffic with ``"data": {"kind": "text", ...}`` generates.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def make_text(num_domains: int, sequences_per_domain: int, seq_len: int,
              vocab_size: int, temperature: float, seed: int,
              table_seed: int) -> Dict[str, np.ndarray]:
    """{"tokens" (N, T) int32, "labels" (N,) int32 domain ids}: domain d
    samples a bigram chain from transition logits L_d (V, V) / temperature,
    the tables drawn from ``table_seed``, the chains from ``seed``."""
    rng = np.random.default_rng(seed)
    table_rng = np.random.default_rng(table_seed)
    n = num_domains * sequences_per_domain
    tokens = np.empty((n, seq_len), dtype=np.int32)
    labels = np.repeat(np.arange(num_domains),
                       sequences_per_domain).astype(np.int32)
    for d in range(num_domains):
        logits = table_rng.standard_normal((vocab_size, vocab_size)) \
            / temperature
        probs = np.exp(logits - logits.max(axis=1, keepdims=True))
        probs /= probs.sum(axis=1, keepdims=True)
        cdf = np.cumsum(probs, axis=1)
        for s in range(sequences_per_domain):
            row = d * sequences_per_domain + s
            tok = rng.integers(vocab_size)
            for t in range(seq_len):
                tokens[row, t] = tok
                u = rng.random()
                tok = int(np.searchsorted(cdf[tok], u))
                tok = min(tok, vocab_size - 1)
    perm = rng.permutation(n)
    return {"tokens": tokens[perm], "labels": labels[perm]}


def partition(labels: np.ndarray, num_clients: int, num_labels: int,
              labels_per_client: int, skew: float, gamma_pub: float,
              seed: int) -> Tuple[np.ndarray, List[np.ndarray]]:
    """(public indices, each client's private indices): a ``gamma_pub``
    share held out as the public pool, each client a random set of
    ``labels_per_client`` primary labels, and every private sample dealt to
    client i with weight 1 + skew if its label is primary for i, else 1."""
    labels = np.asarray(labels)
    n = labels.shape[0]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_pub = int(round(gamma_pub * n))
    public, private = perm[:n_pub], perm[n_pub:]
    primary = [np.sort(rng.choice(num_labels,
                                  size=min(labels_per_client, num_labels),
                                  replace=False))
               for _ in range(num_clients)]
    is_primary = np.zeros((num_clients, num_labels), dtype=bool)
    for i, labs in enumerate(primary):
        is_primary[i, labs] = True
    weights = 1.0 + skew * is_primary.astype(np.float64)
    probs = weights / weights.sum(axis=0, keepdims=True)
    priv_labels = labels[private]
    assignment = np.empty(private.shape[0], dtype=np.int64)
    for lab in np.unique(priv_labels):
        sel = np.nonzero(priv_labels == lab)[0]
        assignment[sel] = rng.choice(num_clients, size=sel.shape[0],
                                     p=probs[:, lab])
    return public, [private[assignment == i] for i in range(num_clients)]


def make(traffic: dict, seed: int):
    """A cell's data from ``seed``: (arrays, public indices, each client's
    private indices)."""
    d, p = traffic["data"], traffic["partition"]
    arrays = make_text(d["domains"], d["sequences_per_domain"], d["seq_len"],
                       d["vocab"], d["temperature"], seed=seed,
                       table_seed=seed ^ 0x5EED)
    public, private = partition(arrays["labels"], traffic["clients"],
                                d["domains"], p["labels_per_client"],
                                p["skew"], p["gamma_pub"], seed)
    return arrays, public, private
