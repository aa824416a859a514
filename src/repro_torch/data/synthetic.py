"""Synthetic datasets.

The paper runs on ImageNet; this container has no dataset and one CPU, so the
experiment harness uses *class-conditional synthetic data* with controllable
difficulty. The partition protocol, training loop and all MHD machinery are
identical to what would run on real data — only the pixel source differs
(documented in DESIGN.md §7).

Vision: each class has a fixed random prototype image; a sample is
``prototype + sigma * noise``. With enough classes and a small model this
gives ImageNet-like qualitative behaviour (underfit/overfit regimes, useful
teacher signal) at CPU scale.

Text: per-domain bigram language models over a shared vocab; clients' private
"domains" play the role of label subsets for next-token-prediction MHD.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class SyntheticVisionDataset:
    images: np.ndarray  # (N, H, W, C) float32
    labels: np.ndarray  # (N,) int32
    num_labels: int

    def __len__(self) -> int:
        return self.images.shape[0]


def make_synthetic_vision(
    num_labels: int = 20,
    samples_per_label: int = 100,
    image_size: int = 8,
    channels: int = 3,
    noise: float = 1.0,
    prototype_scale: float = 1.0,
    seed: int = 0,
    prototype_seed: Optional[int] = None,
) -> SyntheticVisionDataset:
    """``prototype_seed`` pins the class definitions: train/test splits use
    the same prototype_seed with different sample seeds."""
    proto_rng = np.random.default_rng(
        seed if prototype_seed is None else prototype_seed)
    rng = np.random.default_rng(seed)
    protos = prototype_scale * proto_rng.standard_normal(
        (num_labels, image_size, image_size, channels)
    ).astype(np.float32)
    n = num_labels * samples_per_label
    labels = np.repeat(np.arange(num_labels), samples_per_label).astype(np.int32)
    imgs = protos[labels] + noise * rng.standard_normal(
        (n, image_size, image_size, channels)
    ).astype(np.float32)
    perm = rng.permutation(n)
    return SyntheticVisionDataset(imgs[perm], labels[perm], num_labels)


@dataclasses.dataclass
class SyntheticTextDataset:
    tokens: np.ndarray  # (N, T) int32 sequences
    labels: np.ndarray  # (N,) int32 domain label per sequence
    num_labels: int
    vocab_size: int

    def __len__(self) -> int:
        return self.tokens.shape[0]


def make_synthetic_text(
    num_domains: int = 8,
    sequences_per_domain: int = 64,
    seq_len: int = 64,
    vocab_size: int = 256,
    temperature: float = 0.5,
    seed: int = 0,
    table_seed: Optional[int] = None,
) -> SyntheticTextDataset:
    """Per-domain bigram LMs: domain d has transition logits L_d (V, V).

    ``table_seed`` pins the domain languages (the transition tables):
    train/test splits use the same table_seed with different sample
    seeds — the text twin of the vision sets' ``prototype_seed``. None
    keeps the historical single-stream draw (tables and samples from
    ``seed``), bitwise.
    """
    rng = np.random.default_rng(seed)
    table_rng = rng if table_seed is None else np.random.default_rng(table_seed)
    n = num_domains * sequences_per_domain
    tokens = np.empty((n, seq_len), dtype=np.int32)
    labels = np.repeat(np.arange(num_domains), sequences_per_domain).astype(np.int32)
    for d in range(num_domains):
        logits = table_rng.standard_normal((vocab_size, vocab_size)) / temperature
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
    return SyntheticTextDataset(tokens[perm], labels[perm], num_domains, vocab_size)
