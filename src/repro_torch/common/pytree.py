"""Leafwise arithmetic over the port's flat parameter dicts (the part of
``repro/common/pytree.py`` the baselines and the benchmarks use), so
FedAvg reads as math."""
from __future__ import annotations

from typing import Dict, Mapping, Sequence

import torch

Params = Dict[str, torch.Tensor]


def tree_add(a: Mapping[str, torch.Tensor],
             b: Mapping[str, torch.Tensor]) -> Params:
    return {k: a[k] + b[k] for k in a}


def tree_scale(tree: Mapping[str, torch.Tensor], s: float) -> Params:
    return {k: v * s for k, v in tree.items()}


def tree_mean(trees: Sequence[Mapping[str, torch.Tensor]]) -> Params:
    """Leafwise mean of a list of param dicts (FedAvg primitive): summed
    left to right in the leaves' dtype, then scaled by 1/n — the
    reference's order."""
    n = float(len(trees))
    out = dict(trees[0])
    for t in trees[1:]:
        out = tree_add(out, t)
    return tree_scale(out, 1.0 / n)


def tree_size(tree: Mapping[str, torch.Tensor]) -> int:
    """Total number of parameters."""
    return sum(int(v.numel()) for v in tree.values())
