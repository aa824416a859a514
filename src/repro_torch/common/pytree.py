"""Leafwise arithmetic over the port's flat parameter dicts (port of
``repro/common/pytree.py``), so optimizer, checkpoint and FedAvg code
reads as math. A tree is a ``{"/"-joined path: tensor}`` dict, the
reference's ``flatten_with_paths`` keys; `flatten_with_paths` turns a
nested tree into one."""
from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import torch

Params = Dict[str, torch.Tensor]


def tree_zeros_like(tree: Mapping[str, torch.Tensor]) -> Params:
    return {k: torch.zeros_like(v) for k, v in tree.items()}


def tree_add(a: Mapping[str, torch.Tensor],
             b: Mapping[str, torch.Tensor]) -> Params:
    return {k: a[k] + b[k] for k in a}


def tree_sub(a: Mapping[str, torch.Tensor],
             b: Mapping[str, torch.Tensor]) -> Params:
    return {k: a[k] - b[k] for k in a}


def tree_scale(tree: Mapping[str, torch.Tensor], s: float) -> Params:
    return {k: v * s for k, v in tree.items()}


def tree_axpy(a: float, x: Mapping[str, torch.Tensor],
              y: Mapping[str, torch.Tensor]) -> Params:
    """a * x + y, leafwise."""
    return {k: a * x[k] + y[k] for k in x}


def tree_mean(trees: Sequence[Mapping[str, torch.Tensor]]) -> Params:
    """Leafwise mean of a list of param dicts (FedAvg primitive): summed
    left to right in the leaves' dtype, then scaled by 1/n — the
    reference's order."""
    n = float(len(trees))
    out = dict(trees[0])
    for t in trees[1:]:
        out = tree_add(out, t)
    return tree_scale(out, 1.0 / n)


def tree_l2_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ x²) over every leaf, in f32, the leaves' sums added in the
    tree's key order."""
    total = sum(torch.sum(torch.square(x.float())) for x in tree.values())
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def tree_size(tree: Mapping[str, torch.Tensor]) -> int:
    """Total number of parameters."""
    return sum(int(v.numel()) for v in tree.values())


def tree_bytes(tree: Mapping[str, torch.Tensor]) -> int:
    return sum(int(v.numel()) * v.element_size() for v in tree.values())


def tree_cast(tree: Mapping[str, torch.Tensor], dtype: torch.dtype
              ) -> Params:
    """Floating leaves cast to ``dtype``; integer leaves kept."""
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in tree.items()}


def tree_any_nan(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Whether any floating leaf holds a NaN (a 0-d bool tensor)."""
    flags = [torch.isnan(v).any() for v in tree.values()
             if v.is_floating_point()]
    if not flags:
        return torch.tensor(False)
    return torch.stack(flags).any()


def flatten_with_paths(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts (and lists/tuples) → ``{"/"-joined path: leaf}``, with
    dict keys sorted as `jax.tree_util` orders them."""
    out: Dict[str, Any] = {}
    if isinstance(tree, Mapping):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return {prefix: tree}
    for k, v in items:
        key = f"{prefix}/{k}" if prefix else str(k)
        out.update(flatten_with_paths(v, key))
    return out
