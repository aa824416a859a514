"""Logical sharding roles and the active mesh (port of
``repro/common/sharding.py``).

The reference's model code calls ``maybe_shard(x, *roles)`` to steer
XLA's partitioner, and its manual regions (the expert-parallel MoE, the
pod step) read the active mesh with ``jax.sharding.get_abstract_mesh()``.
The port has no partitioner: its layouts are explicit, each rank holding
its own block of the batch (and, for the a2a MoE, its own expert shards),
so `maybe_shard` returns its input. The port's counterpart of the
abstract mesh is `use_mesh`: ``with use_mesh(mesh, axes):`` makes those
axes of a ``DeviceMesh`` the ones `moe_a2a` and `mhd_distributed` read —
their sizes, this rank's coordinates and the process group along any
tuple of them (`group_of`).
"""
from __future__ import annotations

import contextlib
import datetime
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

AxisLike = Union[None, str, Tuple[str, ...]]

# every group the port makes: a rank that raises while its peers wait in a
# collective fails them within a minute instead of hanging them
GROUP_TIMEOUT = datetime.timedelta(seconds=60)

# Logical roles used by model code; launch/shardings.py can override this
# mapping (a §Perf lever — e.g. sequence-sharding long contexts).
_LOGICAL_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "model": "model",
    "expert": "model",
    "fsdp_tokens": ("pod", "data"),  # token/slot dims inside manual regions
    "none": None,
}


def set_logical_rule(role: str, axes: AxisLike) -> None:
    _LOGICAL_RULES[role] = axes


def get_logical_rule(role: str) -> AxisLike:
    return _LOGICAL_RULES.get(role)


def maybe_shard(x: torch.Tensor, *roles: str) -> torch.Tensor:
    """Returns ``x``. The reference constrains dim i of ``x`` to the mesh
    axes of logical role i for XLA's partitioner; the port's layouts are
    explicit (each rank computes on its own block), and the partitioner
    this steers — tensor parallelism and FSDP of the dense layers within
    a pod — is ROADMAP Queue 1 item 15c."""
    return x


# ---------------------------------------------------------------------------
# the active mesh
# ---------------------------------------------------------------------------

_ACTIVE: List[Tuple[object, Tuple[str, ...]]] = []


@contextlib.contextmanager
def use_mesh(mesh, axes: Optional[Sequence[str]] = None) -> Iterator[None]:
    """Make ``axes`` of ``mesh`` (all of them by default) the active mesh
    for the code run inside; ``mesh=None`` makes none active (one
    device)."""
    if mesh is None:
        _ACTIVE.append((None, ()))
    else:
        names = tuple(mesh.mesh_dim_names)
        axes = names if axes is None else tuple(axes)
        unknown = [a for a in axes if a not in names]
        if unknown:
            raise ValueError(f"axes {unknown} not in the mesh's {names}")
        _ACTIVE.append((mesh, axes))
    try:
        yield
    finally:
        _ACTIVE.pop()


def active_mesh():
    """(mesh, axes) of the innermost `use_mesh`, or (None, ())."""
    return _ACTIVE[-1] if _ACTIVE else (None, ())


def mesh_axis_sizes(mesh=None, axes: Optional[Sequence[str]] = None
                    ) -> Dict[str, int]:
    """{axis: size} of the active mesh (or of ``mesh``'s ``axes``); empty
    when none is active."""
    if mesh is None:
        mesh, axes = active_mesh()
        if mesh is None:
            return {}
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.mesh.shape))
    return {a: int(sizes[a]) for a in (names if axes is None else axes)}


def axis_index(mesh, axes: Sequence[str]) -> int:
    """This rank's index along ``axes`` of ``mesh``, row-major in the
    order given (the reference's block index over those axes)."""
    sizes = mesh_axis_sizes(mesh)
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + int(mesh.get_local_rank(a))
    return idx


def axis_groups(shape: Sequence[int], dims: Sequence[int]):
    """This rank's process group along the mesh dimensions ``dims`` of a
    ``shape`` mesh over ranks 0…n−1 (its ranks row-major in those
    dimensions): one ``new_group`` for every slice, made by every rank in
    the same order, as the collective ``new_group`` requires; each with
    `GROUP_TIMEOUT`."""
    ids = torch.arange(math.prod(shape)).reshape(tuple(shape))
    rest = [d for d in range(len(shape)) if d not in dims]
    order = ids.permute(*rest, *dims).reshape(
        -1, math.prod(shape[d] for d in dims))
    rank, mine = dist.get_rank(), None
    for ranks in order.tolist():
        g = dist.new_group(ranks, timeout=GROUP_TIMEOUT)
        if rank in ranks:
            mine = g
    return mine


def group_of(mesh, axes: Sequence[str]):
    """The process group of this rank along ``axes`` of ``mesh``: the
    mesh's own group for one axis, else a group made once for the tuple
    (by every rank at its first call, so every rank must ask for the same
    tuples in the same order, as they do running the same step)."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    cache = mesh.__dict__.setdefault("_repro_groups", {})
    if axes not in cache:
        names = tuple(mesh.mesh_dim_names)
        if sorted(names.index(a) for a in axes) != \
                [names.index(a) for a in axes]:
            raise ValueError(f"axes {axes} out of the mesh's order {names}")
        cache[axes] = axis_groups(tuple(mesh.mesh.shape),
                                  [names.index(a) for a in axes])
    return cache[axes]
