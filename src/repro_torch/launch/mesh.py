"""Production and test meshes (port of ``repro/launch/mesh.py``).

Functions, not module-level constants: importing this module touches no
process group. A mesh is a ``torch.distributed.device_mesh.DeviceMesh``
with the reference's axis names (``pod``, ``data``, ``model``) over the
ranks of the running process group, rank-major (rank = the row-major
index of its coordinates). Its groups are made here, one ``new_group``
a slice of each axis (`common.sharding.axis_groups`), every one with
the 60 s `common.sharding.GROUP_TIMEOUT`.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.common.sharding import axis_groups

SINGLE_POD = (16, 16)  # 256 chips
MULTI_POD = (2, 16, 16)  # 2 pods × 256 chips


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: Optional[str] = None):
    """A DeviceMesh of ``shape`` named ``axes`` over the running process
    group, whose world size must be the product of ``shape``."""
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, "
                         f"the process group has {world}")
    groups = [axis_groups(shape, [d]) for d in range(len(shape))]
    return DeviceMesh.from_group(
        groups, device_type or _device_type(),
        mesh=torch.arange(world).reshape(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    shape = MULTI_POD if multi_pod else SINGLE_POD
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_test_mesh(shape: Tuple[int, ...] = (2, 2),
                   axes: Tuple[str, ...] = ("data", "model"),
                   device_type: Optional[str] = None):
    """A small mesh for the multi-process CPU tests (gloo) and for the
    card's world-size-1 runs (NCCL)."""
    return make_mesh(shape, axes, device_type)


def required_devices(multi_pod: bool) -> int:
    return math.prod(MULTI_POD if multi_pod else SINGLE_POD)
