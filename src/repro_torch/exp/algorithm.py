"""The `Algorithm` protocol: one runtime contract for MHD, FedMD, FedAvg
and supervised training (port of ``repro/exp/algorithm.py``; `Bindings`
also carries the ``device`` every trainer runs on).

An algorithm adapter is constructed from an `ExperimentSpec`, bound to
materialized resources (`Bindings`: arrays, partition, bundles, optimizer,
graph, transport) via ``setup``, and then driven step by step by
`Experiment.run` — the runner owns the loop, eval cadence, metric
namespace and checkpoint rhythm; the adapter owns one step.

Adapters advertise `Capabilities` so the runner can reject impossible
specs up front (an async schedule for a barrier algorithm, a
heterogeneous fleet for FedAvg) instead of failing deep in a train loop.

Registration goes through ``ALGORITHMS`` (`common/registry.py`): a
factory ``(spec) -> Algorithm``. `repro_torch.exp` registers the four paper
algorithms at import; downstream code can register more.
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, List, Optional, Protocol,
                    Sequence, runtime_checkable)

import numpy as np
import torch

from repro_torch.common.registry import Registry
from repro_torch.core.graph import Adjacency
from repro_torch.data.partition import Partition
from repro_torch.exp.spec import ExperimentSpec
from repro_torch.models.zoo import ModelBundle
from repro_torch.optim.optimizers import Optimizer


@dataclasses.dataclass(frozen=True)
class Capabilities:
    """What an algorithm can consume from a spec. The runner enforces
    these; anything an algorithm doesn't support must make the run fail
    loudly, not be silently ignored."""

    needs_public_pool: bool = False  # consumes γ_pub public samples
    supports_async: bool = False  # can run under ScheduleSpec mode="async"
    heterogeneous_clients: bool = False  # per-client architectures OK
    uses_topology: bool = False  # consumes the communication graph G_t
    decentralized: bool = False  # no central aggregator on the wire
    elastic: bool = False  # survives client churn (ChurnSpec events)


@dataclasses.dataclass
class Bindings:
    """Materialized resources the runner hands to ``Algorithm.setup``."""

    spec: ExperimentSpec
    arrays: Dict[str, np.ndarray]
    test_arrays: Dict[str, np.ndarray]
    partition: Partition
    bundles: List[ModelBundle]
    optimizer: Optimizer
    graph: Adjacency
    transport: Optional[Any]  # repro_torch.comm.Transport | None (loopback)
    num_labels: int
    device: torch.device  # where every trainer's params and batches live
    # multi-process gossip: the client ids THIS process drives (None =
    # all — the single-process runner). Algorithms that cannot restrict
    # (centralized baselines) must reject a non-None value in setup.
    local_clients: Optional[Sequence[int]] = None


@runtime_checkable
class Algorithm(Protocol):
    """The uniform runtime surface `Experiment.run` drives."""

    name: str
    capabilities: Capabilities

    def setup(self, bindings: Bindings) -> None:
        """Build internal state (models, iterators, comm) from resources."""
        ...

    def step(self, t: int) -> Dict[str, float]:
        """Advance one step (one wall tick when async); returns the step's
        metrics under the ``c{i}/...`` namespace."""
        ...

    def evaluate(self, arrays: Dict[str, np.ndarray]) -> Dict[str, float]:
        """β_sh/β_priv metrics under ``c{i}/...`` + ``mean/...``."""
        ...

    def save(self, directory: str, step: int) -> None:
        ...

    def restore(self, directory: str, step: Optional[int] = None) -> int:
        ...


# name -> factory(spec) -> Algorithm
ALGORITHMS: Registry[Callable[[ExperimentSpec], Algorithm]] = Registry(
    "algorithm")


def make_algorithm(spec: ExperimentSpec) -> Algorithm:
    return ALGORITHMS.get(spec.algorithm.name)(spec)
