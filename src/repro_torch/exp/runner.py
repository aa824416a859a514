"""`Experiment` — the single runner behind every algorithm (port of
``repro/exp/runner.py``).

``Experiment(spec).run()`` materializes the spec (data, partition, fleet,
optimizer, graph, transport), instantiates the registered `Algorithm`
adapter, and owns the loop: stepping, the unified metric namespace
(``c{i}/...`` step metrics, ``mean/...`` eval metrics, ``comm/...``
meters), the eval-history cadence, and checkpointing. The result's
``metrics``/``history`` are JSON-serializable; live objects (the trainer,
transport) ride out-of-band on `ExperimentResult`.

Runs on the GPU unless ``device="cpu"`` is passed: the device is resolved
when the `Experiment` is made, and every trainer, batch and evaluation
lives there. Not ported yet, and raising NotImplementedError naming its
ROADMAP item before anything is built: ``train.trace_dir`` (the trace
export and metrics of ``obs/``) and ``train.snapshot_every`` (the fleet
snapshots), both Queue 1 item 12.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.graph import (
    chain_graph,
    complete_graph,
    cycle_graph,
    islands_graph,
    isolated_graph,
)
from repro_torch.data import (
    PartitionConfig,
    Partition,
    make_synthetic_vision,
    partition_dataset,
)
from repro_torch.exp.algorithm import Algorithm, Bindings, make_algorithm
from repro_torch.exp.spec import (
    CLIENT_ARCHS,
    TRANSPORTS,
    DataSpec,
    ExperimentSpec,
    PartitionSpec,
)
from repro_torch.models.zoo import build_bundle
from repro_torch.optim.optimizers import OptimizerConfig, make_optimizer

DataTriple = Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray], Partition]


# -- spec materialization ----------------------------------------------------


def materialize_data(data: DataSpec, partition: PartitionSpec,
                     num_clients: int) -> DataTriple:
    """(train arrays, test arrays, partition) for a spec — the one data
    construction path every harness shares.

    Text mirrors vision: the domain languages (transition tables) are
    pinned with ``table_seed = seed`` so the test split (sample seed
    ``seed + 991``) speaks the same languages — the twin of the vision
    sets' ``prototype_seed`` convention."""
    if data.kind == "synthetic_text":
        from repro_torch.lm.pool import make_text_arrays

        arrays = make_text_arrays(
            num_domains=data.num_labels,
            sequences_per_domain=data.samples_per_label,
            seq_len=data.seq_len, vocab_size=data.vocab_size,
            seed=data.seed, table_seed=data.seed)
        test_arrays = make_text_arrays(
            num_domains=data.num_labels,
            sequences_per_domain=data.test_samples_per_label,
            seq_len=data.seq_len, vocab_size=data.vocab_size,
            seed=data.seed + 991, table_seed=data.seed)
        labels = arrays["labels"]
    else:
        ds = make_synthetic_vision(
            num_labels=data.num_labels,
            samples_per_label=data.samples_per_label,
            image_size=data.image_size, noise=data.noise, seed=data.seed)
        test = make_synthetic_vision(
            num_labels=data.num_labels,
            samples_per_label=data.test_samples_per_label,
            image_size=data.image_size, noise=data.noise,
            seed=data.seed + 991, prototype_seed=data.seed)
        arrays = {"images": ds.images, "labels": ds.labels}
        test_arrays = {"images": test.images, "labels": test.labels}
        labels = ds.labels
    pcfg = PartitionConfig(
        num_clients=num_clients, num_labels=data.num_labels,
        labels_per_client=partition.labels_per_client,
        assignment=partition.assignment, skew=partition.skew,
        gamma_pub=partition.gamma_pub,
        even_multiplicity=partition.even_multiplicity,
        seed=data.seed if partition.seed is None else partition.seed)
    part = partition_dataset(labels, pcfg)
    return arrays, test_arrays, part


def build_bundles(spec: ExperimentSpec) -> List[Any]:
    """Text fleets get the shared vocab as the head dim (every backbone —
    SSM, transformer, MoE — must expose identical (B', V) head shapes to
    the wire) and the positions-as-samples adapter wrap."""
    text = spec.data.kind == "synthetic_text"
    head_dim = spec.data.vocab_size if text else spec.data.num_labels
    bundles = [build_bundle(CLIENT_ARCHS.get(c.arch)(
        head_dim, c.aux_heads, c.width))
        for c in spec.clients]
    if text:
        from repro_torch.lm.pool import lm_client_bundle

        bundles = [lm_client_bundle(b, spec.data.max_positions,
                                    spec.data.position_seed)
                   for b in bundles]
    return bundles


def build_graph(spec: ExperimentSpec):
    k = spec.num_clients
    topo = spec.topology
    if topo.name == "complete":
        return complete_graph(k)
    if topo.name == "cycle":
        return cycle_graph(k, hops=topo.hops)
    if topo.name == "chain":
        return chain_graph(k)
    if topo.name == "islands":
        return islands_graph(k, topo.islands)
    if topo.name == "isolated":
        return isolated_graph(k)
    raise ValueError(f"unknown topology {topo.name!r}")


def build_transport(spec: ExperimentSpec) -> Optional[Any]:
    """Resolve the spec's transport kind through the ``TRANSPORTS``
    registry (None = the trainer's default in-process loopback)."""
    return TRANSPORTS.get(spec.transport.kind)(spec)


def build_optimizer(spec: ExperimentSpec):
    o = spec.optimizer
    return make_optimizer(OptimizerConfig(
        name=o.name, init_lr=o.init_lr,
        total_steps=(spec.train.steps if o.total_steps is None
                     else o.total_steps),
        warmup_steps=o.warmup_steps, momentum=o.momentum,
        weight_decay=o.weight_decay, grad_clip_norm=o.grad_clip_norm,
        state_dtype=o.state_dtype))


# -- results -----------------------------------------------------------------


@dataclasses.dataclass
class ExperimentResult:
    """What a run produced. ``metrics``/``history`` are plain floats (JSON
    round-trips); the live algorithm adapter rides out-of-band so
    drill-downs (per-client params, comm meters) never leak into the
    serializable payload."""

    spec: ExperimentSpec
    metrics: Dict[str, float]  # final eval + comm meters
    history: List[Tuple[int, Dict[str, float]]]  # (step, eval metrics)
    us_per_step: float
    algorithm: Algorithm = dataclasses.field(repr=False)

    @property
    def trainer(self) -> Any:
        """The underlying trainer object (out-of-band, never serialized)."""
        return getattr(self.algorithm, "trainer", None)

    @property
    def transport(self) -> Any:
        return getattr(self.algorithm, "transport", None)

    def to_payload(self) -> Dict[str, Any]:
        return {"spec": self.spec.to_dict(),
                "metrics": self.metrics,
                "history": [[t, m] for t, m in self.history],
                "us_per_step": self.us_per_step}

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_payload(), indent=indent, sort_keys=True)


# -- the runner --------------------------------------------------------------


class Experiment:
    """One declarative experiment: ``Experiment(spec).run()``.

    ``data`` overrides the spec-built ``(arrays, test_arrays, partition)``
    triple — used by benchmarks that share one dataset across several
    algorithm runs for comparability. ``device`` is where the run lives
    (None = the card, which must be there).
    """

    def __init__(self, spec: ExperimentSpec,
                 data: Optional[DataTriple] = None,
                 device: Optional[Any] = None):
        self.spec = spec.validate()
        self._data = data
        self.device = resolve_device(device)

    def build_bindings(self) -> Bindings:
        spec = self.spec
        arrays, test_arrays, part = (
            self._data if self._data is not None else
            materialize_data(spec.data, spec.partition, spec.num_clients))
        return Bindings(
            spec=spec, arrays=arrays, test_arrays=test_arrays,
            partition=part, bundles=build_bundles(spec),
            optimizer=build_optimizer(spec), graph=build_graph(spec),
            transport=build_transport(spec), num_labels=spec.data.num_labels,
            device=self.device)

    def _check_capabilities(self, algo: Algorithm) -> None:
        spec, caps = self.spec, algo.capabilities
        if caps.needs_public_pool and spec.partition.gamma_pub <= 0.0:
            raise ValueError(
                f"algorithm {algo.name!r} distills on the public pool; "
                "partition.gamma_pub must be > 0")
        if spec.schedule.mode != "sync" and not caps.supports_async:
            raise ValueError(
                f"algorithm {algo.name!r} does not support async "
                "(lockstep/scoreboard) schedules")
        if len(set(spec.clients)) > 1 and not caps.heterogeneous_clients:
            raise ValueError(
                f"algorithm {algo.name!r} needs an identical-architecture "
                "fleet")
        if spec.topology.name != "complete" and not caps.uses_topology:
            raise ValueError(
                f"algorithm {algo.name!r} ignores the communication graph; "
                f"a {spec.topology.name!r} topology would silently not "
                "apply — use topology 'complete'")
        # (a non-loopback transport with exchange='params' is already
        # rejected by spec.validate(), for every algorithm)
        if spec.wire.exchange != "params" and not caps.decentralized:
            raise ValueError(
                f"algorithm {algo.name!r} has no prediction wire; "
                "set wire.exchange='params'")
        if spec.train.max_staleness is not None and not caps.decentralized:
            raise ValueError(
                f"algorithm {algo.name!r} has no staleness gate; unset "
                "train.max_staleness")
        if spec.churn.events and not caps.elastic:
            raise ValueError(
                f"algorithm {algo.name!r} is not elastic; a churn "
                "timeline (ChurnSpec.events) would silently not apply")

    def run(self,
            on_step: Optional[Callable[[int, Dict[str, float]], None]] = None,
            on_eval: Optional[Callable[[int, Dict[str, float]], None]] = None,
            ) -> ExperimentResult:
        spec = self.spec
        algo = make_algorithm(spec)
        self._check_capabilities(algo)
        train = spec.train
        later = "is not ported yet: ROADMAP Queue 1 item 12"
        if train.trace_dir:
            raise NotImplementedError(
                f"train.trace_dir {later} (obs/export.py, obs/metrics.py)")
        if train.snapshot_every:
            raise NotImplementedError(
                f"train.snapshot_every {later} (fleet/snapshot.py)")
        bindings = self.build_bindings()

        history: List[Tuple[int, Dict[str, float]]] = []
        step_seconds = 0.0
        try:
            algo.setup(bindings)
            for t in range(train.steps):
                t0 = time.perf_counter()
                metrics = algo.step(t)
                step_seconds += time.perf_counter() - t0
                if on_step is not None:
                    on_step(t, metrics)
                if train.eval_every and (t + 1) % train.eval_every == 0:
                    ev = algo.evaluate(bindings.test_arrays)
                    history.append((t + 1, ev))
                    if on_eval is not None:
                        on_eval(t + 1, ev)
                if train.checkpoint_dir and train.checkpoint_every and \
                        (t + 1) % train.checkpoint_every == 0:
                    algo.save(train.checkpoint_dir, t + 1)

            if not history or history[-1][0] != train.steps:
                ev = algo.evaluate(bindings.test_arrays)
                history.append((train.steps, ev))
                if on_eval is not None:
                    on_eval(train.steps, ev)
            if train.checkpoint_dir and not (
                    train.checkpoint_every and
                    train.steps % train.checkpoint_every == 0):
                algo.save(train.checkpoint_dir, train.steps)
        finally:
            if bindings.transport is not None:
                bindings.transport.close()

        metrics = dict(history[-1][1])
        metrics.update(_comm_metrics(algo))
        return ExperimentResult(
            spec=spec, metrics=metrics, history=history,
            us_per_step=step_seconds / max(train.steps, 1) * 1e6,
            algorithm=algo)


def _comm_metrics(algo: Algorithm) -> Dict[str, float]:
    """Fold the comm meter into the unified namespace (prediction modes)."""
    meter = getattr(getattr(algo, "trainer", None), "meter", None)
    if meter is None:
        return {}
    out = {"comm/total_bytes": float(meter.total_bytes),
           "comm/delivered_bytes": float(meter.delivered_bytes),
           "comm/rejected_publishes": float(meter.rejected_publishes),
           "comm/tombstoned_bytes": float(meter.tombstoned_bytes)}
    for cid, g in meter.gate_summary().items():
        out[f"c{cid}/comm/fresh_teachers"] = float(g["fresh"])
        out[f"c{cid}/comm/stale_teachers"] = float(g["stale"])
    return out


def run_spec(spec: ExperimentSpec,
             data: Optional[DataTriple] = None,
             device: Optional[Any] = None,
             **run_kw) -> ExperimentResult:
    """Convenience one-liner."""
    return Experiment(spec, data=data, device=device).run(**run_kw)
