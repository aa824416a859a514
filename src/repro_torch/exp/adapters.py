"""Adapters registering the four paper algorithms behind the `Algorithm`
protocol (port of ``repro/exp/adapters.py``).

Each adapter translates spec blocks into one concrete trainer's
constructor, on ``Bindings.device``, and forwards the
step/evaluate/save surface:

  mhd         -> `core.runtime.DecentralizedTrainer` (sync)
  fedmd       -> `core.fedmd.FedMDTrainer` (central consensus server)
  fedavg      -> `core.fedavg.FedAvgTrainer` (weight averaging)
  supervised  -> `core.supervised.SupervisedTrainer` (pooled | separate)

Unknown ``AlgorithmSpec.params`` keys raise — a typo'd knob must never
silently run the default. What the reference runs and the port does not
yet — the lockstep and scoreboard schedules, churn timelines, a subset of
the fleet per process (``local_clients``), ``init_scheme="per_client"``,
the staleness gate and the fleet snapshots — raises NotImplementedError
naming its ROADMAP item; nothing falls back quietly to the sync loop.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


from repro_torch.core.mhd import MHDConfig
from repro_torch.exp.algorithm import ALGORITHMS, Bindings, Capabilities
from repro_torch.exp.spec import ExperimentSpec

_FLEET_LAYERS = ("ROADMAP Queue 1 item 12 (core/scheduler.py, fleet/ and "
                 "the trainer's fleet methods)")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: {_FLEET_LAYERS}")


def _take_params(spec: ExperimentSpec, allowed: Dict[str, Any],
                 kind: str) -> Dict[str, Any]:
    """Overlay spec params on the adapter's defaults, rejecting unknowns."""
    params = dict(spec.algorithm.params)
    unknown = set(params) - set(allowed)
    if unknown:
        raise ValueError(
            f"unknown {kind} params {sorted(unknown)}; "
            f"known: {sorted(allowed)}")
    out = dict(allowed)
    out.update(params)
    return out


class _AdapterBase:
    """Common scaffolding: hold the spec, delegate to ``self.trainer``.

    ``_require_whole_fleet`` guards ``Bindings.local_clients``: only
    decentralized algorithms can drive a subset of the fleet from one
    process; centralized baselines must fail loudly instead of silently
    training the whole fleet in every process.

    Everything validatable from the spec alone happens at construction
    (``_resolve_params``), so `make_algorithm(spec)` — and therefore the
    CLI's ``--dry-run`` — rejects typo'd knobs and impossible fleets
    without building data or models; ``setup`` only binds resources."""

    name: str = ""
    capabilities = Capabilities()

    def __init__(self, spec: ExperimentSpec):
        self.spec = spec
        self.trainer: Any = None
        self.params = self._resolve_params(spec)

    def _resolve_params(self, spec: ExperimentSpec) -> Dict[str, Any]:
        return _take_params(spec, {}, self.name)

    def _require_whole_fleet(self, bindings: Bindings) -> None:
        if bindings.local_clients is not None:
            raise ValueError(
                f"algorithm {self.name!r} has a central aggregation step "
                "and cannot drive a subset of the fleet per process "
                "(Bindings.local_clients)")

    def step(self, t: int) -> Dict[str, float]:
        return self.trainer.step(t)

    def evaluate(self, arrays) -> Dict[str, float]:
        return self.trainer.evaluate(arrays)

    def save(self, directory: str, step: int) -> None:
        self.trainer.save(directory, step)

    def restore(self, directory: str, step: Optional[int] = None) -> int:
        return self.trainer.restore(directory, step)

    # -- fleet snapshots (the reference's repro.fleet.snapshot) ----------

    def snapshot(self, directory: str, step: int) -> None:
        raise _not_ported("the fleet snapshot (TrainSpec.snapshot_every)")

    def restore_snapshot(self, directory: str,
                         step: Optional[int] = None) -> int:
        raise _not_ported("the fleet snapshot (restore_snapshot)")


@ALGORITHMS.register("mhd")
class MHDAdapter(_AdapterBase):
    """The paper's Multi-Headed Distillation runtime, the synchronous loop
    (the capabilities are the reference's: the spec checks stay the
    same, and what the port lacks raises at setup)."""

    name = "mhd"
    capabilities = Capabilities(needs_public_pool=True, supports_async=True,
                                heterogeneous_clients=True,
                                uses_topology=True, decentralized=True,
                                elastic=True)

    MHD_DEFAULTS = {f.name: f.default
                    for f in dataclasses.fields(MHDConfig)}

    def __init__(self, spec: ExperimentSpec):
        super().__init__(spec)
        self.transport = None

    def _resolve_params(self, spec: ExperimentSpec) -> Dict[str, Any]:
        defaults = dict(self.MHD_DEFAULTS)
        # fleet and distillation config must agree on the head chain
        defaults["num_aux_heads"] = spec.clients[0].aux_heads
        params = _take_params(spec, defaults, "mhd")
        # the loss stacks per-level head outputs — every model must carry
        # exactly the configured chain (mhd_total_loss asserts equality)
        off = [i for i, c in enumerate(spec.clients)
               if c.aux_heads != params["num_aux_heads"]]
        if off:
            raise ValueError(
                f"mhd distills through {params['num_aux_heads']} aux heads "
                f"but clients {off} declare a different count; every "
                "ClientSpec.aux_heads must equal num_aux_heads")
        return params

    def setup(self, bindings: Bindings) -> None:
        from repro_torch.core import DecentralizedTrainer, RunConfig

        spec = self.spec
        if spec.schedule.mode != "sync":
            raise _not_ported(f"schedule mode {spec.schedule.mode!r}")
        if spec.churn.events:
            raise _not_ported("a churn timeline (ChurnSpec.events)")
        if bindings.local_clients is not None:
            raise _not_ported("driving a subset of the fleet per process "
                              "(Bindings.local_clients)")
        if spec.init_scheme != "legacy":
            raise _not_ported(f"init_scheme {spec.init_scheme!r}")
        if spec.train.max_staleness is not None:
            raise _not_ported("the staleness gate (train.max_staleness)")
        mhd_cfg = MHDConfig(**self.params)
        run_cfg = RunConfig(
            steps=spec.train.steps, batch_size=spec.train.batch_size,
            public_batch_size=spec.train.public_batch_size,
            eval_every=0,  # the runner owns eval cadence
            eval_batch_size=spec.train.eval_batch_size,
            seed=spec.train.seed)
        comm_cfg = None
        if spec.wire.exchange != "params":
            from repro_torch.comm import CommConfig

            comm_cfg = CommConfig(
                topk=spec.wire.topk, val_dtype=spec.wire.val_dtype,
                emb_encoding=spec.wire.emb_encoding, tail=spec.wire.tail,
                horizon=spec.wire.horizon,
                budget_bytes_per_token=spec.wire.budget_bytes_per_token,
                compression=spec.wire.compression)
        self.transport = bindings.transport
        self.trainer = DecentralizedTrainer(
            bindings.bundles, bindings.optimizer, mhd_cfg, run_cfg,
            bindings.arrays, bindings.partition.client_indices,
            bindings.partition.public_indices, bindings.graph,
            bindings.num_labels, exchange=spec.wire.exchange,
            comm=comm_cfg, transport=bindings.transport,
            device=bindings.device)


@ALGORITHMS.register("fedmd")
class FedMDAdapter(_AdapterBase):
    """Centralized consensus distillation (Li & Wang, 2019)."""

    name = "fedmd"
    capabilities = Capabilities(needs_public_pool=True,
                                heterogeneous_clients=True)

    def _resolve_params(self, spec: ExperimentSpec) -> Dict[str, Any]:
        return _take_params(
            spec, {"digest_weight": 1.0, "public_batch_size": None},
            "fedmd")

    def setup(self, bindings: Bindings) -> None:
        from repro_torch.core.fedmd import FedMDTrainer

        self._require_whole_fleet(bindings)
        spec = self.spec
        public_bs = self.params["public_batch_size"]
        self.trainer = FedMDTrainer(
            bindings.bundles, bindings.optimizer, bindings.arrays,
            bindings.partition.client_indices,
            bindings.partition.public_indices, bindings.num_labels,
            batch_size=spec.train.batch_size,
            public_batch_size=(spec.train.public_batch_size
                               if public_bs is None else int(public_bs)),
            digest_weight=float(self.params["digest_weight"]),
            seed=spec.train.seed,
            eval_batch_size=spec.train.eval_batch_size,
            device=bindings.device)


@ALGORITHMS.register("fedavg")
class FedAvgAdapter(_AdapterBase):
    """Weight aggregation (McMahan et al., 2017); identical archs only."""

    name = "fedavg"
    capabilities = Capabilities()

    def _resolve_params(self, spec: ExperimentSpec) -> Dict[str, Any]:
        if len(set(spec.clients)) > 1:
            raise ValueError(
                "fedavg averages parameters — every ClientSpec in the "
                f"fleet must be identical, got {spec.clients}")
        return _take_params(spec, {"average_every": 200}, "fedavg")

    def setup(self, bindings: Bindings) -> None:
        from repro_torch.core.fedavg import FedAvgTrainer

        self._require_whole_fleet(bindings)
        spec = self.spec
        self.trainer = FedAvgTrainer(
            bindings.bundles[0], bindings.optimizer, bindings.arrays,
            bindings.partition.client_indices, bindings.num_labels,
            batch_size=spec.train.batch_size,
            average_every=int(self.params["average_every"]),
            seed=spec.train.seed,
            eval_batch_size=spec.train.eval_batch_size,
            device=bindings.device)


@ALGORITHMS.register("supervised")
class SupervisedAdapter(_AdapterBase):
    """'Supervised' upper bound (scope="pooled") and the 'Separate'
    isolated baseline (scope="separate")."""

    name = "supervised"
    capabilities = Capabilities(heterogeneous_clients=True)

    def _resolve_params(self, spec: ExperimentSpec) -> Dict[str, Any]:
        params = _take_params(spec, {"scope": "separate"}, "supervised")
        if params["scope"] == "pooled" and len(set(spec.clients)) > 1:
            raise ValueError(
                "supervised scope='pooled' trains one model — the fleet "
                f"must be uniform, got {spec.clients}; use "
                "scope='separate' for heterogeneous fleets")
        return params

    def setup(self, bindings: Bindings) -> None:
        from repro_torch.core.supervised import SupervisedTrainer

        self._require_whole_fleet(bindings)
        spec = self.spec
        self.trainer = SupervisedTrainer(
            bindings.bundles, bindings.optimizer, bindings.arrays,
            bindings.partition.client_indices, bindings.num_labels,
            batch_size=spec.train.batch_size,
            scope=str(self.params["scope"]), seed=spec.train.seed,
            eval_batch_size=spec.train.eval_batch_size,
            device=bindings.device)
