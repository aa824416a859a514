"""repro_torch.exp — the declarative Experiment API, in PyTorch (port of
``repro.exp``, with the same public names).

One serializable `ExperimentSpec`, one `Algorithm` protocol, one
`Experiment.run()` runner for all four algorithms the paper compares:
MHD (the synchronous loop), FedMD, FedAvg, and supervised
(pooled/separate). Topology, transport and wire format are spec edits,
not new harnesses; results separate JSON-serializable metrics from
out-of-band live objects (trainer, transport). Runs on the GPU unless
``device="cpu"`` is passed.

    from repro_torch.exp import Experiment, get_preset
    result = Experiment(get_preset("quick")).run()
    print(result.metrics["mean/aux3/beta_sh"])

Importing this package registers the four paper adapters in
``ALGORITHMS`` and the named presets in ``PRESETS``.
"""
from repro_torch.exp.spec import (
    CLIENT_ARCHS,
    TRANSPORTS,
    AlgorithmSpec,
    ChurnEventSpec,
    ChurnSpec,
    ClientSpec,
    DataSpec,
    ExperimentSpec,
    OptimizerSpec,
    PartitionSpec,
    ScheduleSpec,
    ServeSpec,
    TopologySpec,
    TrainSpec,
    TransportSpec,
    WireSpec,
)
from repro_torch.exp.algorithm import (
    ALGORITHMS,
    Algorithm,
    Bindings,
    Capabilities,
    make_algorithm,
)
from repro_torch.exp import adapters as _adapters  # noqa: F401 (registers)
from repro_torch.exp.runner import (
    Experiment,
    ExperimentResult,
    build_bundles,
    build_graph,
    build_optimizer,
    build_transport,
    materialize_data,
    run_spec,
)
from repro_torch.exp.presets import PRESETS, get_preset, preset_names

__all__ = [
    "ALGORITHMS",
    "Algorithm",
    "AlgorithmSpec",
    "Bindings",
    "CLIENT_ARCHS",
    "Capabilities",
    "ChurnEventSpec",
    "ChurnSpec",
    "ClientSpec",
    "DataSpec",
    "Experiment",
    "ExperimentResult",
    "ExperimentSpec",
    "OptimizerSpec",
    "PRESETS",
    "PartitionSpec",
    "ScheduleSpec",
    "ServeSpec",
    "TRANSPORTS",
    "TopologySpec",
    "TrainSpec",
    "TransportSpec",
    "WireSpec",
    "build_bundles",
    "build_graph",
    "build_optimizer",
    "build_transport",
    "get_preset",
    "make_algorithm",
    "materialize_data",
    "preset_names",
    "run_spec",
]
