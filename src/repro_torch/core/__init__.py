"""The paper's primary contribution in PyTorch: Multi-Headed Distillation
for decentralized learning, plus its baselines (FedAvg, FedMD,
supervised)."""
from repro_torch.core.evaluation import (
    fleet_beta_metrics,
    label_histogram,
    per_label_head_accuracy,
)
from repro_torch.core.graph import (
    chain_graph,
    complete_graph,
    cycle_graph,
    graph_distance_matrix,
    islands_graph,
    isolated_graph,
)
from repro_torch.core.mhd import (
    MHDConfig,
    embedding_distillation_loss,
    mhd_total_loss,
    multi_head_distillation_loss,
    normalized,
)
from repro_torch.core.runtime import DecentralizedTrainer, RunConfig
from repro_torch.core.scheduler import (
    AsyncScheduler,
    GossipPacer,
    ScheduleConfig,
    Scoreboard,
    ScoreboardScheduler,
    run_async,
)
from repro_torch.core.fedavg import FedAvgTrainer, train_fedavg
from repro_torch.core.fedmd import FedMDTrainer, train_fedmd
from repro_torch.core.supervised import SupervisedTrainer, train_supervised

__all__ = [
    "AsyncScheduler",
    "DecentralizedTrainer",
    "FedAvgTrainer",
    "FedMDTrainer",
    "GossipPacer",
    "MHDConfig",
    "RunConfig",
    "ScheduleConfig",
    "Scoreboard",
    "ScoreboardScheduler",
    "SupervisedTrainer",
    "chain_graph",
    "complete_graph",
    "cycle_graph",
    "embedding_distillation_loss",
    "fleet_beta_metrics",
    "graph_distance_matrix",
    "islands_graph",
    "isolated_graph",
    "label_histogram",
    "mhd_total_loss",
    "multi_head_distillation_loss",
    "normalized",
    "per_label_head_accuracy",
    "run_async",
    "train_fedavg",
    "train_fedmd",
    "train_supervised",
]
