"""The paper's primary contribution in PyTorch: Multi-Headed Distillation
for decentralized learning (the baselines are a later slice)."""
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

__all__ = [
    "DecentralizedTrainer",
    "MHDConfig",
    "RunConfig",
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
]
