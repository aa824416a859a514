"""FedAvg baseline (McMahan et al., 2017) — the paper's Table 1 comparison,
in PyTorch (port of ``repro/core/fedavg.py``).

K clients with *identical* architectures train locally; every ``u`` steps
parameters are averaged leaf by leaf (`common.pytree.tree_mean`: summed in
float32 left to right, then scaled — the reference's order) and every
client's optimizer state is reset. Private batches come from the
`client_stream_seed` streams every algorithm shares.

Runs on the GPU unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.common.pytree import tree_mean
from repro_torch.core.evaluation import (
    fleet_beta_metrics,
    label_histogram,
    per_label_head_accuracy,
)
from repro_torch.core.runtime import (batch_to_device, init_fleet,
                                      read_metrics)
from repro_torch.core.supervised import make_train_step
from repro_torch.data.pipeline import BatchIterator, client_stream_seed
from repro_torch.models.zoo import ModelBundle
from repro_torch.optim.optimizers import Optimizer


class FedAvgTrainer:
    """Stepwise FedAvg: local SGD + periodic exact parameter averaging."""

    def __init__(
        self,
        bundle: ModelBundle,
        optimizer: Optimizer,
        arrays: Dict[str, np.ndarray],
        client_indices: Sequence[np.ndarray],
        num_labels: Optional[int] = None,
        batch_size: int = 32,
        average_every: int = 200,  # the paper's u
        seed: int = 0,
        eval_batch_size: int = 256,
        device: Optional[Any] = None,
    ):
        self.device = resolve_device(device)
        self.bundle = bundle
        self.optimizer = optimizer
        if num_labels is None:
            num_labels = int(arrays["labels"].max()) + 1
        self.num_labels = num_labels
        self.average_every = average_every
        self.eval_batch_size = eval_batch_size
        K = len(client_indices)
        params = init_fleet([bundle], seed, self.device)[0]  # common init
        self.client_params: List[Any] = [params for _ in range(K)]
        self.opt_states: List[Any] = [optimizer.init(params)
                                      for _ in range(K)]
        self.iters = [BatchIterator(arrays, idx, batch_size,
                                    seed=client_stream_seed(seed, i))
                      for i, idx in enumerate(client_indices)]
        self.label_hists = [label_histogram(arrays["labels"], idx, num_labels)
                            for idx in client_indices]
        self._train_step = make_train_step(bundle, optimizer)

    @property
    def num_clients(self) -> int:
        return len(self.client_params)

    @property
    def averaged_params(self) -> Any:
        """The current global model (exact leafwise mean)."""
        return tree_mean(self.client_params)

    def step(self, t: int) -> Dict[str, float]:
        out: Dict[str, torch.Tensor] = {}
        for i in range(self.num_clients):
            batch = batch_to_device(self.iters[i].next(), self.device)
            self.client_params[i], self.opt_states[i], metrics = \
                self._train_step(self.client_params[i], self.opt_states[i],
                                 batch, t)
            out.update({f"c{i}/{k}": v for k, v in metrics.items()})
        out = read_metrics(out)
        if (t + 1) % self.average_every == 0:
            avg = self.averaged_params
            self.client_params = [avg for _ in range(self.num_clients)]
            # momentum is client-local state; FedAvg resets it on aggregation
            self.opt_states = [self.optimizer.init(avg)
                               for _ in range(self.num_clients)]
            out["fedavg/averaged"] = 1.0
        return out

    def evaluate(self, arrays: Dict[str, np.ndarray]) -> Dict[str, float]:
        """Evaluate the *global* (averaged) model; per-client rows weight
        its per-label accuracy by each client's private histogram."""
        per_label, present = per_label_head_accuracy(
            self.bundle.apply, self.averaged_params, arrays,
            self.num_labels, num_aux_heads=0,
            batch_size=self.eval_batch_size)
        per_client = [(i, per_label, present, self.label_hists[i])
                      for i in range(self.num_clients)]
        return fleet_beta_metrics(per_client, num_aux_heads=0)

    def save(self, directory: str, step: int) -> None:
        from repro_torch.checkpoint.io import save_client_states

        save_client_states(directory, step,
                           zip(self.client_params, self.opt_states))

    def restore(self, directory: str, step: Optional[int] = None) -> int:
        from repro_torch.checkpoint.io import restore_client_states

        restored, states = restore_client_states(
            directory, zip(self.client_params, self.opt_states), step)
        self.client_params = [p for p, _ in states]
        self.opt_states = [s for _, s in states]
        return restored


def train_fedavg(
    bundle: ModelBundle,
    optimizer: Optimizer,
    arrays: Dict[str, np.ndarray],
    client_indices: Sequence[np.ndarray],
    steps: int,
    batch_size: int,
    average_every: int = 200,
    seed: int = 0,
    device: Optional[Any] = None,
) -> Any:
    """One-call wrapper: run ``steps`` rounds, return the averaged params."""
    trainer = FedAvgTrainer(bundle, optimizer, arrays, client_indices,
                            batch_size=batch_size,
                            average_every=average_every, seed=seed,
                            device=device)
    for t in range(steps):
        trainer.step(t)
    return trainer.averaged_params
