"""Supervised trainer — the paper's 'Supervised' upper bound and the
'Separate' baseline (each client trained in isolation on its shard), in
PyTorch (port of ``repro/core/supervised.py``).

`SupervisedTrainer` is the stepwise form the `repro_torch.exp` Algorithm
protocol drives: ``scope="pooled"`` trains one model on the union of all
private shards (the upper bound), ``scope="separate"`` trains one model
per client on its own shard with no communication (the lower bound).

Runs on the GPU unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.evaluation import (
    fleet_beta_metrics,
    label_histogram,
    per_label_head_accuracy,
)
from repro_torch.core.runtime import (batch_to_device, init_fleet,
                                      read_metrics)
from repro_torch.data.pipeline import BatchIterator, client_stream_seed
from repro_torch.models.zoo import ModelBundle
from repro_torch.optim.optimizers import Optimizer

Tensor = torch.Tensor


def make_train_step(bundle: ModelBundle, optimizer: Optimizer) -> Callable:
    """(params, opt_state, batch, step) -> (params, opt_state, metrics): one
    optimizer step on ``bundle.loss``; metrics stay on the device."""

    def train_step(params, opt_state, batch, step):
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss, metrics = bundle.loss(p, batch)
        grads = torch.autograd.grad(loss, list(p.values()),
                                    allow_unused=True, materialize_grads=True)
        params, opt_state = optimizer.update(dict(zip(p, grads)), opt_state,
                                             params, step)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return train_step


def train_supervised(
    bundle: ModelBundle,
    optimizer: Optimizer,
    arrays: Dict[str, np.ndarray],
    indices: np.ndarray,
    steps: int,
    batch_size: int,
    seed: int = 0,
    params: Any = None,
    device: Optional[Any] = None,
):
    """Train one model on the given index subset; returns trained params."""
    dev = resolve_device(device)
    if params is None:
        params = init_fleet([bundle], seed, dev)[0]
    opt_state = optimizer.init(params)
    it = BatchIterator(arrays, indices, batch_size, seed=seed)
    train_step = make_train_step(bundle, optimizer)
    for t in range(steps):
        params, opt_state, _ = train_step(
            params, opt_state, batch_to_device(it.next(), dev), t)
    return params


class SupervisedTrainer:
    """Stepwise supervised training over a client fleet.

    ``scope="pooled"``   — one model (bundles[0]) on all private shards.
    ``scope="separate"`` — K isolated models, one per client shard; model
    inits follow the decentralized trainer's generator chain and the
    private-batch streams come from `client_stream_seed`, so 'Separate'
    is MHD with the distillation terms removed — sample order included.
    """

    def __init__(
        self,
        bundles: Sequence[ModelBundle],
        optimizer: Optimizer,
        arrays: Dict[str, np.ndarray],
        client_indices: Sequence[np.ndarray],
        num_labels: Optional[int] = None,
        batch_size: int = 32,
        scope: str = "separate",
        seed: int = 0,
        eval_batch_size: int = 256,
        device: Optional[Any] = None,
    ):
        if scope not in ("pooled", "separate"):
            raise ValueError(f"unknown supervised scope {scope!r}")
        self.device = resolve_device(device)
        self.scope = scope
        self.optimizer = optimizer
        if num_labels is None:
            num_labels = int(arrays["labels"].max()) + 1
        self.num_labels = num_labels
        self.eval_batch_size = eval_batch_size
        if scope == "pooled":
            if any(b.config != bundles[0].config for b in bundles[1:]):
                raise ValueError(
                    "scope='pooled' trains ONE model on the pooled shards; "
                    f"got a heterogeneous fleet "
                    f"{sorted({b.name for b in bundles})} — pick one "
                    "architecture or use scope='separate'")
            self.bundles = [bundles[0]]
            indices = [np.concatenate(list(client_indices))]
        else:
            self.bundles = list(bundles)
            indices = list(client_indices)
        self.params: List[Any] = init_fleet(self.bundles, seed, self.device)
        self.opt_states: List[Any] = [optimizer.init(p) for p in self.params]
        self.iters = [BatchIterator(arrays, idx, batch_size,
                                    seed=client_stream_seed(seed, i))
                      for i, idx in enumerate(indices)]
        self.label_hists = [label_histogram(arrays["labels"], idx, num_labels)
                            for idx in indices]
        self._train_steps = {b.name: make_train_step(b, optimizer)
                             for b in self.bundles}

    @property
    def num_models(self) -> int:
        return len(self.bundles)

    def step(self, t: int) -> Dict[str, float]:
        out: Dict[str, Tensor] = {}
        for i, b in enumerate(self.bundles):
            batch = batch_to_device(self.iters[i].next(), self.device)
            self.params[i], self.opt_states[i], metrics = \
                self._train_steps[b.name](self.params[i], self.opt_states[i],
                                          batch, t)
            out.update({f"c{i}/{k}": v for k, v in metrics.items()})
        return read_metrics(out)

    def evaluate(self, arrays: Dict[str, np.ndarray]) -> Dict[str, float]:
        per_client = []
        for i, b in enumerate(self.bundles):
            per_label, present = per_label_head_accuracy(
                b.apply, self.params[i], arrays, self.num_labels,
                num_aux_heads=0, batch_size=self.eval_batch_size)
            per_client.append((i, per_label, present, self.label_hists[i]))
        return fleet_beta_metrics(per_client, num_aux_heads=0)

    def save(self, directory: str, step: int) -> None:
        from repro_torch.checkpoint.io import save_client_states

        save_client_states(directory, step,
                           zip(self.params, self.opt_states))

    def restore(self, directory: str, step: Optional[int] = None) -> int:
        from repro_torch.checkpoint.io import restore_client_states

        restored, states = restore_client_states(
            directory, zip(self.params, self.opt_states), step)
        self.params = [p for p, _ in states]
        self.opt_states = [s for _, s in states]
        return restored


@torch.no_grad()
def eval_per_label_accuracy(bundle: ModelBundle, params, arrays, num_labels,
                            batch_size: int = 256, head: str = "main"):
    """Per-label accuracy vector over a test set (main head, or aux head
    ``"aux<h>"``), on the device that holds ``params``. Returns
    ``(per_label, present)``."""
    device = next(iter(params.values())).device
    labels = arrays["labels"]
    correct = np.zeros(num_labels)
    count = np.zeros(num_labels)
    for s in range(0, labels.shape[0], batch_size):
        batch = batch_to_device({k: v[s:s + batch_size]
                                 for k, v in arrays.items()
                                 if k != "labels"}, device)
        out = bundle.apply(params, batch)
        logits = out["logits"] if head == "main" \
            else out["aux_logits"][int(head[3:]) - 1]
        pred = logits.argmax(-1).cpu().numpy()
        lab = labels[s:s + batch_size]
        np.add.at(count, lab, 1)
        np.add.at(correct, lab[pred == lab], 1)
    per_label = correct / np.maximum(count, 1)
    return per_label, count > 0
