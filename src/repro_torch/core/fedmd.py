"""FedMD-style baseline (Li & Wang, 2019 [19]) — the paper's Table 2
comparison, *centralized* distillation via consensus scores, in PyTorch
(port of ``repro/core/fedmd.py``).

Each round: every client scores the public batch; the server averages the
class probabilities into a consensus (detached); each client then takes
one gradient step on its private CE plus the digest term, the consensus'
cross-entropy against its own public-batch log-softmax. Unlike MHD there
is no confidence gating, no aux-head chain, and a central aggregator is
required. Private batches come from the `client_stream_seed` streams
every algorithm shares.

Runs on the GPU unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

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
from repro_torch.data.pipeline import (BatchIterator, PublicPool,
                                       client_stream_seed)
from repro_torch.models.zoo import ModelBundle
from repro_torch.optim.optimizers import Optimizer


class FedMDTrainer:
    """Stepwise FedMD: heterogeneous clients + a central consensus server."""

    def __init__(
        self,
        bundles: Sequence[ModelBundle],
        optimizer: Optimizer,
        arrays: Dict[str, np.ndarray],
        client_indices: Sequence[np.ndarray],
        public_indices: np.ndarray,
        num_labels: Optional[int] = None,
        batch_size: int = 32,
        public_batch_size: int = 64,
        digest_weight: float = 1.0,
        seed: int = 0,
        eval_batch_size: int = 256,
        device: Optional[Any] = None,
    ):
        self.device = resolve_device(device)
        self.bundles = list(bundles)
        self.optimizer = optimizer
        if num_labels is None:
            num_labels = int(arrays["labels"].max()) + 1
        self.num_labels = num_labels
        self.digest_weight = digest_weight
        self.eval_batch_size = eval_batch_size
        self.params: List[Any] = init_fleet(self.bundles, seed, self.device)
        self.opt_states: List[Any] = [optimizer.init(p) for p in self.params]
        self.iters = [BatchIterator(arrays, idx, batch_size,
                                    seed=client_stream_seed(seed, i))
                      for i, idx in enumerate(client_indices)]
        self.public = PublicPool(arrays, public_indices, public_batch_size,
                                 seed=seed)
        self.label_hists = [label_histogram(arrays["labels"], idx, num_labels)
                            for idx in client_indices]

    @property
    def num_clients(self) -> int:
        return len(self.bundles)

    def _update(self, b: ModelBundle, p, s, private_batch, public_batch,
                consensus, step: int):
        params = {k: v.detach().requires_grad_() for k, v in p.items()}
        lg = b.apply(params, private_batch)["logits"].float()
        ll = lg.gather(-1, private_batch["labels"].long()[:, None])[:, 0]
        ce = (torch.logsumexp(lg, -1) - ll).mean()
        logp = torch.log_softmax(
            b.apply(params, public_batch)["logits"].float(), -1)
        digest = -(consensus * logp).sum(-1).mean()
        loss = ce + self.digest_weight * digest
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True, materialize_grads=True)
        p, s = self.optimizer.update(dict(zip(params, grads)), s, p, step)
        return p, s, {"ce": ce, "digest": digest, "loss": loss}

    def step(self, t: int) -> Dict[str, float]:
        """One round: server consensus on the step-t public batch, then one
        digest+revisit gradient step per client."""
        public_batch = batch_to_device(self.public.sample(t), self.device)
        with torch.no_grad():
            probs = [torch.softmax(b.apply(p, public_batch)["logits"].float(),
                                   -1)
                     for b, p in zip(self.bundles, self.params)]
            consensus = torch.stack(probs, 0).mean(0)
        out: Dict[str, torch.Tensor] = {}
        for i, b in enumerate(self.bundles):
            private_batch = batch_to_device(self.iters[i].next(), self.device)
            self.params[i], self.opt_states[i], metrics = self._update(
                b, self.params[i], self.opt_states[i], private_batch,
                public_batch, consensus, t)
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


def train_fedmd(
    bundles: Sequence[ModelBundle],
    optimizer: Optimizer,
    arrays: Dict[str, np.ndarray],
    client_indices: Sequence[np.ndarray],
    public_indices: np.ndarray,
    steps: int,
    batch_size: int,
    public_batch_size: int = 64,
    digest_weight: float = 1.0,
    seed: int = 0,
    device: Optional[Any] = None,
) -> List[Any]:
    """One-call wrapper: run ``steps`` rounds, return final params."""
    trainer = FedMDTrainer(bundles, optimizer, arrays, client_indices,
                           public_indices,
                           batch_size=batch_size,
                           public_batch_size=public_batch_size,
                           digest_weight=digest_weight, seed=seed,
                           device=device)
    for t in range(steps):
        trainer.step(t)
    return trainer.params
