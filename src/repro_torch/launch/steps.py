"""Step functions of the training and serving launchers (port of
``repro/launch/steps.py``).

 * ``train_step``   — loss + autograd + the optimizer's update
                      (SGD-momentum default, the paper's optimizer; AdamW
                      selectable).
 * ``prefill_step`` — forward over the full prompt; returns the last
                      position's logits.
 * ``serve_step``   — one-token decode against a KV/state cache.

A train state is ``{"params", "opt", "step"}`` as the reference's, with
``step`` a Python int. ``train_step(state, batch)`` returns ``(new_state,
{"loss", **metrics})``; the metrics stay 0-d tensors on the state's device
(read them with ``float``, which waits for the card). It consumes
``state``: the port's optimizer takes each leaf of the gradients and of
the old moments out of their dicts as it makes the new one, so a step
holds four copies of the params (params, grads, two AdamW moments) and
one leaf's transient, not two of everything.

``train_state_shapes`` and ``mhd_train_step`` come with the dry-run
(ROADMAP Queue 1 item 15).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Union

import torch

from repro_torch import resolve_device
from repro_torch.models.zoo import ModelBundle
from repro_torch.optim.optimizers import Optimizer


def make_train_step(bundle: ModelBundle, optimizer: Optimizer) -> Callable:
    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        params = {k: v.detach().requires_grad_()
                  for k, v in state["params"].items()}
        loss, metrics = bundle.loss(params, batch)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()), allow_unused=True,
            materialize_grads=True)))
        out = {"loss": loss.detach(),
               **{k: v.detach() for k, v in metrics.items()}}
        del loss, metrics
        params = {k: v.detach() for k, v in params.items()}
        new_params, opt = optimizer.update(grads, state["opt"], params,
                                           state["step"])
        new_state = {"params": new_params, "opt": opt,
                     "step": state["step"] + 1}
        return new_state, out

    return train_step


def make_prefill_step(bundle: ModelBundle) -> Callable:
    def prefill_step(params, batch):
        # the main head only: the reference's jit drops the unread rest
        out = bundle.apply(params, batch, mtp=False)
        return out["logits"][:, -1, :]  # next-token logits only

    return prefill_step


def make_serve_step(bundle: ModelBundle) -> Callable:
    def serve_step(params, batch):
        logits, caches = bundle.decode_step(params, batch["token"],
                                            batch["caches"])
        return logits[:, -1, :], caches

    return serve_step


def init_train_state(bundle: ModelBundle, optimizer: Optimizer,
                     seed: int = 0,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> Dict[str, Any]:
    """The bundle's params drawn from ``seed`` on ``device`` (``None`` →
    the card): an LM's with a generator on that device, so a full-width
    model is drawn on the card (a CPU generator gives `init_lm`'s CPU
    draws); a ResNet's on the CPU, then moved. Plus the optimizer's
    state and step 0."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev if bundle.is_lm else "cpu")
    params = {k: v.to(dev) for k, v in
              bundle.init(gen.manual_seed(seed)).items()}
    return {"params": params, "opt": optimizer.init(params), "step": 0}
