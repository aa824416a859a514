"""Step functions of the training and serving launchers (port of
``repro/launch/steps.py``).

 * ``train_step``   — loss + autograd + the optimizer's update
                      (SGD-momentum default, the paper's optimizer; AdamW
                      selectable).
 * ``prefill_step`` — forward over the full prompt; returns the last
                      position's logits.
 * ``serve_step``   — one-token decode against a KV/state cache.
 * ``mhd_train_step`` — the paper's technique on LM clients: one student
                      update with Δ teachers' predictions distilled on a
                      public batch (teacher params are explicit inputs,
                      their forwards run inside the step without
                      gradients).

A train state is ``{"params", "opt", "step"}`` as the reference's, with
``step`` a Python int. ``train_step(state, batch)`` returns ``(new_state,
{"loss", **metrics})``; the metrics stay 0-d tensors on the state's device
(read them with ``float``, which waits for the card). It consumes
``state``: the port's optimizer takes each leaf of the gradients and of
the old moments out of their dicts as it makes the new one, so a step
holds four copies of the params (params, grads, two AdamW moments) and
one leaf's transient, not two of everything.

``train_state_shapes`` gives a train state on the ``meta`` device: the
shapes and dtypes of params, optimizer state and step, with nothing
allocated (the reference's ``eval_shape``), for the dry run. The pod
runtime's fused step is `core.mhd_distributed.make_distributed_mhd_step`.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch import resolve_device
from repro_torch.core.mhd import MHDConfig
from repro_torch.models import transformer as TF
from repro_torch.models.layers import MetaDraw
from repro_torch.models.zoo import ModelBundle
from repro_torch.optim.optimizers import Optimizer


def _descend(optimizer: Optimizer, state: Dict[str, Any],
             loss_fn: Callable) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``loss_fn(params) -> (loss, metrics)``, its gradients and the
    optimizer's update: (new state, {"loss", **metrics}). Consumes
    ``state``."""
    params = {k: v.detach().requires_grad_()
              for k, v in state["params"].items()}
    loss, metrics = loss_fn(params)
    grads = dict(zip(params, torch.autograd.grad(
        loss, list(params.values()), allow_unused=True,
        materialize_grads=True)))
    out = {"loss": loss.detach(),
           **{k: v.detach() for k, v in metrics.items()}}
    del loss, metrics
    params = {k: v.detach() for k, v in params.items()}
    new_params, opt = optimizer.update(grads, state["opt"], params,
                                       state["step"])
    return {"params": new_params, "opt": opt, "step": state["step"] + 1}, out


def make_train_step(bundle: ModelBundle, optimizer: Optimizer) -> Callable:
    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        return _descend(optimizer, state, lambda p: bundle.loss(p, batch))

    return train_step


def make_prefill_step(bundle: ModelBundle) -> Callable:
    def prefill_step(params, batch):
        # the last position's main-head logits only: the reference's jit
        # drops the unread rest, so no (B, T, V) logits are formed
        out = bundle.apply(params, batch, mtp=False, logits=False)
        return TF.head_logits(params, bundle.config, out["hidden"][:, -1, :])

    return prefill_step


def make_serve_step(bundle: ModelBundle) -> Callable:
    def serve_step(params, batch):
        logits, caches = bundle.decode_step(params, batch["token"],
                                            batch["caches"])
        return logits[:, -1, :], caches

    return serve_step


def make_mhd_train_step(bundle: ModelBundle, optimizer: Optimizer,
                        mhd_cfg: MHDConfig,
                        teacher_bundle: Optional[ModelBundle] = None
                        ) -> Callable:
    """The paper's technique as one step: a student update from Δ
    teachers.

    batch: {"private_tokens": (B, T), "public_tokens": (B_pub, T),
    "teacher_params": the teachers' params stacked over Δ ({name: (Δ, …)},
    the same arch unless ``teacher_bundle`` is given)}. The teachers'
    forwards run inside the step, with no gradient (the co-located
    deployment); the student's loss is Eq. 1 on an LM client bundle
    (`core.runtime.client_loss`, the reference's ``lm_mhd_loss``).
    Consumes ``state``, as `make_train_step` does."""
    from repro_torch.core.lm_adapter import lm_mhd_outputs
    from repro_torch.core.runtime import client_loss
    from repro_torch.lm.pool import lm_client_bundle

    t_bundle = teacher_bundle or bundle
    student = lm_client_bundle(bundle)

    def mhd_train_step(state: Dict[str, Any], batch: Dict[str, Any]):
        private_batch = {"tokens": batch["private_tokens"]}
        public_batch = {"tokens": batch["public_tokens"]}
        tp = batch["teacher_params"]
        with torch.no_grad():
            outs = [lm_mhd_outputs(t_bundle, {k: v[d] for k, v in tp.items()},
                                   public_batch)
                    for d in range(next(iter(tp.values())).shape[0])]
        teachers = {k: torch.stack([o[k] for o in outs])
                    for k in ("embedding", "logits", "aux_logits")
                    if outs[0][k] is not None}
        del outs
        return _descend(optimizer, state, lambda p: client_loss(
            student, p, private_batch, public_batch, teachers, mhd_cfg))

    return mhd_train_step


def train_state_shapes(bundle: ModelBundle, optimizer: Optimizer
                       ) -> Dict[str, Any]:
    """The train state on the meta device (no allocation): params drawn by
    a `MetaDraw`, the optimizer's state of them, step 0."""
    params = bundle.init(MetaDraw().manual_seed(0))
    return {"params": params, "opt": optimizer.init(params), "step": 0}


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
