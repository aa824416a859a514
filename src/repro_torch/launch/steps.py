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

**Under an active mesh** (``common.sharding.use_mesh``, the port's
``jax.set_mesh``) the steps run per rank, with the reference's
signatures: the state is this rank's blocks of the leaves by the sharding
rules (`launch.shardings.partition_specs` on the mesh's axes;
`train_state_shapes` gives them on meta, `shard_params` cuts a whole
state), the batch is the global one, of which the rank takes its rows
over the token axes ('pod', 'data', and 'model' under ``"fsdp"``), or
all of them where those shards do not divide it (the reference's
``batch_shardings`` replicates such a batch; the expert-parallel MoE then
takes each rank's block of the tokens itself, `models.moe_a2a`). The
step computes the unsharded step's function: a rank's gradient is its
block of the mean of the token shards' gradients (summed over the ranks
that share a block by the gathers' backward and by an all-reduce over
the token axes the block repeats on, divided by their number), and the
metrics are the mean over the token shards, on every rank.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.common import sharding as SH
from repro_torch.core.mhd import MHDConfig
from repro_torch.launch.shardings import partition_specs, shard_params
from repro_torch.models import transformer as TF
from repro_torch.models.layers import MetaDraw
from repro_torch.models.zoo import ModelBundle
from repro_torch.optim.optimizers import Optimizer


def _descend(optimizer: Optimizer, state: Dict[str, Any],
             loss_fn: Callable, reduce: Optional[Callable] = None
             ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``loss_fn(params) -> (loss, metrics)``, its gradients (passed
    through ``reduce``, which may all-reduce them in place) and the
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
    if reduce is not None:
        reduce(grads)
    params = {k: v.detach() for k, v in params.items()}
    new_params, opt = optimizer.update(grads, state["opt"], params,
                                       state["step"])
    return {"params": new_params, "opt": opt, "step": state["step"] + 1}, out


def _meta_params(bundle: ModelBundle) -> Dict[str, torch.Tensor]:
    return bundle.init(MetaDraw().manual_seed(0))


def mesh_specs(bundle: ModelBundle, part: SH.Partition):
    """The specs of the bundle's leaves on the partition's axes (its own
    when it carries them), worked out once a bundle, mesh and strategy
    (so a step counted on meta does not count the meta draw)."""
    if part.specs:
        return part.specs
    memo = bundle.__dict__.setdefault("_partition_specs", {})
    key = (tuple(sorted(part.sizes.items())), SH.sharding_strategy())
    if key not in memo:
        memo[key] = partition_specs(_meta_params(bundle), part.sizes)
    return memo[key]


def _token_rows(x: torch.Tensor, part: SH.Partition) -> torch.Tensor:
    n = part.n_token_shards
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} rows does not split over "
                         f"the {n} token shards of {part.token_axes}")
    size = x.shape[0] // n
    idx = part.index(part.token_axes) if part.token_axes else 0
    return x[idx * size:(idx + 1) * size]


def _sharded(part: SH.Partition, specs, optimizer: Optimizer,
             state: Dict[str, Any], loss_fn: Callable,
             whole_rows: bool = False):
    """`_descend` for this rank's blocks under ``part`` (on the whole
    batch if ``whole_rows``); the gradient rule and the metrics' mean of
    the module docstring. A clipping optimizer's norm is the whole
    gradient's (`optim.optimizers.global_norm` under the mesh)."""
    def reduce(grads: Dict[str, torch.Tensor]) -> None:
        SH.mean_over_token_shards(grads, specs, part.mesh, part.token_axes)

    with SH.use_mesh(part.mesh, part.axes, specs, whole_rows):
        new_state, out = _descend(optimizer, state, loss_fn, reduce)
    names = sorted(out)
    vals = torch.stack([out[k].float() for k in names])
    dist.all_reduce(vals, group=part.group(part.axes))
    vals = vals / math.prod(part.sizes.values())
    return new_state, {k: vals[i].to(out[k].dtype)
                       for i, k in enumerate(names)}


def make_train_step(bundle: ModelBundle, optimizer: Optimizer) -> Callable:
    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        part = SH.active_partition()
        if part is None:
            return _descend(optimizer, state,
                            lambda p: bundle.loss(p, batch))
        # a batch the token shards do not divide runs whole on every rank
        # (the reference replicates it); the mean over the token shards of
        # the equal gradients and metrics is then the whole batch's
        local = {k: _forward_rows(v, part) for k, v in batch.items()}
        whole = any(v.shape[0] % part.n_token_shards
                    for v in batch.values())
        return _sharded(part, mesh_specs(bundle, part), optimizer, state,
                        lambda p: bundle.loss(p, local), whole)

    return train_step


def _forward_rows(x: torch.Tensor, part: SH.Partition,
                  dim: int = 0) -> torch.Tensor:
    """A step's rows of a global batch: this rank's where the token shards
    divide the batch, else all of them (every rank computes the whole
    batch, as the reference's batch sharding replicates it)."""
    n = part.n_token_shards
    if x.shape[dim] % n:
        return x
    return _token_rows(x.movedim(dim, 0), part).movedim(0, dim)


def _under_mesh(bundle: ModelBundle, fn: Callable) -> Callable:
    """``fn(params, batch, part)`` under the active mesh with the bundle's
    specs, ``fn(params, batch, None)`` with none."""
    def step(params, batch):
        part = SH.active_partition()
        if part is None:
            return fn(params, batch, None)
        with SH.use_mesh(part.mesh, part.axes, mesh_specs(bundle, part)):
            return fn(params, batch, part)

    return step


def make_prefill_step(bundle: ModelBundle) -> Callable:
    def prefill_step(params, batch, part):
        if part is not None:
            batch = {k: _forward_rows(v, part) for k, v in batch.items()}
        # the last position's main-head logits only: the reference's jit
        # drops the unread rest, so no (B, T, V) logits are formed
        out = bundle.apply(params, batch, mtp=False, logits=False)
        return TF.head_logits(params, bundle.config, out["hidden"][:, -1, :])

    return _under_mesh(bundle, prefill_step)


def make_serve_step(bundle: ModelBundle) -> Callable:
    def serve_step(params, batch, part):
        token, caches = batch["token"], batch["caches"]
        if part is not None and token.shape[0] % part.n_token_shards == 0:
            token = _forward_rows(token, part)
            caches = {k: _forward_rows(v, part, int(k.startswith("stage")))
                      for k, v in caches.items()}
        logits, caches = bundle.decode_step(params, token, caches)
        return logits[:, -1, :], caches

    return _under_mesh(bundle, serve_step)


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
    Consumes ``state``, as `make_train_step` does. Under an active mesh
    the teacher params are this rank's blocks too (``(Δ, …)`` of each
    leaf's block)."""
    from repro_torch.core.lm_adapter import lm_mhd_outputs
    from repro_torch.core.mhd import mhd_total_loss
    from repro_torch.core.runtime import client_loss
    from repro_torch.lm.pool import lm_client_bundle

    t_bundle = teacher_bundle or bundle
    student = lm_client_bundle(bundle)

    def teachers_of(tparams, public_batch):
        with torch.no_grad():
            outs = [lm_mhd_outputs(t_bundle, {k: v[d] for k, v in
                                              tparams.items()}, public_batch)
                    for d in range(next(iter(tparams.values())).shape[0])]
        return {k: torch.stack([o[k] for o in outs])
                for k in ("embedding", "logits", "aux_logits")
                if outs[0][k] is not None}

    def mhd_train_step(state: Dict[str, Any], batch: Dict[str, Any]):
        part = SH.active_partition()
        if part is None:
            private_batch = {"tokens": batch["private_tokens"]}
            public_batch = {"tokens": batch["public_tokens"]}
            teachers = teachers_of(batch["teacher_params"], public_batch)
            return _descend(optimizer, state, lambda p: client_loss(
                student, p, private_batch, public_batch, teachers, mhd_cfg))
        private_batch = {"tokens": _token_rows(batch["private_tokens"],
                                               part)}
        public_batch = {"tokens": _token_rows(batch["public_tokens"], part)}
        with SH.use_mesh(part.mesh, part.axes, mesh_specs(t_bundle, part)):
            teachers = teachers_of(batch["teacher_params"], public_batch)
        specs = mesh_specs(bundle, part)

        def loss_fn(p):
            # `client_loss`, its Eq. 1 summed over 'model' where each
            # model rank scored its block of the rows
            out_priv = student.apply(p, private_batch)
            out_pub = student.apply(p, public_batch)
            loss, metrics = mhd_total_loss(out_priv, out_priv["labels"],
                                           out_pub, teachers, mhd_cfg)
            if TF.vocab_shards(bundle.config) > 1:
                toks = private_batch["tokens"], public_batch["tokens"]
                n_priv, n_pub = (t.shape[0] * (t.shape[1] - 1) for t in toks)
                ce = metrics["ce"]
                loss = SH.tp_exit(
                    ce * (out_priv["labels"].shape[0] / n_priv)
                    + (loss - ce) * (out_pub["labels"].shape[0] / n_pub))
            return loss + out_priv["aux_loss"], metrics

        return _sharded(part, specs, optimizer, state, loss_fn)

    return mhd_train_step


def param_shapes(bundle: ModelBundle) -> Dict[str, torch.Tensor]:
    """The params on the meta device (no allocation), drawn by a
    `MetaDraw`; under an active mesh this rank's blocks of them."""
    params = _meta_params(bundle)
    part = SH.active_partition()
    if part is not None:
        params = shard_rank(params, mesh_specs(bundle, part), part)
    return params


def train_state_shapes(bundle: ModelBundle, optimizer: Optimizer
                       ) -> Dict[str, Any]:
    """The train state on the meta device (no allocation): `param_shapes`,
    the optimizer's state of them, step 0."""
    params = param_shapes(bundle)
    return {"params": params, "opt": optimizer.init(params), "step": 0}


def shard_rank(params: Dict[str, torch.Tensor], specs,
               part: SH.Partition, lead: int = 0
               ) -> Dict[str, torch.Tensor]:
    """This rank's blocks of whole ``params`` under ``part``."""
    coords = {a: int(part.mesh.get_local_rank(a)) for a in part.axes}
    return shard_params(params, specs, part.sizes, coords, lead)


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
