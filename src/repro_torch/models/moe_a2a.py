"""Expert-parallel MoE with explicit all-to-all dispatch (port of
``repro/models/moe_a2a.py``).

The reference hand-writes the canonical expert-parallel schedule in a
manual ``shard_map`` over every mesh axis; the port runs the same
schedule in each rank of the active mesh (`common.sharding.use_mesh`),
with ``torch.distributed`` collectives:

  1. every rank routes its LOCAL tokens (``router_topk``,
     ``load_balance_loss``, the slot positions of `models/moe.py`) into a
     capacity-bounded (E, C, D) slot buffer, C = ceil(N_dev·k/E ·
     capacity_factor) for the rank's N_dev tokens;
  2. one all-to-all over 'model' swaps expert-major slots;
  3. the rank's E/|model| experts run as batched products; their weights
     arrive D-sharded over the data axes (('pod', 'data') as the mesh has
     them) and are all-gathered per layer, the gather's backward
     reduce-scattering the gradients;
  4. the inverse all-to-all returns the slots, and each rank combines its
     own tokens' top-k contributions.

The aux loss is the mean of the ranks' load-balance losses (the
reference's ``jnp.mean`` over devices). Each all-to-all's backward sends
its cotangent in bf16: the reference rounds the cotangent at the same
boundary to bf16 (a custom-vjp identity before each all-to-all), after
moving it; rounding before the move gives the same values on half the
bytes.

**Layout.** The port has no partitioner: the region runs on this rank's
block of the tokens (the reference's block index ``(pod·|data| +
data)·|model| + model``), ``w_gate``/``w_up``/``w_down`` are its shards
by the sharding rules (E over 'model'; D over the data axes where they
divide it, `launch.shardings`), and the output is this rank's block of
y. Under ``"fsdp"`` ``x`` is that block. Under ``"tp"`` the model ranks
share their tokens: the region takes this rank's block of ``x``'s rows
at its entry and all-gathers y at its exit; the router and the shared
expert, used there on the block, enter as tensor-parallel leaves, and
the aux's gradient is scaled by 1/|model|. On a batch that the step's
token shards do not divide (``Partition.whole_rows``: every rank holds
the whole batch, as the reference replicates it) the region takes this
rank's block of the flattened tokens over the token axes itself (the
same rank order, as the reference's ``shard_map`` splits them) and
all-gathers y over them at its exit, the gather's backward summing the
ranks' cotangents: every rank's loss is the whole batch's, so the
router, the shared expert and the experts, which see this rank's tokens
only, get the sum over the token shards that the step's mean needs.
Gradients
follow the mean convention of the pod step (`core.mhd_distributed`): the
objective is the mean over the ranks of each rank's loss, so replicated
leaves' gradients are averaged over the ranks and a sharded leaf's
(reduce-scattered over every rank's tokens) is divided by their number.
The returned aux carries the mean's value and the gradient of this
rank's own term, which that average turns into the mean's.

**The scatter form** is taken exactly where the reference takes it: no
'model' axis of size above 1, E not divisible by it, or a global token
count that the token shards over every axis do not divide. There every
rank all-gathers the tokens (and any D-sharded expert weights), runs
``moe.moe_apply`` on the whole batch — the reference's global capacity
and aux — and keeps its block of y; the gathers' backward
reduce-scatters. On a whole batch it gathers no tokens and keeps all of
y.
`moe_apply_scatter` is the scatter form for ``moe_impl="scatter"`` under
a sharded step (its token shards gathered, the experts made whole), and
`moe.moe_apply` itself on one rank.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.common import sharding as SH
from repro_torch.common.sharding import active_partition
from repro_torch.models.config import MoEConfig
from repro_torch.models import moe as MOE
from repro_torch.models.layers import mlp_apply
from repro_torch.models.moe import (combine, dispatch, expert_ffn,
                                    load_balance_loss, router_topk,
                                    slot_positions)

Tensor = torch.Tensor
Params = Dict[str, Tensor]

MODEL_AXIS = "model"
TOKEN_AXES = ("pod", "data", MODEL_AXIS)
DATA_AXES = ("pod", "data")


class AllToAllBf16Grad(torch.autograd.Function):
    """all_to_all over ``group`` of x (n·…, split equally on dim 0 among
    the group's n ranks); the backward is the inverse all-to-all of the
    cotangent, sent in bf16 and returned in x's dtype."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.dtype = group, x.dtype
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        gb = g.to(torch.bfloat16).contiguous()
        out = torch.empty_like(gb)
        dist.all_to_all_single(out, gb, group=ctx.group)
        return out.to(ctx.dtype), None


def _gather(x: Tensor, axes: Sequence[str], dim: int,
            grad: str = "sum") -> Tensor:
    part = active_partition()
    return SH.gather(x, tuple(a for a in axes if a in part.sizes), dim,
                     grad, part)


def _full_d(w: Tensor, D: int, dim: int, data_axes) -> Tensor:
    """An expert weight with its D dim whole: all-gathered over the data
    axes when the rank holds a D shard."""
    if w.shape[dim] == D:
        return w
    return _gather(w, data_axes, dim)


def _mean_over(value: Tensor, axes: Sequence[str],
               scale: float = 1.0) -> Tensor:
    """The mean of ``value`` over the ranks of ``axes``, carrying the
    gradient of this rank's own ``value`` times ``scale``."""
    part = active_partition()
    n = math.prod(part.sizes[a] for a in axes)
    if n <= 1:
        return value
    total = value.detach().clone()
    dist.all_reduce(total, group=part.group(axes))
    return value * scale + (total / n - value * scale).detach()


def _shared(params: Params, cfg: MoEConfig, D: int, data_axes,
            model_grad: str, enter_whole: bool = False) -> Params:
    """The shared expert's MLP, whole: its D dims gathered over the data
    axes and its d_ff dims over 'model' (``model_grad`` backward) where
    the rank holds blocks; ``enter_whole``: a d_ff dim the rank holds
    whole enters the tensor-parallel region instead."""
    F = cfg.num_shared_experts * cfg.d_ff_expert
    out = {}
    for k, v in params.items():
        if not k.startswith("shared/"):
            continue
        d_dim = 1 if k.endswith("w_down") else 0
        v = _full_d(v, D, d_dim, data_axes)
        if v.shape[1 - d_dim] < F:
            v = _gather(v, ("model",), 1 - d_dim, model_grad)
        elif enter_whole:
            v = SH.tp_enter(v, active_partition())
        out[k[len("shared/"):]] = v
    return out


def _scatter_form(params: Params, x: Tensor, cfg: MoEConfig, act: str,
                  scoring: str, token_axes, data_axes
                  ) -> Tuple[Tensor, Tensor]:
    """``moe_apply`` on every token shard's tokens (the reference's
    global capacity and aux), this rank's block of y: the tokens
    all-gathered over ``token_axes``, the expert weights made whole."""
    part = active_partition()
    D = x.shape[-1]
    xf = x.reshape(-1, D)
    n = xf.shape[0]
    # the model ranks share the gathered tokens under "tp": their compute
    # repeats; under "fsdp" each keeps another block of y (or, on a whole
    # batch, computes all of it, as every rank does)
    model_grad = "slice" if part.tp else "sum"
    full = {k: v for k, v in params.items() if not k.startswith("shared/")}
    for k, dim in (("w_gate", 1), ("w_up", 1), ("w_down", 2)):
        w = _full_d(params[k], D, dim, data_axes)
        if w.shape[0] < cfg.num_experts:
            w = _gather(w, ("model",), 0, model_grad)
        full[k] = w
    if cfg.num_shared_experts:
        full.update({f"shared/{k}": v for k, v in _shared(
            params, cfg, D, data_axes, model_grad).items()})
    if part.whole_rows:
        y, aux = MOE.moe_apply(full, xf, cfg, act, scoring)
        return y.reshape(x.shape), aux
    x_all = _gather(xf, token_axes, 0)
    y_all, aux = MOE.moe_apply(full, x_all, cfg, act, scoring)
    live = tuple(a for a in token_axes if part.sizes[a] > 1)
    blk = part.index(live) if live else 0
    return y_all[blk * n:(blk + 1) * n].reshape(x.shape), aux


def moe_apply_scatter(params: Params, x: Tensor, cfg: MoEConfig,
                      act: str = "silu", scoring: str = "softmax"
                      ) -> Tuple[Tensor, Tensor]:
    """``moe.moe_apply`` for ``moe_impl="scatter"``: itself on one rank;
    under a sharded step the scatter form over the batch's token shards
    (the reference's global capacity and aux)."""
    part = active_partition()
    if part is None:
        return MOE.moe_apply(params, x, cfg, act, scoring)
    return _scatter_form(params, x, cfg, act, scoring, part.token_axes,
                         tuple(a for a in DATA_AXES if a in part.sizes))


def moe_apply_a2a(params: Params, x: Tensor, cfg: MoEConfig,
                  act: str = "silu", scoring: str = "softmax"
                  ) -> Tuple[Tensor, Tensor]:
    """``moe.moe_apply`` for ``moe_impl="a2a"``: the expert-parallel form
    over the active mesh's 'model' axis, or the scatter form where the
    reference takes it (no active mesh: `moe_apply` itself). ``x`` (…, D)
    is this rank's block of tokens, or the whole batch under
    ``whole_rows``; returns (y of the same tokens, the aux loss)."""
    part = active_partition()
    if part is None:
        # looked up at the call, as the reference imports it there: a
        # caller that wraps models.moe.moe_apply sees every call
        return MOE.moe_apply(params, x, cfg, act, scoring)
    sizes = part.sizes
    n_model = sizes.get(MODEL_AXIS, 1)
    token_axes = tuple(a for a in TOKEN_AXES if a in sizes)
    data_axes = tuple(a for a in DATA_AXES if a in sizes)
    E, K = cfg.num_experts, cfg.top_k
    orig_shape = x.shape
    D = orig_shape[-1]
    xf = x.reshape(-1, D)
    # under "tp" the model ranks share their tokens: the region takes
    # this rank's block of them (the reference's rank order) and gives
    # every model rank all of y back at its exit; on a whole batch it
    # first takes this rank's block over the step's token axes
    tp, whole = part.tp, part.whole_rows
    live = tuple(a for a in part.token_axes if sizes[a] > 1)
    n_blk = math.prod(sizes[a] for a in live) if whole else 1
    if n_model <= 1 or E % n_model != 0 or \
            xf.shape[0] % (n_blk * (n_model if tp else 1)):
        return _scatter_form(params, x, cfg, act, scoring, part.token_axes,
                             data_axes)
    if whole:
        size = xf.shape[0] // n_blk
        blk = part.index(live)
        xf = xf[blk * size:(blk + 1) * size]
    if tp:
        xf = SH.split_rows(xf, part)
    N_dev = xf.shape[0]  # this rank's tokens
    C = max(int(math.ceil(N_dev * K / E * cfg.capacity_factor)), 1)
    E_loc = E // n_model
    if params["w_gate"].shape[0] != E_loc:
        raise ValueError(
            f"moe_apply_a2a takes this rank's expert shard (E/|model| = "
            f"{E_loc} experts), got {params['w_gate'].shape[0]}: cut the "
            f"params with launch.shardings.shard_params")
    experts = {k: _full_d(params[k], D, dim, data_axes)
               for k, dim in (("w_gate", 1), ("w_up", 1), ("w_down", 2))}
    # under "tp" the replicated leaves are used on this rank's tokens
    # only: their gradients add up over the model ranks
    router = SH.tp_enter(params["router"], part) if tp else params["router"]
    shared = _shared(params, cfg, D, data_axes, "sum", enter_whole=tp)

    logits = xf.float() @ router.float()
    weights, ids, probs = router_topk(logits, K, scoring)
    aux = load_balance_loss(probs, ids, E)

    flat_ids = ids.reshape(-1)
    flat_pos, keep = slot_positions(flat_ids, E, C)
    buf = dispatch(xf, flat_ids, flat_pos, keep, E, C, K)

    # dispatch all-to-all over the expert axis
    group = part.group((MODEL_AXIS,))
    recv = AllToAllBf16Grad.apply(buf.reshape(n_model, E_loc, C, D), group)
    recv = recv.transpose(0, 1).reshape(E_loc, n_model * C, D)
    out = expert_ffn(experts, recv)
    # inverse all-to-all: slots back to their source ranks
    out = out.reshape(E_loc, n_model, C, D).transpose(0, 1)
    back = AllToAllBf16Grad.apply(out.contiguous(), group)
    y = combine(back.reshape(E, C, D), flat_ids, flat_pos, keep, weights, K)

    # the gradient of this rank's own aux, which the step's mean over
    # its token shards (not over 'model' under "tp") makes the mean's
    aux_loss = _mean_over(aux, token_axes, 1.0 / n_model if tp else 1.0) \
        * cfg.router_aux_weight
    if shared:
        y = y + mlp_apply(shared, xf, act)
    if tp:
        y = SH.gather_rows(y, part)
    if whole:
        y = SH.gather(y, live, 0, "sum", part)
    return y.reshape(orig_shape), aux_loss
