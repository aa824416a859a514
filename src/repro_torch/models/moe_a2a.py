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

**Layout.** The port has no partitioner: ``x`` is this rank's block of
the tokens (the reference's block index ``(pod·|data| + data)·|model| +
model``), ``w_gate``/``w_up``/``w_down`` its shards by the sharding rules
(E over 'model'; D over the data axes where they divide it,
`launch.shardings`), and the output is this rank's block of y. Gradients
follow the mean convention of the pod step (`core.mhd_distributed`): the
objective is the mean over the ranks of each rank's loss, so replicated
leaves' gradients are averaged over the ranks and a sharded leaf's
(reduce-scattered over every rank's tokens) is divided by their number.
The returned aux carries the mean's value and the gradient of this
rank's own term, which that average turns into the mean's.

**The scatter form** is taken exactly where the reference takes it: no
'model' axis of size above 1, or E not divisible by it. There every rank
all-gathers the tokens (and any D-sharded expert weights), runs
``moe.moe_apply`` on the whole batch — the reference's global capacity
and aux — and keeps its block of y; the gathers' backward
reduce-scatters. The reference's third condition, a global token count
the token shards do not divide, cannot arise: each rank holds an equal
block, and the pod step refuses a batch its ranks do not divide.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.common.sharding import (active_mesh, axis_index, group_of,
                                         mesh_axis_sizes)
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


class AllGather(torch.autograd.Function):
    """x's blocks from every rank of ``group`` concatenated along ``dim``
    in rank order; the backward reduce-scatters the cotangent (sums it
    over the ranks and gives each its block)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = dist.get_world_size(group)
        xs = x.movedim(dim, 0).contiguous()
        out = xs.new_empty((n * xs.shape[0], *xs.shape[1:]))
        dist.all_gather_into_tensor(out, xs, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        gs = g.movedim(ctx.dim, 0).contiguous()
        out = gs.new_empty((gs.shape[0] // n, *gs.shape[1:]))
        dist.reduce_scatter_tensor(out, gs, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None


def _gather(x: Tensor, mesh, axes: Sequence[str], dim: int) -> Tensor:
    axes = tuple(a for a in axes if mesh_axis_sizes(mesh)[a] > 1)
    if not axes:
        return x
    return AllGather.apply(x, group_of(mesh, axes), dim)


def _full_d(w: Tensor, D: int, dim: int, mesh, data_axes) -> Tensor:
    """An expert weight with its D dim whole: all-gathered over the data
    axes when the rank holds a D shard."""
    if w.shape[dim] == D:
        return w
    return _gather(w, mesh, data_axes, dim)


def _mean_over(value: Tensor, mesh, axes: Sequence[str]) -> Tensor:
    """The mean of ``value`` over the ranks of ``axes``, carrying the
    gradient of this rank's own ``value``."""
    n = math.prod(mesh_axis_sizes(mesh)[a] for a in axes)
    if n <= 1:
        return value
    total = value.detach().clone()
    dist.all_reduce(total, group=group_of(mesh, axes))
    return value + (total / n - value).detach()


def _scatter_form(params: Params, x: Tensor, cfg: MoEConfig, act: str,
                  scoring: str, mesh, token_axes, data_axes
                  ) -> Tuple[Tensor, Tensor]:
    """``moe_apply`` on every rank's tokens, this rank's block of y."""
    D = x.shape[-1]
    xf = x.reshape(-1, D)
    n = xf.shape[0]
    full = dict(params)
    for k, dim in (("w_gate", 1), ("w_up", 1), ("w_down", 2)):
        full[k] = _full_d(params[k], D, dim, mesh, data_axes)
    x_all = _gather(xf, mesh, token_axes, 0)
    y_all, aux = MOE.moe_apply(full, x_all, cfg, act, scoring)
    live = tuple(a for a in token_axes if mesh_axis_sizes(mesh)[a] > 1)
    blk = axis_index(mesh, live) if live else 0
    return y_all[blk * n:(blk + 1) * n].reshape(x.shape), aux


def moe_apply_a2a(params: Params, x: Tensor, cfg: MoEConfig,
                  act: str = "silu", scoring: str = "softmax"
                  ) -> Tuple[Tensor, Tensor]:
    """``moe.moe_apply`` for ``moe_impl="a2a"``: the expert-parallel form
    over the active mesh's 'model' axis, or the scatter form where the
    reference takes it (no active mesh: `moe_apply` itself). ``x`` (…, D)
    is this rank's block of tokens; returns (its block of y, the aux
    loss)."""
    mesh, _ = active_mesh()
    sizes = mesh_axis_sizes()
    if mesh is None:
        # looked up at the call, as the reference imports it there: a
        # caller that wraps models.moe.moe_apply sees every call
        return MOE.moe_apply(params, x, cfg, act, scoring)
    n_model = sizes.get(MODEL_AXIS, 1)
    token_axes = tuple(a for a in TOKEN_AXES if a in sizes)
    data_axes = tuple(a for a in DATA_AXES if a in sizes)
    E, K = cfg.num_experts, cfg.top_k
    if n_model <= 1 or E % n_model != 0:
        return _scatter_form(params, x, cfg, act, scoring, mesh,
                             token_axes, data_axes)

    orig_shape = x.shape
    D = orig_shape[-1]
    xf = x.reshape(-1, D)
    N_dev = xf.shape[0]  # this rank's tokens
    C = max(int(math.ceil(N_dev * K / E * cfg.capacity_factor)), 1)
    E_loc = E // n_model
    if params["w_gate"].shape[0] != E_loc:
        raise ValueError(
            f"moe_apply_a2a takes this rank's expert shard (E/|model| = "
            f"{E_loc} experts), got {params['w_gate'].shape[0]}: cut the "
            f"params with launch.shardings.shard_params")
    experts = {k: _full_d(params[k], D, dim, mesh, data_axes)
               for k, dim in (("w_gate", 1), ("w_up", 1), ("w_down", 2))}

    logits = xf.float() @ params["router"].float()
    weights, ids, probs = router_topk(logits, K, scoring)
    aux = load_balance_loss(probs, ids, E)

    flat_ids = ids.reshape(-1)
    flat_pos, keep = slot_positions(flat_ids, E, C)
    buf = dispatch(xf, flat_ids, flat_pos, keep, E, C, K)

    # dispatch all-to-all over the expert axis
    group = group_of(mesh, (MODEL_AXIS,))
    recv = AllToAllBf16Grad.apply(buf.reshape(n_model, E_loc, C, D), group)
    recv = recv.transpose(0, 1).reshape(E_loc, n_model * C, D)
    out = expert_ffn(experts, recv)
    # inverse all-to-all: slots back to their source ranks
    out = out.reshape(E_loc, n_model, C, D).transpose(0, 1)
    back = AllToAllBf16Grad.apply(out.contiguous(), group)
    y = combine(back.reshape(E, C, D), flat_ids, flat_pos, keep, weights, K)

    aux_loss = _mean_over(aux, mesh, token_axes) * cfg.router_aux_weight
    shared = {k[len("shared/"):]: v for k, v in params.items()
              if k.startswith("shared/")}
    if shared:
        y = y + mlp_apply(shared, xf, act)
    return y.reshape(orig_shape), aux_loss
