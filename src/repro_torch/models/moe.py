"""Token-choice Mixture-of-Experts with capacity-bounded scatter dispatch,
in PyTorch (port of ``repro/models/moe.py``, the same names).

  * router in f32; top-k softmax (or sigmoid, DeepSeek-v3 style) gating.
    The top-k are the first k of a stable descending sort, so a tie goes
    to the lowest expert index, as ``jax.lax.top_k`` gives it
    (``torch.topk`` promises no order among equal values);
  * dispatch: each (token, choice) pair, in token-major order, takes the
    next slot of its expert in an ``(E, C, D)`` buffer; C is the capacity,
    and a pair past it is dropped (its combine weight is zeroed), as in
    Switch/GShard. The reference adds every pair into the buffer, the
    dropped ones as zero rows clamped to slot C-1; here only the kept
    pairs are written, each to a slot of its own: the same buffer, with
    one writer a slot, no accumulation and no atomics on the card;
  * expert FFN: a SwiGLU over the experts as batched matmuls (cuBLAS);
  * combine: each pair's slot gathered back, weighted, summed over k;
  * aux load-balance loss (Switch-style): E · Σ_e f_e · P_e, f from the
    top-1 choice.

``moe_apply_lanes`` routes and caps each row of a (B, T, D) input on its
own, as the reference's decode does under ``vmap`` over the engine's
slots: a row's capacity counts its own T tokens, and its pairs fill slots
of its own, so no row can push another's pair out.

The reference's expert-parallel all-to-all form (``moe_a2a.py``) falls
back to this scatter form without a ``model`` mesh axis, and so does the
port's ``moe_impl="a2a"``: one card holds every expert.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import MoEConfig
from repro_torch.models.layers import dense_init, init_mlp, mlp_apply

Tensor = torch.Tensor
Params = Dict[str, Tensor]


def init_moe(gen: torch.Generator, d_model: int, cfg: MoEConfig,
             act: str = "silu", dtype=torch.float32) -> Params:
    """The reference's keys and shapes: ``router`` (D, E) in f32,
    ``w_gate``/``w_up`` (E, D, F), ``w_down`` (E, F, D), and ``shared/*``
    (an MLP of width ``num_shared_experts · F``) when there are shared
    experts."""
    E, Fe = cfg.num_experts, cfg.d_ff_expert
    std = 1.0 / math.sqrt(d_model)
    params = {
        "router": dense_init(gen, d_model, E, torch.float32),
        "w_gate": (torch.randn(E, d_model, Fe, generator=gen,
                               device=gen.device) * std
                   ).to(dtype),
        "w_up": (torch.randn(E, d_model, Fe, generator=gen,
                             device=gen.device) * std).to(dtype),
        "w_down": (torch.randn(E, Fe, d_model, generator=gen,
                               device=gen.device)
                   / math.sqrt(Fe)).to(dtype),
    }
    if cfg.num_shared_experts:
        params.update({f"shared/{k}": v for k, v in init_mlp(
            gen, d_model, cfg.num_shared_experts * Fe, act, dtype).items()})
    return params


def _top_k(scores: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    vals, ids = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def router_topk(logits: Tensor, top_k: int, scoring: str = "softmax"
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """Return (weights (N, k), ids (N, k), probs (N, E)); weights sum to
    at most 1 a token."""
    if scoring == "softmax":
        probs = torch.softmax(logits, dim=-1)
        weights, ids = _top_k(probs, top_k)
    elif scoring == "sigmoid":  # DeepSeek-v3: renormalized over the top-k
        scores = torch.sigmoid(logits)
        weights, ids = _top_k(scores, top_k)
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
        probs = scores / (scores.sum(-1, keepdim=True) + 1e-20)
    else:
        raise ValueError(scoring)
    return weights, ids, probs


def load_balance_loss(probs: Tensor, ids: Tensor, num_experts: int
                      ) -> Tensor:
    """Switch-Transformer aux loss: E · Σ_e f_e P_e (top-1 dispatch
    fraction)."""
    f = F.one_hot(ids[..., 0].long(), num_experts).float().mean(0)
    p = probs.mean(0)
    return num_experts * (f * p).sum()


def capacity(num_tokens: int, cfg: MoEConfig) -> int:
    """Slots an expert: C = max(ceil(N·k / E · capacity_factor), 1)."""
    return max(int(math.ceil(num_tokens * cfg.top_k / cfg.num_experts
                             * cfg.capacity_factor)), 1)


def slot_positions(flat_ids: Tensor, num_experts: int, cap: int
                   ) -> Tuple[Tensor, Tensor]:
    """Each pair's position within its expert, the running count in
    token-major (n, k) order, and whether it fits (position < ``cap``)."""
    onehot = F.one_hot(flat_ids.long(), num_experts)  # (N·k, E)
    pos = onehot.cumsum(0) - 1
    flat_pos = pos.gather(1, flat_ids.long()[:, None])[:, 0]
    return flat_pos, flat_pos < cap


def dispatch(xf: Tensor, flat_ids: Tensor, flat_pos: Tensor, keep: Tensor,
             num_experts: int, cap: int, top_k: int) -> Tensor:
    """The (E, C, D) slot buffer: each kept pair's token row in its slot
    (one writer a slot), zeros elsewhere."""
    rows = xf.repeat_interleave(top_k, dim=0)  # (N·k, D), token-major
    kept = keep.nonzero()[:, 0]
    buf = xf.new_zeros(num_experts, cap, xf.shape[-1])
    return buf.index_put((flat_ids[kept].long(), flat_pos[kept]),
                         rows[kept])


def expert_ffn(params: Params, buf: Tensor) -> Tensor:
    """The SwiGLU of every expert over its slots: (E, C, D) -> (E, C, D)."""
    gate = torch.bmm(buf, params["w_gate"]).float()
    up = torch.bmm(buf, params["w_up"]).float()
    h = (F.silu(gate) * up).to(buf.dtype)
    return torch.bmm(h, params["w_down"]).to(buf.dtype)


def combine(out_buf: Tensor, flat_ids: Tensor, flat_pos: Tensor,
            keep: Tensor, weights: Tensor, top_k: int) -> Tensor:
    """Each pair's expert output (a dropped pair reads slot C-1 and is
    weighted by 0), weighted and summed over its token's k choices."""
    cap = out_buf.shape[1]
    gathered = out_buf[flat_ids.long(), flat_pos.clamp(max=cap - 1)]
    w = (weights.reshape(-1) * keep.float()).to(out_buf.dtype)
    return (gathered * w[:, None]).reshape(-1, top_k,
                                           out_buf.shape[-1]).sum(1)


def moe_apply(params: Params, x: Tensor, cfg: MoEConfig, act: str = "silu",
              scoring: str = "softmax") -> Tuple[Tensor, Tensor]:
    """x (B, T, D) or (N, D). Returns (output of x's shape, aux loss)."""
    orig_shape = x.shape
    D = orig_shape[-1]
    xf = x.reshape(-1, D)
    E, K = cfg.num_experts, cfg.top_k
    C = capacity(xf.shape[0], cfg)

    logits = xf.float() @ params["router"].float()
    weights, ids, probs = router_topk(logits, K, scoring)
    aux = load_balance_loss(probs, ids, E) * cfg.router_aux_weight

    flat_ids = ids.reshape(-1)
    flat_pos, keep = slot_positions(flat_ids, E, C)
    buf = dispatch(xf, flat_ids, flat_pos, keep, E, C, K)
    out_buf = expert_ffn(params, buf)
    y = combine(out_buf, flat_ids, flat_pos, keep, weights, K)

    shared = {k[len("shared/"):]: v for k, v in params.items()
              if k.startswith("shared/")}
    if shared:
        y = y + mlp_apply(shared, xf, act)
    return y.reshape(orig_shape), aux


def moe_apply_lanes(params: Params, x: Tensor, cfg: MoEConfig,
                    act: str = "silu", scoring: str = "softmax"
                    ) -> Tuple[Tensor, Tensor]:
    """`moe_apply` of each row of x (B, T, D) as a call of its own, in one
    pass: C = capacity(T), each row's pairs counted in its own token-major
    order and written to its own C slots of every expert (row b's are
    b·C … b·C + C − 1). Returns (output (B, T, D), each row's aux loss
    (B,))."""
    B, T, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    C = capacity(T, cfg)
    xf = x.reshape(-1, D)

    logits = xf.float() @ params["router"].float()
    weights, ids, probs = router_topk(logits, K, scoring)
    experts = torch.arange(E, device=x.device)
    top1 = (ids[:, :1] == experts).float().reshape(B, T, E)
    aux = E * (top1.mean(1) * probs.reshape(B, T, E).mean(1)).sum(-1)
    aux = aux * cfg.router_aux_weight

    # each pair's position among its row's earlier pairs to its expert
    row_ids = ids.reshape(B, T * K)
    earlier = torch.ones(T * K, T * K, dtype=torch.bool,
                         device=x.device).tril(-1)
    row_pos = ((row_ids[:, :, None] == row_ids[:, None, :]) & earlier
               ).sum(-1)  # (B, T·K)
    keep = (row_pos < C).reshape(-1)
    slot = (row_pos + torch.arange(B, device=x.device)[:, None] * C
            ).reshape(-1)
    flat_ids = ids.reshape(-1).long()
    # every pair is written, a dropped one to a spare slot past the rows'
    # (no count of the kept pairs on the host, so the call can be
    # captured in a CUDA graph)
    rows = xf.repeat_interleave(K, dim=0)
    buf = xf.new_zeros(E, B * C + 1, D).index_put(
        (flat_ids, torch.where(keep, slot, B * C)), rows)[:, :B * C]
    out_buf = expert_ffn(params, buf)
    y = combine(out_buf, flat_ids, slot, keep, weights, K)

    shared = {k[len("shared/"):]: v for k, v in params.items()
              if k.startswith("shared/")}
    if shared:
        y = y + mlp_apply(shared, xf, act)
    return y.reshape(B, T, D), aux
