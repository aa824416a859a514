"""Multi-head Latent Attention (DeepSeek-V2/V3, arXiv:2412.19437), in
PyTorch (port of ``repro/models/mla.py``, the same names).

Queries and keys/values are low-rank-compressed: a query latent of
``q_lora_rank`` (RMSNorm'd, then up-projected to every head's nope and
rope parts), and one KV latent ``c_kv`` of ``kv_lora_rank`` (RMSNorm'd)
beside a single roped key ``k_rope`` of ``qk_rope_head_dim`` shared by
every head. ``mla_apply`` decompresses each head's K and V from the latent
and attends causally over full sequences: scores (q_nope·k_nope +
q_rope·k_rope)/√(dn+dr), masked at −1e30 (not −inf, so a row's numbers are
the reference's), a softmax in f32, then ``wo``. From T·T ≥
``BLOCKWISE_SCORE_THRESHOLD`` it runs the reference's query-block form,
each block of ``BLOCK_Q`` queries under ``torch.utils.checkpoint`` as
``jax.checkpoint`` wraps the reference's scan body: the same numbers with
one block's scores alive at a time.

The absorbed one-token decode (``init_mla_cache``/``mla_decode``) caches
only the latent ``c_kv`` and ``k_rope`` of each position: W_uk is folded
into the query (q_lat = q_nope·W_uk), the scores run against the latent
cache, and W_uv is applied after the reduction, so no per-head K or V is
formed. Each row of a call writes its own position ``index[b]`` (clamped
to the cache's last slot, as the reference's ``dynamic_update_slice``
clamps) and attends to the positions up to it.

The reference computes these scores with einsums, not with a Pallas
kernel, so they stay ``torch`` matmuls here (cuBLAS on the card).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.models.config import MLAConfig
from repro_torch.models.layers import apply_rope, dense_init, norm_apply

Tensor = torch.Tensor
Params = Dict[str, Tensor]

# the reference's switch to the query-block form and its block
# (repro/models/layers.py), which its MLA shares with plain attention
BLOCKWISE_SCORE_THRESHOLD = 4_194_304  # 2048 x 2048
BLOCK_Q = 512


def init_mla(gen: torch.Generator, d_model: int, num_heads: int,
             cfg: MLAConfig, dtype=torch.float32) -> Params:
    """The reference's keys and shapes: ``w_dq`` (D, q_lora), ``q_norm``,
    ``w_uq`` (q_lora, H·(dn+dr)), ``w_dkv`` (D, kv_lora + dr), ``kv_norm``,
    ``w_uk`` (kv_lora, H, dn), ``w_uv`` (kv_lora, H, dv), ``wo`` (H·dv,
    D). The norms are RMSNorms whatever the model's ``norm``."""
    H = num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    R = cfg.kv_lora_rank
    std = 1.0 / math.sqrt(R)
    return {
        "w_dq": dense_init(gen, d_model, cfg.q_lora_rank, dtype),
        "q_norm/scale": torch.ones(cfg.q_lora_rank, dtype=dtype),
        "w_uq": dense_init(gen, cfg.q_lora_rank, H * (dn + dr), dtype),
        "w_dkv": dense_init(gen, d_model, R + dr, dtype),
        "kv_norm/scale": torch.ones(R, dtype=dtype),
        "w_uk": (torch.randn(R, H, dn, generator=gen, device=gen.device)
                 * std).to(dtype),
        "w_uv": (torch.randn(R, H, dv, generator=gen, device=gen.device)
                 * std).to(dtype),
        "wo": dense_init(gen, H * dv, d_model, dtype),
    }


def _compress(params: Params, cfg: MLAConfig, x: Tensor, positions: Tensor,
              rope_theta: float) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The shared front: q_nope (B, T, H, dn) and roped q_rope (B, T, H,
    dr), the normed latent c_kv (B, T, kv_lora) and the roped k_rope
    (B, T, dr), one head shared by all."""
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    H = params["w_uq"].shape[-1] // (dn + dr)
    c_q = norm_apply({"scale": params["q_norm/scale"]},
                     (x @ params["w_dq"]).to(x.dtype))
    q = (c_q @ params["w_uq"]).to(x.dtype)
    q = q.reshape(q.shape[:-1] + (H, dn + dr))
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, rope_theta)
    ckv_full = (x @ params["w_dkv"]).to(x.dtype)
    c_kv = norm_apply({"scale": params["kv_norm/scale"]},
                      ckv_full[..., :cfg.kv_lora_rank])
    k_rope = ckv_full[..., cfg.kv_lora_rank:]
    k_rope = apply_rope(k_rope[..., None, :], positions, rope_theta)[..., 0, :]
    return q_nope, q_rope, c_kv, k_rope


def _attend(q_nope: Tensor, q_rope: Tensor, k_nope: Tensor, k_rope: Tensor,
            v: Tensor, scale: float, q0: int) -> Tensor:
    """Causal attention of the queries at positions q0, q0+1, ... over
    every key: (B, t, H, dv)."""
    scores = (torch.einsum("bthd,bshd->bhts", q_nope, k_nope).float()
              + torch.einsum("bthd,bsd->bhts", q_rope, k_rope).float()
              ) * scale
    t, S = q_nope.shape[1], k_nope.shape[1]
    qpos = torch.arange(q0, q0 + t, device=q_nope.device)
    causal = torch.arange(S, device=q_nope.device)[None, :] <= qpos[:, None]
    scores = scores.masked_fill(~causal[None, None], -1e30)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhts,bshd->bthd", probs.to(v.dtype), v).to(v.dtype)


def _blockwise_mla(q_nope, q_rope, k_nope, k_rope, v, scale: float,
                   block_q: int) -> Tensor:
    """The query-block form: one block of ``block_q`` queries at a time,
    each recomputed in the backward (bounded score memory). The reference
    pads T to a multiple of the block and cuts the padded rows; a shorter
    last block gives the same rows."""
    T = q_nope.shape[1]
    bq = min(block_q, T)
    outs = []
    for q0 in range(0, T, bq):
        args = (q_nope[:, q0:q0 + bq], q_rope[:, q0:q0 + bq], k_nope, k_rope,
                v)
        if torch.is_grad_enabled():
            outs.append(torch.utils.checkpoint.checkpoint(
                _attend, *args, scale, q0, use_reentrant=False,
                preserve_rng_state=False))
        else:
            outs.append(_attend(*args, scale, q0))
    return torch.cat(outs, dim=1)


def mla_apply(params: Params, x: Tensor, cfg: MLAConfig, num_heads: int, *,
              rope_theta: float = 10_000.0) -> Tensor:
    """Training / prefill path at positions 0..T−1: (B, T, D) -> (B, T, D),
    causal."""
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device)[None]
    q_nope, q_rope, c_kv, k_rope = _compress(params, cfg, x, positions,
                                             rope_theta)
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    k_nope = torch.einsum("btr,rhd->bthd", c_kv, params["w_uk"]).to(x.dtype)
    v = torch.einsum("btr,rhd->bthd", c_kv, params["w_uv"]).to(x.dtype)
    scale = 1.0 / math.sqrt(dn + dr)
    if T * T >= BLOCKWISE_SCORE_THRESHOLD:
        out = _blockwise_mla(q_nope, q_rope, k_nope, k_rope, v, scale,
                             BLOCK_Q)
    else:
        out = _attend(q_nope, q_rope, k_nope, k_rope, v, scale, 0)
    out = out.to(x.dtype).reshape(B, T, num_heads * dv)
    return (out @ params["wo"]).to(x.dtype)


def init_mla_cache(batch: int, length: int, cfg: MLAConfig,
                   dtype=torch.bfloat16, device=None) -> Params:
    """``c_kv`` (batch, length, kv_lora) and ``k_rope`` (batch, length,
    dr) zeros, ``index`` (batch,) int32."""
    dev = resolve_device(device)
    return {"c_kv": torch.zeros(batch, length, cfg.kv_lora_rank,
                                dtype=dtype, device=dev),
            "k_rope": torch.zeros(batch, length, cfg.qk_rope_head_dim,
                                  dtype=dtype, device=dev),
            "index": torch.zeros(batch, dtype=torch.int32, device=dev)}


def mla_decode(params: Params, x: Tensor, cache: Params, cfg: MLAConfig,
               num_heads: int, *, rope_theta: float = 10_000.0):
    """Absorbed one-token decode, x (B, 1, D). Returns (y (B, 1, D), the
    new cache)."""
    B = x.shape[0]
    S = cache["c_kv"].shape[1]
    idx = cache["index"]
    q_nope, q_rope, c_kv_new, k_rope_new = _compress(
        params, cfg, x, idx[:, None], rope_theta)
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    rows = torch.arange(B, device=x.device)
    at = idx.long().clamp(max=S - 1)
    c_kv = cache["c_kv"].index_put(
        (rows, at), c_kv_new[:, 0].to(cache["c_kv"].dtype))
    k_rope = cache["k_rope"].index_put(
        (rows, at), k_rope_new[:, 0].to(cache["k_rope"].dtype))

    # W_uk absorbed into the query: q_lat (B, 1, H, R)
    q_lat = torch.einsum("bthd,rhd->bthr", q_nope,
                         params["w_uk"]).to(x.dtype)
    dt = torch.promote_types(x.dtype, c_kv.dtype)
    scale = 1.0 / math.sqrt(dn + dr)
    scores = (torch.einsum("bthr,bsr->bhts", q_lat.to(dt),
                           c_kv.to(dt)).float()
              + torch.einsum("bthd,bsd->bhts", q_rope.to(dt),
                             k_rope.to(dt)).float()) * scale
    valid = torch.arange(S, device=x.device)[None, :] <= idx[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1)
    # attend in the latent space, then decompress with W_uv
    o_lat = torch.einsum("bhts,bsr->bthr", probs, c_kv.float())
    out = torch.einsum("bthr,rhd->bthd", o_lat.to(x.dtype),
                       params["w_uv"]).to(x.dtype)
    out = out.reshape(B, 1, num_heads * dv)
    y = (out @ params["wo"]).to(x.dtype)
    return y, {"c_kv": c_kv, "k_rope": k_rope, "index": idx + 1}
