"""The decoder LM skeleton, in PyTorch (port of the full-sequence half of
``repro/models/transformer.py``), for the layer kinds the port has so far:
Mamba2 blocks (``attn="mamba2"``, ``ffn="none"``).

Depth is organized as the reference's *stages* of repeat-units. Each leaf
of a stage keeps the reference's stacked layout, with a leading
``repeats`` axis (``stage0/layer0/attn/in_proj`` is (48, 1024, 4384) in
mamba2-370m), so parameters load straight from JAX and the optimizer
updates one tensor per leaf, not one per layer. The forward unbinds each
leaf once and loops over the units in Python; with ``cfg.remat != "none"``
each unit runs under ``torch.utils.checkpoint`` (non-reentrant), as
``jax.checkpoint`` wraps the reference's unit: the same numbers for less
memory.

Public API (pure functions over a flat path-keyed param dict):
  init_lm(gen, cfg, device=None)     -> params (on the card by default)
  apply_lm(params, cfg, batch)       -> {"logits", "hidden", "aux_heads",
                                         "aux_loss"}
  lm_loss(params, cfg, batch)        -> (loss, metrics)

Attention (full, sliding-window, cross, shared), the dense FFN, MoE, MLA,
the encoder, learned and sinusoidal positions and MTP raise NotImplementedError naming
the ROADMAP item that ports them; decode comes with serving (item 14).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models.config import LayerSpec, ModelConfig

Tensor = torch.Tensor
Params = Dict[str, Tensor]

_LATER = {
    "attention": "ROADMAP Queue 1 item 13 (the transformer slice, with "
                 "flash_attention, Queue 2 item 2.5)",
    "ffn": "ROADMAP Queue 1 item 13 (the dense FFN with the transformer "
           "slice, MoE after it)",
    "moe": "ROADMAP Queue 1 item 13 (MoE, after the transformer slice)",
    "mla": "ROADMAP Queue 1 item 13 (MLA, after the transformer slice)",
    "modality": "ROADMAP Queue 1 item 13 (the vision and audio front ends)",
    "mtp": "ROADMAP Queue 1 item 13 (DeepSeek MTP)",
}


def _not_yet(what: str, key: str):
    raise NotImplementedError(f"{what} is not ported yet: {_LATER[key]}")


def _check_supported(cfg: ModelConfig) -> None:
    for stage in cfg.stages:
        for spec in stage.block:
            if spec.attn != "mamba2" and spec.attn != "none":
                _not_yet(f"attention kind {spec.attn!r}", "attention")
            if spec.shared_attn or spec.cross_attn:
                _not_yet("shared/cross attention", "attention")
            if spec.ffn != "none":
                _not_yet(f"ffn kind {spec.ffn!r}",
                         "ffn" if spec.ffn == "dense" else "moe")
    if cfg.mla is not None:
        _not_yet("MLA", "mla")
    if cfg.vision is not None or cfg.audio is not None or \
            cfg.encoder is not None:
        _not_yet("the vision/audio front ends", "modality")
    if cfg.mtp:
        _not_yet("MTP", "mtp")
    if cfg.pos_embed in ("learned", "sinusoidal"):
        _not_yet(f"{cfg.pos_embed} positions", "attention")


def _with_prefix(prefix: str, tree: Params) -> Params:
    return {f"{prefix}/{k}": v for k, v in tree.items()}


def _sub(params: Params, prefix: str) -> Params:
    """The entries under ``prefix/``, with the prefix removed."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix + "/")}


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def _init_layer(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
                dtype) -> Params:
    p: Params = {}
    if spec.attn == "mamba2":
        p.update(_with_prefix("attn", SSM.init_mamba2(gen, cfg.d_model,
                                                      cfg.mamba, dtype)))
        p.update(_with_prefix("attn_norm", L.init_norm(cfg.d_model, cfg.norm,
                                                       dtype)))
    return p


def init_lm(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
            device: Optional[torch.device] = None) -> Params:
    """Random params keyed and shaped as the reference's, drawn on the CPU
    from ``gen`` (the same whatever the device) and placed on ``device``
    (``None`` → ``cuda``, as every entry point of the port)."""
    cfg.validate()
    _check_supported(cfg)
    device = resolve_device(device)
    params: Params = {"embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                            dtype)}
    params.update(_with_prefix("final_norm", L.init_norm(cfg.d_model,
                                                         cfg.norm, dtype)))
    for si, stage in enumerate(cfg.stages):
        units = []
        for _ in range(stage.repeats):
            unit: Params = {}
            for li, spec in enumerate(stage.block):
                unit.update(_with_prefix(f"layer{li}",
                                         _init_layer(gen, cfg, spec, dtype)))
            units.append(unit)
        for k in units[0]:
            params[f"stage{si}/{k}"] = torch.stack([u[k] for u in units])
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                         dtype)
    if cfg.num_aux_heads:
        params["aux_heads"] = (torch.randn(
            cfg.num_aux_heads, cfg.d_model, cfg.vocab_size, generator=gen)
            * (1.0 / math.sqrt(cfg.d_model))).to(dtype)
    return {k: v.to(device) for k, v in params.items()}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _layer_forward(lp: Params, cfg: ModelConfig, spec: LayerSpec,
                   x: Tensor) -> Tuple[Tensor, Tensor]:
    """One layer (full-sequence path) of a kind `_check_supported`
    admits. Returns (x, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.attn == "mamba2":
        h = L.norm_apply(_sub(lp, "attn_norm"), x, cfg.norm)
        x = x + SSM.mamba2_apply(_sub(lp, "attn"), h, cfg.mamba)
    return x, aux


def _run_stages(params: Params, cfg: ModelConfig, x: Tensor
                ) -> Tuple[Tensor, Tensor]:
    """Every stage's units, in order, over x. Returns (x, total_aux)."""
    total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, stage in enumerate(cfg.stages):
        # one unbind per leaf: its backward stacks the units' gradients
        # into one tensor, where indexing would add a full-size zero
        # tensor per unit
        stacked = {k: v.unbind(0)
                   for k, v in _sub(params, f"stage{si}").items()}

        def unit_fn(h, aux_acc, unit_params, _stage=stage):
            for li, spec in enumerate(_stage.block):
                h, aux = _layer_forward(_sub(unit_params, f"layer{li}"), cfg,
                                        spec, h)
                aux_acc = aux_acc + aux
            return h, aux_acc

        for r in range(stage.repeats):
            unit = {k: v[r] for k, v in stacked.items()}
            if cfg.remat != "none" and torch.is_grad_enabled():
                x, total_aux = torch.utils.checkpoint.checkpoint(
                    unit_fn, x, total_aux, unit, use_reentrant=False,
                    preserve_rng_state=False)
            else:
                x, total_aux = unit_fn(x, total_aux, unit)
    return x, total_aux


def _embed_tokens(params: Params, cfg: ModelConfig, tokens: Tensor) -> Tensor:
    x = params["embed"][tokens.long()]
    if cfg.scale_embeddings:
        x = x * math.sqrt(cfg.d_model)
    return x


def _heads(params: Params, cfg: ModelConfig, hidden: Tensor
           ) -> Tuple[Tensor, Any]:
    """Main + aux logits (f32) from final hidden states."""
    head_w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    logits = (hidden @ head_w).float()
    aux_logits = None
    if cfg.num_aux_heads:
        aux_logits = torch.einsum("...d,mdv->m...v", hidden,
                                  params["aux_heads"]).float()
    return logits, aux_logits


def apply_lm(params: Params, cfg: ModelConfig,
             batch: Dict[str, Tensor]) -> Dict[str, Any]:
    """Full-sequence forward. batch: {"tokens": (B, T)}. Returns hidden
    (B, T, D), logits (B, T, V), aux_heads (m, B, T, V) or None, aux_loss."""
    _check_supported(cfg)
    x = _embed_tokens(params, cfg, batch["tokens"])
    x, aux_loss = _run_stages(params, cfg, x)
    hidden = L.norm_apply(_sub(params, "final_norm"), x, cfg.norm)
    logits, aux_logits = _heads(params, cfg, hidden)
    return {"hidden": hidden, "logits": logits, "aux_heads": aux_logits,
            "aux_loss": aux_loss}


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def softmax_xent(logits: Tensor, labels: Tensor, valid=None) -> Tensor:
    """Mean next-token CE. logits (..., V) fp32; labels int."""
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - ll
    if valid is not None:
        nll = nll * valid
        return nll.sum() / torch.clamp(valid.sum(), min=1.0)
    return nll.mean()


def lm_loss(params: Params, cfg: ModelConfig, batch: Dict[str, Tensor]):
    """Next-token loss (tokens shifted internally); returns (loss, metrics).
    The reference's ``loss_impl="chunked"`` is a memory lever of the same
    value; the port computes the dense form."""
    out = apply_lm(params, cfg, batch)
    labels = batch["tokens"][:, 1:]
    ce = softmax_xent(out["logits"][:, :-1].float(), labels)
    loss = ce + out["aux_loss"]
    return loss, {"ce": ce, "aux_loss": out["aux_loss"]}
