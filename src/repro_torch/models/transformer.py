"""The decoder LM skeleton, in PyTorch (port of the full-sequence half of
``repro/models/transformer.py``), for the layer kinds the port has so far:
Mamba2 blocks (``attn="mamba2"``), full and sliding-window self-attention
(``attn="full"`` / ``"swa"``, GQA, RoPE, ``qk_norm``, bias) on the
``flash_attention`` kernel, or Multi-head Latent Attention in their place
when ``cfg.mla`` is set (`models/mla.py`, torch matmuls as the reference's
einsums), the dense FFN (``ffn="dense"``), the
Mixture-of-Experts FFN (``ffn="moe"``, and arctic's ``"moe_dense_parallel"``,
a dense SwiGLU beside the MoE on one ``ffn_norm`` output; `models/moe.py`),
whose router aux losses add up over the units into ``aux_loss``, and
zamba2's *shared* attention block (``shared_attn=True``: one parameter set,
``shared_attn/*`` and ``shared_attn_norm/*`` at the top of the tree,
applied after the layer's own mixer wherever a layer asks for it), and
DeepSeek's multi-token prediction (``cfg.mtp``: ``mtp/proj`` (2D, D),
``mtp/norm`` and one unstacked full-attention dense layer ``mtp/layer``
predicting token t+2 from [h_t ; emb(token t+1)]; ``lm_loss`` adds 0.3 of
its CE), and the
encoder-decoder and vision pieces: llama-vision's gated cross-attention
layer (``attn="cross"``: ``attn``, ``attn_norm`` and a 0-d ``cross_gate``
stacked to (repeats,), adding tanh(gate)·attn(h, vision) without RoPE),
whisper's decoder cross sublayer (``cross_attn=True``: ``xattn``,
``xattn_norm``, attending to the encoder's output), the front ends
(``vision_proj`` over stub patch embeddings; ``audio_proj`` and the
``encoder/`` subtree, bidirectional full-attention dense layers under
sinusoidal positions and ``encoder/final_norm``), and learned
(``pos_embed``) and sinusoidal positions.

Depth is organized as the reference's *stages* of repeat-units. Each leaf
of a stage keeps the reference's stacked layout, with a leading
``repeats`` axis (``stage0/layer0/attn/in_proj`` is (48, 1024, 4384) in
mamba2-370m), so parameters load straight from JAX and the optimizer
updates one tensor per leaf, not one per layer. The forward unbinds each
leaf once and loops over the units in Python; with ``cfg.remat != "none"``
each unit runs under ``torch.utils.checkpoint`` (non-reentrant), as
``jax.checkpoint`` wraps the reference's unit: the same numbers for less
memory. The shared block's weights are closure constants of every unit,
as in the reference: each use adds its part to their one gradient.

Public API (pure functions over a flat path-keyed param dict):
  init_lm(gen, cfg, device=None)     -> params (on the card by default)
  apply_lm(params, cfg, batch, mtp=True)
                                     -> {"logits", "hidden", "aux_heads",
                                         "aux_loss"} (+ "mtp_hidden")
  encode_audio(params, cfg, frames)  -> the encoder's output (B, T_enc, D)
  lm_loss(params, cfg, batch)        -> (loss, metrics)
  init_lm_cache(cfg, batch, cache_len, dtype=bfloat16, device=None)
                                     -> caches
  prefill_cross_caches(params, cfg, caches, vision_embeds=None,
                       audio_frames=None) -> caches
  decode_step(params, cfg, token, caches) -> (logits (B, 1, V), caches)

The caches are a flat path-keyed dict with the reference's tree: a stage's
leaves stacked over its repeats (``stage0/layer0/attn/k`` is (R, B, S, KV,
hd)), and an ``index`` beside each self-attention, MLA and Mamba2 cache
and at the top. Where the reference's index is a scalar for the whole
batch, the port's holds one position per row ((R, B) in a stage, (B,) at
the top), so one ``decode_step`` advances rows that sit at different
positions: the engine's slots. Decode computes the main head's logits
only, as the reference's ``jit`` keeps only what is read.

The reference's ``apply_lm`` always computes the MTP branch and its
``jit`` drops it where nothing reads it (the MHD path); the port runs
eagerly, so ``apply_lm(..., mtp=False)`` leaves it out, and the MTP
leaves get zero gradients there as in the reference.

``moe_impl="a2a"`` runs the scatter form, as the reference does without a
``model`` mesh axis; the expert-parallel form is item 15.
``attn_logit_softcap`` raises NotImplementedError naming the ROADMAP item
that ports it.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.config import LayerSpec, ModelConfig, Stage

Tensor = torch.Tensor
Params = Dict[str, Tensor]

_SOFTCAP = ("ROADMAP Queue 2 item 2.5 (logit_softcap: no configuration "
            "sets it, and the flash_attention kernel does not apply it)")


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.attn_logit_softcap is not None:
        raise NotImplementedError(
            f"attn_logit_softcap is not ported yet: {_SOFTCAP}")


# the MTP block's one layer (unstacked), MLA when the model's attention is;
# and the encoder's (bidirectional under mask_kind_override="none")
_MTP_LAYER = LayerSpec(attn="full", ffn="dense")
_ENCODER_LAYER = LayerSpec(attn="full", ffn="dense")


def _with_prefix(prefix: str, tree: Params) -> Params:
    return {f"{prefix}/{k}": v for k, v in tree.items()}


def _sub(params: Params, prefix: str) -> Params:
    """The entries under ``prefix/``, with the prefix removed."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix + "/")}


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def _attn_dims(cfg: ModelConfig, cross: bool = False) -> L.AttnDims:
    # vision tokens are projected to d_model before the cross layers
    kv_in = cfg.d_model if cross and cfg.vision is not None else None
    return L.AttnDims(d_model=cfg.d_model, num_heads=cfg.num_heads,
                      num_kv_heads=cfg.num_kv_heads,
                      head_dim=cfg.resolved_head_dim, qkv_bias=cfg.qkv_bias,
                      qk_norm=cfg.qk_norm, kv_input_dim=kv_in)


def _init_layer(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
                dtype) -> Params:
    p: Params = {}
    if spec.attn in ("full", "swa") and cfg.mla is not None:
        p.update(_with_prefix("attn", MLA.init_mla(
            gen, cfg.d_model, cfg.num_heads, cfg.mla, dtype)))
    elif spec.attn in ("full", "swa"):
        p.update(_with_prefix("attn", L.init_attention(gen, _attn_dims(cfg),
                                                       dtype)))
    elif spec.attn == "cross":
        p.update(_with_prefix("attn", L.init_attention(
            gen, _attn_dims(cfg, cross=True), dtype)))
        p["cross_gate"] = torch.zeros((), dtype=dtype)  # llama-vision gate
    elif spec.attn == "mamba2":
        p.update(_with_prefix("attn", SSM.init_mamba2(gen, cfg.d_model,
                                                      cfg.mamba, dtype)))
    elif spec.attn != "none":
        raise ValueError(spec.attn)
    if spec.attn != "none":
        p.update(_with_prefix("attn_norm", L.init_norm(cfg.d_model, cfg.norm,
                                                       dtype)))
    if spec.cross_attn:  # whisper decoder sublayer
        p.update(_with_prefix("xattn", L.init_attention(gen, _attn_dims(cfg),
                                                        dtype)))
        p.update(_with_prefix("xattn_norm", L.init_norm(
            cfg.d_model, cfg.norm, dtype)))
    if spec.ffn == "dense":
        p.update(_with_prefix("ffn", L.init_mlp(gen, cfg.d_model, cfg.d_ff,
                                                cfg.act, dtype)))
        p.update(_with_prefix("ffn_norm", L.init_norm(cfg.d_model, cfg.norm,
                                                      dtype)))
    elif spec.ffn in ("moe", "moe_dense_parallel"):
        p.update(_with_prefix("ffn", MOE.init_moe(gen, cfg.d_model, cfg.moe,
                                                  cfg.act, dtype)))
        if spec.ffn == "moe_dense_parallel":  # arctic: dense residual ∥ MoE
            p.update(_with_prefix("ffn_dense", L.init_mlp(
                gen, cfg.d_model, cfg.d_ff, cfg.act, dtype)))
        p.update(_with_prefix("ffn_norm", L.init_norm(cfg.d_model, cfg.norm,
                                                      dtype)))
    elif spec.ffn != "none":
        raise ValueError(spec.ffn)
    return p


def init_lm(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
            device: Optional[torch.device] = None) -> Params:
    """Random params keyed and shaped as the reference's, drawn from
    ``gen`` on its device (a CPU generator gives the same draws whatever
    ``device`` is; a CUDA one draws on the card) and placed on ``device``
    (``None`` → ``cuda``, as every entry point of the port)."""
    cfg.validate()
    _check_supported(cfg)
    device = resolve_device(device)
    params: Params = {"embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                            dtype)}
    params.update(_with_prefix("final_norm", L.init_norm(cfg.d_model,
                                                         cfg.norm, dtype)))
    for si, stage in enumerate(cfg.stages):
        params.update(_init_stage(gen, cfg, stage, f"stage{si}", dtype))
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                         dtype)
    if cfg.num_aux_heads:
        params["aux_heads"] = (torch.randn(
            cfg.num_aux_heads, cfg.d_model, cfg.vocab_size, generator=gen,
            device=gen.device)
            * (1.0 / math.sqrt(cfg.d_model))).to(dtype)
    if any(s.shared_attn for st in cfg.stages for s in st.block):
        params.update(_with_prefix("shared_attn", L.init_attention(
            gen, _attn_dims(cfg), dtype)))
        params.update(_with_prefix("shared_attn_norm", L.init_norm(
            cfg.d_model, cfg.norm, dtype)))
    if cfg.mtp:
        params["mtp/proj"] = L.dense_init(gen, 2 * cfg.d_model, cfg.d_model,
                                          dtype)
        params.update(_with_prefix("mtp/norm", L.init_norm(
            cfg.d_model, cfg.norm, dtype)))
        params.update(_with_prefix("mtp/layer", _init_layer(
            gen, cfg, _MTP_LAYER, dtype)))
    if cfg.vision is not None:
        params["vision_proj"] = L.dense_init(gen, cfg.vision.embed_dim,
                                             cfg.d_model, dtype)
    if cfg.audio is not None:
        params["audio_proj"] = L.dense_init(gen, cfg.audio.frame_dim,
                                            cfg.d_model, dtype)
        params.update(_init_stage(gen, cfg, _encoder_stage(cfg),
                                  "encoder/stage0", dtype))
        params.update(_with_prefix("encoder/final_norm", L.init_norm(
            cfg.d_model, cfg.norm, dtype)))
    if cfg.pos_embed == "learned":
        params["pos_embed"] = (torch.randn(
            cfg.max_seq_len, cfg.d_model, generator=gen, device=gen.device)
            * 0.02).to(dtype)
    return {k: v.to(device) for k, v in params.items()}


def _init_stage(gen: torch.Generator, cfg: ModelConfig, stage: Stage,
                prefix: str, dtype) -> Params:
    """One stage's units, each leaf stacked over ``stage.repeats``."""
    units = []
    for _ in range(stage.repeats):
        unit: Params = {}
        for li, spec in enumerate(stage.block):
            unit.update(_with_prefix(f"layer{li}",
                                     _init_layer(gen, cfg, spec, dtype)))
        units.append(unit)
    return {f"{prefix}/{k}": torch.stack([u[k] for u in units])
            for k in units[0]}


def _encoder_stage(cfg: ModelConfig) -> Stage:
    return Stage(block=(_ENCODER_LAYER,), repeats=cfg.encoder.num_layers)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _layer_forward(lp: Params, cfg: ModelConfig, spec: LayerSpec,
                   x: Tensor, shared: Params,
                   cross_src: Optional[Tensor] = None,
                   enc_out: Optional[Tensor] = None,
                   mask_kind_override: Optional[str] = None
                   ) -> Tuple[Tensor, Tensor]:
    """One layer (full-sequence path): its mixer, the shared attention
    block if it asks for it, whisper's cross sublayer over ``enc_out`` if
    it has one, then its FFN. A cross layer attends to ``cross_src``, the
    projected vision tokens. Returns (x, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    rope = cfg.rope_theta if cfg.pos_embed == "rope" else None
    if spec.attn in ("full", "swa") and cfg.mla is not None:
        h = L.norm_apply(_sub(lp, "attn_norm"), x, cfg.norm)
        x = x + MLA.mla_apply(_sub(lp, "attn"), h, cfg.mla, cfg.num_heads,
                              rope_theta=cfg.rope_theta)
    elif spec.attn in ("full", "swa"):
        h = L.norm_apply(_sub(lp, "attn_norm"), x, cfg.norm)
        x = x + L.attention_apply(
            _sub(lp, "attn"), _attn_dims(cfg), h,
            mask_kind=mask_kind_override or (
                "swa" if spec.attn == "swa" else "causal"),
            window=cfg.window_size, rope_theta=rope)
    elif spec.attn == "cross":
        h = L.norm_apply(_sub(lp, "attn_norm"), x, cfg.norm)
        a = L.attention_apply(_sub(lp, "attn"), _attn_dims(cfg, cross=True),
                              h, mask_kind="none", kv_src=cross_src,
                              rope_theta=None)
        x = x + torch.tanh(lp["cross_gate"]).to(x.dtype) * a
    elif spec.attn == "mamba2":
        h = L.norm_apply(_sub(lp, "attn_norm"), x, cfg.norm)
        x = x + SSM.mamba2_apply(_sub(lp, "attn"), h, cfg.mamba)
    if spec.shared_attn:
        h = L.norm_apply(_sub(shared, "shared_attn_norm"), x, cfg.norm)
        x = x + L.attention_apply(_sub(shared, "shared_attn"),
                                  _attn_dims(cfg), h, mask_kind="causal",
                                  rope_theta=rope)
    if spec.cross_attn:
        h = L.norm_apply(_sub(lp, "xattn_norm"), x, cfg.norm)
        x = x + L.attention_apply(_sub(lp, "xattn"), _attn_dims(cfg), h,
                                  mask_kind="none", kv_src=enc_out,
                                  rope_theta=None)
    if spec.ffn == "dense":
        h = L.norm_apply(_sub(lp, "ffn_norm"), x, cfg.norm)
        x = x + L.mlp_apply(_sub(lp, "ffn"), h, cfg.act)
    elif spec.ffn in ("moe", "moe_dense_parallel"):
        h = L.norm_apply(_sub(lp, "ffn_norm"), x, cfg.norm)
        y, moe_aux = MOE.moe_apply(_sub(lp, "ffn"), h, cfg.moe, cfg.act,
                                   scoring=cfg.moe_scoring)
        if spec.ffn == "moe_dense_parallel":
            y = y + L.mlp_apply(_sub(lp, "ffn_dense"), h, cfg.act)
        x = x + y
        aux = aux + moe_aux
    return x, aux


def _run_stages(params: Params, cfg: ModelConfig, x: Tensor, stages=None,
                cross_src: Optional[Tensor] = None,
                enc_out: Optional[Tensor] = None,
                mask_kind_override: Optional[str] = None
                ) -> Tuple[Tensor, Tensor]:
    """Every stage's units (``cfg.stages`` unless given; their leaves under
    ``stage{i}/`` of ``params``), in order, over x. Returns (x,
    total_aux). The shared block's weights, the vision tokens and the
    encoder's output go into every unit as they are, so autograd sums
    their gradients over the units."""
    total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    shared = {k: v for k, v in params.items()
              if k.startswith(("shared_attn/", "shared_attn_norm/"))}
    for si, stage in enumerate(cfg.stages if stages is None else stages):
        # one unbind per leaf: its backward stacks the units' gradients
        # into one tensor, where indexing would add a full-size zero
        # tensor per unit
        stacked = {k: v.unbind(0)
                   for k, v in _sub(params, f"stage{si}").items()}

        def unit_fn(h, aux_acc, unit_params, _stage=stage):
            for li, spec in enumerate(_stage.block):
                h, aux = _layer_forward(
                    _sub(unit_params, f"layer{li}"), cfg, spec, h, shared,
                    cross_src=cross_src, enc_out=enc_out,
                    mask_kind_override=mask_kind_override)
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


def _sinusoidal(T: int, D: int, device=None) -> Tensor:
    """(T, D) f32: sin then cos of position / 10000^(2i/D), i < D/2."""
    pos = torch.arange(T, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(D // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10_000.0, device=device), 2 * dim / D)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _add_positional(params: Params, cfg: ModelConfig, x: Tensor,
                    offset: int = 0) -> Tensor:
    T = x.shape[1]
    if cfg.pos_embed == "learned":
        x = x + params["pos_embed"][offset:offset + T][None].to(x.dtype)
    elif cfg.pos_embed == "sinusoidal":
        x = x + _sinusoidal(T, cfg.d_model, x.device)[None].to(x.dtype)
    return x


def encode_audio(params: Params, cfg: ModelConfig, frames: Tensor) -> Tensor:
    """Whisper's encoder over stub frame embeddings (B, T_enc, frame_dim):
    the projection, sinusoidal positions, ``cfg.encoder.num_layers``
    bidirectional full-attention dense layers through the same unit loop
    and remat as the decoder, then ``encoder/final_norm``."""
    x = (frames @ params["audio_proj"]).to(frames.dtype)
    x = x + _sinusoidal(x.shape[1], cfg.d_model, x.device)[None].to(x.dtype)
    enc = _sub(params, "encoder")
    x, _ = _run_stages(enc, cfg, x, (_encoder_stage(cfg),),
                       mask_kind_override="none")
    return L.norm_apply(_sub(enc, "final_norm"), x, cfg.norm)


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


def _mtp_hidden(params: Params, cfg: ModelConfig, tokens: Tensor,
                hidden: Tensor) -> Tensor:
    """DeepSeek MTP: the hidden state predicting token t+2, from
    [h_t ; emb(token t+1)] (the next token rolled in from the front at the
    last position, as the reference's ``jnp.roll``)."""
    emb_next = _embed_tokens(params, cfg, torch.roll(tokens, -1, dims=1))
    mtp_in = torch.cat([hidden, emb_next.to(hidden.dtype)], dim=-1)
    h = (mtp_in @ params["mtp/proj"]).to(hidden.dtype)
    h = L.norm_apply(_sub(params, "mtp/norm"), h, cfg.norm)
    h, _ = _layer_forward(_sub(params, "mtp/layer"), cfg, _MTP_LAYER, h, {})
    return h


def apply_lm(params: Params, cfg: ModelConfig, batch: Dict[str, Tensor],
             mtp: bool = True) -> Dict[str, Any]:
    """Full-sequence forward. batch: {"tokens": (B, T)} plus, as the
    config asks, "vision_embeds" (B, P, embed_dim) or "audio_frames"
    (B, T_enc, frame_dim). Returns hidden (B, T, D), logits (B, T, V),
    aux_heads (m, B, T, V) or None, aux_loss, and, when ``cfg.mtp`` and
    ``mtp`` are set, mtp_hidden (B, T, D)."""
    _check_supported(cfg)
    x = _embed_tokens(params, cfg, batch["tokens"])
    x = _add_positional(params, cfg, x)
    cross_src = None
    if cfg.vision is not None:
        cross_src = (batch["vision_embeds"] @ params["vision_proj"]).to(
            x.dtype)
    enc_out = None
    if cfg.audio is not None:
        enc_out = encode_audio(params, cfg, batch["audio_frames"])
    x, aux_loss = _run_stages(params, cfg, x, cross_src=cross_src,
                              enc_out=enc_out)
    hidden = L.norm_apply(_sub(params, "final_norm"), x, cfg.norm)
    logits, aux_logits = _heads(params, cfg, hidden)
    out = {"hidden": hidden, "logits": logits, "aux_heads": aux_logits,
           "aux_loss": aux_loss}
    if cfg.mtp and mtp:
        out["mtp_hidden"] = _mtp_hidden(params, cfg, batch["tokens"], hidden)
    return out


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
    """Next-token loss (tokens shifted internally), plus 0.3 of the MTP
    head's CE on token t+2 when ``cfg.mtp``; returns (loss, metrics). The
    reference's ``loss_impl="chunked"`` is a memory lever of the same
    value; the port computes the dense form."""
    out = apply_lm(params, cfg, batch)
    tokens = batch["tokens"]
    ce = softmax_xent(out["logits"][:, :-1].float(), tokens[:, 1:])
    loss = ce + out["aux_loss"]
    metrics = {"ce": ce, "aux_loss": out["aux_loss"]}
    if cfg.mtp:
        head_w = params["embed"].t() if cfg.tie_embeddings \
            else params["lm_head"]
        mtp_logits = (out["mtp_hidden"][:, :-2] @ head_w).float()
        mtp_ce = softmax_xent(mtp_logits, tokens[:, 2:])
        loss = loss + 0.3 * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    return loss, metrics


# ---------------------------------------------------------------------------
# decode (serve path)
# ---------------------------------------------------------------------------

def _layer_cache_shape(cfg: ModelConfig, spec: LayerSpec, batch: int,
                       cache_len: int, dtype, device) -> Params:
    """One layer's cache, flat (``attn/k``, ``attn/index``, ...)."""
    caches: Params = {}
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    if spec.attn in ("full", "swa"):
        # enc-dec (whisper): the self-attention cache is decoder-length;
        # cache_len is the encoder's frame count (the cross cache below)
        self_len = cfg.audio.decoder_len if cfg.audio is not None \
            else cache_len
        if cfg.mla is not None:
            c = MLA.init_mla_cache(batch, self_len, cfg.mla, dtype, device)
        else:
            length = min(cfg.window_size, self_len) if spec.attn == "swa" \
                else self_len
            c = L.init_kv_cache(batch, length, KV, hd, dtype, device)
        caches.update(_with_prefix("attn", c))
    elif spec.attn == "mamba2":
        caches.update(_with_prefix("attn", SSM.init_mamba2_cache(
            batch, cfg.d_model, cfg.mamba, dtype, device)))
    elif spec.attn == "cross":
        shape = (batch, cfg.vision.num_patches, KV, hd)
        caches["attn/k"] = torch.zeros(shape, dtype=dtype, device=device)
        caches["attn/v"] = torch.zeros(shape, dtype=dtype, device=device)
    if spec.shared_attn:
        caches.update(_with_prefix("shared_attn", L.init_kv_cache(
            batch, cache_len, KV, hd, dtype, device)))
    if spec.cross_attn:  # the encoder's length, for whisper's decode
        shape = (batch, cache_len, KV, hd)
        caches["xattn/k"] = torch.zeros(shape, dtype=dtype, device=device)
        caches["xattn/v"] = torch.zeros(shape, dtype=dtype, device=device)
    return caches


def init_lm_cache(cfg: ModelConfig, batch: int, cache_len: int,
                  dtype=torch.bfloat16, device=None) -> Params:
    """Zero caches for ``batch`` rows, each stage's leaves stacked over its
    repeats, on ``device`` (None → the card)."""
    device = resolve_device(device)
    caches: Params = {}
    for si, stage in enumerate(cfg.stages):
        for li, spec in enumerate(stage.block):
            for k, v in _layer_cache_shape(cfg, spec, batch, cache_len,
                                           dtype, device).items():
                caches[f"stage{si}/layer{li}/{k}"] = v.new_zeros(
                    (stage.repeats,) + tuple(v.shape))
    caches["index"] = torch.zeros(batch, dtype=torch.int32, device=device)
    return caches


def _cross_decode(attn_params: Params, cfg: ModelConfig, x: Tensor,
                  cache: Params) -> Tensor:
    """One token a row against a filled cross cache (every key counts): q
    from ``wq`` alone, as the reference's (no bias, norm or RoPE)."""
    dims = _attn_dims(cfg)
    B = x.shape[0]
    q = (x @ attn_params["wq"]).to(x.dtype)
    q = q.reshape(B, 1, dims.num_heads, dims.head_dim)
    out = L.attention_scores(q, cache["k"].to(x.dtype),
                             cache["v"].to(x.dtype), None)
    out = out.reshape(B, 1, dims.num_heads * dims.head_dim)
    return (out @ attn_params["wo"]).to(x.dtype)


def _layer_decode(lp: Params, cfg: ModelConfig, spec: LayerSpec, x: Tensor,
                  cache: Params, shared: Params) -> Tuple[Tensor, Params]:
    """One layer's decode step (the order of `_layer_forward`). The MoE
    FFN routes and caps each row on its own (`moe_apply_lanes`), as the
    reference's engine gives each lane its own call. Returns (x, the
    layer's new cache)."""
    rope = cfg.rope_theta if cfg.pos_embed == "rope" else None
    new_cache = dict(cache)
    if spec.attn in ("full", "swa"):
        h = L.norm_apply(_sub(lp, "attn_norm"), x, cfg.norm)
        if cfg.mla is not None:
            a, c = MLA.mla_decode(_sub(lp, "attn"), h, _sub(cache, "attn"),
                                  cfg.mla, cfg.num_heads,
                                  rope_theta=cfg.rope_theta)
        else:
            a, c = L.attention_decode(
                _sub(lp, "attn"), _attn_dims(cfg), h, _sub(cache, "attn"),
                window=cfg.window_size if spec.attn == "swa" else 0,
                rope_theta=rope, logit_softcap=cfg.attn_logit_softcap)
        new_cache.update(_with_prefix("attn", c))
        x = x + a
    elif spec.attn == "cross":
        h = L.norm_apply(_sub(lp, "attn_norm"), x, cfg.norm)
        a = _cross_decode(_sub(lp, "attn"), cfg, h, _sub(cache, "attn"))
        x = x + torch.tanh(lp["cross_gate"]).to(x.dtype) * a
    elif spec.attn == "mamba2":
        h = L.norm_apply(_sub(lp, "attn_norm"), x, cfg.norm)
        a, c = SSM.mamba2_decode(_sub(lp, "attn"), h, _sub(cache, "attn"),
                                 cfg.mamba)
        new_cache.update(_with_prefix("attn", c))
        x = x + a
    if spec.shared_attn:
        h = L.norm_apply(_sub(shared, "shared_attn_norm"), x, cfg.norm)
        a, c = L.attention_decode(_sub(shared, "shared_attn"),
                                  _attn_dims(cfg), h,
                                  _sub(cache, "shared_attn"),
                                  rope_theta=rope)
        new_cache.update(_with_prefix("shared_attn", c))
        x = x + a
    if spec.cross_attn:
        h = L.norm_apply(_sub(lp, "xattn_norm"), x, cfg.norm)
        x = x + _cross_decode(_sub(lp, "xattn"), cfg, h,
                              _sub(cache, "xattn"))
    if spec.ffn == "dense":
        h = L.norm_apply(_sub(lp, "ffn_norm"), x, cfg.norm)
        x = x + L.mlp_apply(_sub(lp, "ffn"), h, cfg.act)
    elif spec.ffn in ("moe", "moe_dense_parallel"):
        h = L.norm_apply(_sub(lp, "ffn_norm"), x, cfg.norm)
        y, _ = MOE.moe_apply_lanes(_sub(lp, "ffn"), h, cfg.moe, cfg.act,
                                   scoring=cfg.moe_scoring)
        if spec.ffn == "moe_dense_parallel":
            y = y + L.mlp_apply(_sub(lp, "ffn_dense"), h, cfg.act)
        x = x + y
    return x, new_cache


def prefill_cross_caches(params: Params, cfg: ModelConfig, caches: Params,
                         *, vision_embeds: Optional[Tensor] = None,
                         audio_frames: Optional[Tensor] = None) -> Params:
    """Fill the cross-attention K/V caches from the modality source: the
    projected vision tokens for llama-vision's cross layers, the encoder's
    output for whisper's decoder sublayers. Runs once before decode;
    returns new caches (the old ones are left as they were)."""
    cross_src = None
    if vision_embeds is not None:
        cross_src = (vision_embeds @ params["vision_proj"]).to(
            vision_embeds.dtype)
    enc_out = None
    if audio_frames is not None:
        enc_out = encode_audio(params, cfg, audio_frames)
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim

    def kv_for(prefix: str, src: Tensor) -> Tuple[Tensor, Tensor]:
        # stacked weights (R, D_src, KV·hd) over src (B, S, D_src)
        k = torch.einsum("bsd,rdh->rbsh", src, params[f"{prefix}/wk"])
        v = torch.einsum("bsd,rdh->rbsh", src, params[f"{prefix}/wv"])
        R, B, S, _ = k.shape
        return k.reshape(R, B, S, KV, hd), v.reshape(R, B, S, KV, hd)

    caches = dict(caches)
    for si, stage in enumerate(cfg.stages):
        for li, spec in enumerate(stage.block):
            layer = f"stage{si}/layer{li}"
            fills = []
            if spec.attn == "cross" and cross_src is not None:
                fills.append(("attn", cross_src))
            if spec.cross_attn and enc_out is not None:
                fills.append(("xattn", enc_out))
            for name, src in fills:
                k, v = kv_for(f"{layer}/{name}", src)
                for key, val in (("k", k), ("v", v)):
                    tgt = caches[f"{layer}/{name}/{key}"]
                    caches[f"{layer}/{name}/{key}"] = val.to(tgt.dtype)
    return caches


def decode_step(params: Params, cfg: ModelConfig, token: Tensor,
                caches: Params) -> Tuple[Tensor, Params]:
    """One token a row: token (B, 1) int. Row b sits at position
    ``caches["index"][b]``. Returns (logits (B, 1, V) f32, the new
    caches); the old ones are left as they were."""
    x = _embed_tokens(params, cfg, token)
    if cfg.pos_embed == "learned":
        pos = (caches["index"] % cfg.max_seq_len).long()
        x = x + params["pos_embed"][pos][:, None].to(x.dtype)
    else:  # the reference adds position 0's sinusoid at every step
        x = _add_positional(params, cfg, x, offset=0)
    shared = {k: v for k, v in params.items()
              if k.startswith(("shared_attn/", "shared_attn_norm/"))}
    new: Params = {"index": caches["index"] + 1}
    for si, stage in enumerate(cfg.stages):
        stacked_p = {k: v.unbind(0)
                     for k, v in _sub(params, f"stage{si}").items()}
        stacked_c = {k: v.unbind(0)
                     for k, v in _sub(caches, f"stage{si}").items()}
        units = []
        for r in range(stage.repeats):
            unit_p = {k: v[r] for k, v in stacked_p.items()}
            unit_c = {k: v[r] for k, v in stacked_c.items()}
            unit_new: Params = {}
            for li, spec in enumerate(stage.block):
                x, c = _layer_decode(_sub(unit_p, f"layer{li}"), cfg, spec,
                                     x, _sub(unit_c, f"layer{li}"), shared)
                unit_new.update(_with_prefix(f"layer{li}", c))
            units.append(unit_new)
        for k in units[0]:
            new[f"stage{si}/{k}"] = torch.stack([u[k] for u in units])
    hidden = L.norm_apply(_sub(params, "final_norm"), x, cfg.norm)
    head_w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    return (hidden @ head_w).float(), new
