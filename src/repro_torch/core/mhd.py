"""Multi-Headed Distillation — the paper's core technique (§3.2, Eqs. 1-5),
in PyTorch (port of ``repro/core/mhd.py``).

The student optimizes

    L_i = L_CE(private) + ν_emb · Σ_j ρ(||ψ̂_i − φ̂_j||)          (Eq. 2)
        + ν_aux · Σ_k L_dist[aux_k ← gated source at level k−1]   (Eqs. 4, 5)

with every teacher quantity a constant (no gradient). Variants as in the
reference: confidence ``max`` / ``entropy`` / ``margin`` / ``random``, SL
(``use_same_level``), SF (``use_self``), ``skip_when_student_confident``
and ``label_smooth_teacher``.

Unlike the reference, which writes these terms in jnp, the port routes
them through its kernels (`repro_torch.kernels.ops`) where the function is
the kernel's:

  * Eq. 2 is one ``emb_dist`` launch on the (Δ·B, E) rows;
  * with confidence ``max`` or ``random`` and no label smoothing, each
    level k is one ``dist_ce`` launch on the (n_cand·B, C) candidate rows
    against the student head tiled n_cand times: ``t_conf`` is Λ of every
    candidate, ``s_conf`` the student's own Λ, and ``ce`` at the winner's
    row is the per-sample loss, so the gradient flows only through the
    gathered winner rows.

``entropy`` / ``margin`` confidences and label smoothing compute other
functions and take `_level_loss_plain`, a separate path in plain ops.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MHDConfig:
    nu_emb: float = 1.0
    nu_aux: float = 3.0
    num_aux_heads: int = 4
    delta: int = 1  # Δ distillation targets per step
    confidence: str = "max"  # "max" | "entropy" | "margin" | "random"
    use_self: bool = False  # SF
    use_same_level: bool = False  # SL
    skip_when_student_confident: bool = False  # §4.2.2 single-head variant
    # runtime (paper §4.1)
    pool_size: int = 8  # N_P
    pool_update_every: int = 200  # S_P
    label_smooth_teacher: float = 0.0


def normalized(x: Tensor, eps: float = 1e-8) -> Tensor:
    """ψ^norm of §3.2 — embedding-norm drift protection."""
    x = x.float()
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


def embedding_distillation_loss(student_emb: Tensor, teacher_embs: Tensor,
                                nu_emb: float) -> Tensor:
    """Eq. (2) with ρ(x) = x² on normalized embeddings, through the
    ``emb_dist`` kernel on the (Δ·B, E) rows.

    student_emb: (B, E); teacher_embs: (Δ, B, E), constants.
    """
    if nu_emb == 0.0:
        return torch.zeros((), dtype=torch.float32,
                           device=student_emb.device)
    D, B, E = teacher_embs.shape
    s = student_emb.float().unsqueeze(0).expand(D, B, E).reshape(D * B, E)
    t = teacher_embs.detach().float().reshape(D * B, E)
    d = ops.emb_dist(s, t).view(D, B)
    return nu_emb * d.sum(dim=0).mean()


def _confidence(logits: Tensor, measure: str = "max") -> Tensor:
    """Λ(h): max softmax prob (the paper), or the beyond-paper "entropy"
    (−H) and "margin" (top-1 − top-2); higher = more confident."""
    p = torch.softmax(logits.float(), dim=-1)
    if measure == "max":
        return p.amax(dim=-1)
    if measure == "entropy":
        return (p * torch.log(p + 1e-20)).sum(dim=-1)
    if measure == "margin":
        v2 = torch.topk(p, 2, dim=-1).values
        return v2[..., 0] - v2[..., 1]
    raise ValueError(measure)


def _xent_to_target(student_logits: Tensor, target_probs: Tensor) -> Tensor:
    """−Σ target · log softmax(student); per-sample (B,)."""
    logp = F.log_softmax(student_logits.float(), dim=-1)
    return -(target_probs * logp).sum(dim=-1)


def _gather0(x: Tensor, winner: Tensor) -> Tensor:
    """x (n, B, ...) at row winner[b] of each sample b -> (B, ...)."""
    idx = winner.view(1, -1, *([1] * (x.dim() - 2))).expand(
        1, *x.shape[1:])
    return x.gather(0, idx)[0]


def _level_loss_kernel(student_head: Tensor, cand: Tensor, cfg: MHDConfig,
                       gen: Optional[torch.Generator]
                       ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """One ``dist_ce`` launch over every (candidate, sample) row.
    Returns (per_sample, winner, win_conf, own_conf)."""
    n, B, C = cand.shape
    s = student_head.float().unsqueeze(0).expand(n, B, C).reshape(n * B, C)
    ce, t_conf, s_conf = ops.dist_ce(s, cand.float().reshape(n * B, C))
    conf = t_conf.view(n, B)
    if cfg.confidence == "random":
        winner = torch.randint(0, n, (B,), generator=gen,
                               device=cand.device)
    else:
        winner = conf.argmax(dim=0)
    per_sample = _gather0(ce.view(n, B), winner)
    return per_sample, winner, _gather0(conf, winner), s_conf.view(n, B)[0]


def _level_loss_plain(student_head: Tensor, cand: Tensor, cfg: MHDConfig,
                      gen: Optional[torch.Generator]
                      ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The ``entropy`` / ``margin`` / label-smoothed levels in plain ops,
    as the reference writes them."""
    measure = "max" if cfg.confidence == "random" else cfg.confidence
    conf = _confidence(cand, measure)  # (n_cand, B)
    if cfg.confidence == "random":
        winner = torch.randint(0, cand.shape[0], conf.shape[1:],
                               generator=gen, device=cand.device)
    else:
        winner = conf.argmax(dim=0)
    target = torch.softmax(_gather0(cand, winner).float(), dim=-1)
    if cfg.label_smooth_teacher:
        C = target.shape[-1]
        target = (1 - cfg.label_smooth_teacher) * target + \
            cfg.label_smooth_teacher / C
    per_sample = _xent_to_target(student_head, target)
    own = None
    if cfg.skip_when_student_confident:
        own = _confidence(student_head.detach(), measure)
    return per_sample, winner, _gather0(conf, winner), own


def uses_kernels(cfg: MHDConfig) -> bool:
    """Whether the aux-head levels go through the ``dist_ce`` kernel."""
    return cfg.confidence in ("max", "random") and \
        not cfg.label_smooth_teacher


def multi_head_distillation_loss(
    student_out: Dict[str, Any],
    teacher_outs: Dict[str, Any],
    cfg: MHDConfig,
    rng: Optional[torch.Generator] = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Eqs. (4)+(5): the chained, confidence-gated aux-head loss.

    student_out: {"embedding": (B,E), "logits": (B,C), "aux_logits": (m,B,C)}
    teacher_outs: the same with a leading Δ axis (stacked sampled
                  teachers), constants.
    ``rng`` is the generator ``confidence="random"`` draws winners from.
    """
    m = cfg.num_aux_heads
    assert student_out["aux_logits"].shape[0] == m
    if cfg.confidence == "random" and rng is None:
        raise ValueError("random confidence needs rng")
    level_loss = _level_loss_kernel if uses_kernels(cfg) \
        else _level_loss_plain
    teachers_main = teacher_outs["logits"]  # (Δ, B, C)
    total = torch.zeros((), dtype=torch.float32,
                        device=student_out["logits"].device)
    metrics: Dict[str, Tensor] = {}

    for k in range(1, m + 1):
        student_head = student_out["aux_logits"][k - 1]  # (B, C)
        # candidate sources at level k-1 (teachers ∪ self, Eq. 4)
        if k == 1:
            teacher_src = teachers_main
            self_src = student_out["logits"][None]
        else:
            teacher_src = teacher_outs["aux_logits"][:, k - 2]
            self_src = student_out["aux_logits"][k - 2][None]
        candidates = [teacher_src, self_src]
        if cfg.use_same_level:  # SL: teachers' level-k heads
            candidates.append(teacher_outs["aux_logits"][:, k - 1])
        n_before_self = sum(c.shape[0] for c in candidates)
        if cfg.use_self:  # SF: the distilled head itself
            candidates.append(student_head[None])
        cand = torch.cat([c.detach().float() for c in candidates], dim=0)

        per_sample, winner, win_conf, own = level_loss(
            student_head, cand, cfg, rng)

        keep = torch.ones_like(per_sample)
        if cfg.use_self:  # SF: skip samples where the head itself won
            keep = keep * (winner < n_before_self).float()
        if cfg.skip_when_student_confident:
            keep = keep * (own <= win_conf).float()

        loss_k = (per_sample * keep).sum() / torch.clamp(keep.sum(), min=1.0)
        total = total + loss_k
        metrics[f"aux{k}_dist_loss"] = loss_k
        metrics[f"aux{k}_keep_frac"] = keep.mean()
        metrics[f"aux{k}_teacher_frac"] = (
            winner < teacher_src.shape[0]).float().mean()

    return cfg.nu_aux * total, metrics


def mhd_total_loss(
    student_out_private: Dict[str, Any],
    private_labels: Tensor,
    student_out_public: Dict[str, Any],
    teacher_outs_public: Dict[str, Any],
    cfg: MHDConfig,
    rng: Optional[torch.Generator] = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """The full client objective, Eq. (1)."""
    logits = student_out_private["logits"].float()
    ce = F.cross_entropy(logits, private_labels.long())

    # teachers may arrive without embeddings (a wire format that ships
    # predictions only — emb_encoding="none"): Eq. 2 drops out
    teacher_emb = teacher_outs_public.get("embedding")
    if teacher_emb is None:
        emb = torch.zeros((), dtype=torch.float32, device=logits.device)
    else:
        emb = embedding_distillation_loss(
            student_out_public["embedding"], teacher_emb.detach(),
            cfg.nu_emb)
    aux, metrics = multi_head_distillation_loss(
        student_out_public, teacher_outs_public, cfg, rng)

    loss = ce + emb + aux
    metrics.update({"ce": ce, "emb_dist": emb, "aux_dist_total": aux})
    return loss, metrics
