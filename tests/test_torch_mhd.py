"""The port's MHD loss (repro_torch.core.mhd) against the JAX package's:
the total loss, every metric and the student gradients, for each variant.

The default configuration (confidence "max", no label smoothing) runs
through the port's kernel dispatch — on the CPU their plain versions —
while "entropy", "margin" and label smoothing take the plain-ops path.
``random`` draws from a torch generator where the reference draws from
jax.random, so it gets a distribution test.

Tolerance 1e-5 relative / 1e-5 absolute (float32); the teacher and keep
fractions are equal (no near-tie at these inputs).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mhd as JM
from repro_torch.core import mhd as TM

B, C, E, M, D = 12, 9, 16, 3, 2
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    student = {"embedding": f(B, E), "logits": f(B, C, sc=2.0),
               "aux_logits": f(M, B, C, sc=2.0)}
    private = {"logits": f(B, C, sc=2.0)}
    teachers = {"embedding": f(D, B, E), "logits": f(D, B, C, sc=3.0),
                "aux_logits": f(D, M, B, C, sc=3.0)}
    labels = rng.integers(0, C, size=B).astype(np.int32)
    return student, private, teachers, labels


VARIANTS = {
    "default": {},
    "entropy": dict(confidence="entropy"),
    "margin": dict(confidence="margin"),
    "same_level": dict(use_same_level=True),
    "self": dict(use_self=True),
    "skip_confident": dict(skip_when_student_confident=True),
    "skip_confident_entropy": dict(skip_when_student_confident=True,
                                   confidence="entropy"),
    "label_smooth": dict(label_smooth_teacher=0.1),
    "sl_sf_skip": dict(use_same_level=True, use_self=True,
                       skip_when_student_confident=True),
    "no_emb": dict(nu_emb=0.0),
}


def _run_jax(cfg, student, private, teachers, labels):
    def loss_fn(st, pl):
        return JM.mhd_total_loss({"logits": pl}, jnp.asarray(labels), st,
                                 {k: jnp.asarray(v) for k, v in
                                  teachers.items()}, cfg,
                                 jax.random.PRNGKey(0))

    st = {k: jnp.asarray(v) for k, v in student.items()}
    (loss, metrics), grads = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(st,
                                               jnp.asarray(private["logits"]))
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def _run_torch(cfg, student, private, teachers, labels):
    st = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in student.items()}
    pl = torch.from_numpy(private["logits"].copy()).requires_grad_()
    loss, metrics = TM.mhd_total_loss(
        {"logits": pl}, torch.from_numpy(labels), st,
        {k: torch.from_numpy(v) for k, v in teachers.items()}, cfg,
        torch.Generator().manual_seed(0))
    keys = [k for k in ("embedding", "aux_logits", "logits")]
    grads = torch.autograd.grad(loss, [st[k] for k in keys] + [pl],
                                allow_unused=True, materialize_grads=True)
    metrics = {k: float(v.detach()) for k, v in metrics.items()}
    return float(loss.detach()), metrics, dict(zip(keys + ["private"],
                                                   grads))


@pytest.mark.parametrize("variant", list(VARIANTS), ids=list(VARIANTS))
def test_loss_metrics_and_gradients_match_reference(variant):
    kw = dict(nu_emb=1.0, nu_aux=3.0, num_aux_heads=M, delta=D)
    kw.update(VARIANTS[variant])
    jcfg, tcfg = JM.MHDConfig(**kw), TM.MHDConfig(**kw)
    student, private, teachers, labels = _inputs()
    jl, jm, (jg_st, jg_pl) = _run_jax(jcfg, student, private, teachers,
                                      labels)
    tl, tm, tg = _run_torch(tcfg, student, private, teachers, labels)
    np.testing.assert_allclose(tl, jl, **TOL)
    assert jm.keys() == tm.keys()
    for k in jm:
        if k.endswith("_frac"):  # the same count of the B samples
            assert round(tm[k] * B) == round(jm[k] * B), k
        else:
            np.testing.assert_allclose(tm[k], jm[k], **TOL, err_msg=k)
    for k in ("embedding", "aux_logits", "logits"):
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg_st[k]),
                                   **TOL, err_msg=k)
    np.testing.assert_allclose(tg["private"].numpy(), np.asarray(jg_pl),
                               **TOL)


def test_default_config_routes_through_the_kernel_dispatch():
    assert TM.uses_kernels(TM.MHDConfig())
    assert TM.uses_kernels(TM.MHDConfig(confidence="random"))
    assert not TM.uses_kernels(TM.MHDConfig(confidence="entropy"))
    assert not TM.uses_kernels(TM.MHDConfig(label_smooth_teacher=0.1))


def test_embedding_loss_matches_reference():
    student, _, teachers, _ = _inputs(1)
    j = JM.embedding_distillation_loss(jnp.asarray(student["embedding"]),
                                       jnp.asarray(teachers["embedding"]),
                                       0.7)
    t = TM.embedding_distillation_loss(
        torch.from_numpy(student["embedding"]),
        torch.from_numpy(teachers["embedding"]), 0.7)
    np.testing.assert_allclose(float(t), float(j), **TOL)
    np.testing.assert_allclose(
        TM.normalized(torch.from_numpy(student["embedding"])).numpy(),
        np.asarray(JM.normalized(jnp.asarray(student["embedding"]))), **TOL)


@pytest.mark.parametrize("measure", ["max", "entropy", "margin"])
def test_confidence_measures_match_reference(measure):
    x = _inputs(2)[2]["logits"]
    np.testing.assert_allclose(
        TM._confidence(torch.from_numpy(x), measure).numpy(),
        np.asarray(JM._confidence(jnp.asarray(x), measure)), **TOL)


@pytest.mark.parametrize("variant", ["kernel", "plain"])
def test_random_confidence_picks_candidates_uniformly(variant):
    """confidence="random": over many draws each of the n_cand = Δ + 1
    candidates wins about equally often (the reference draws the same
    distribution from jax.random), and every other metric is finite."""
    kw = dict(num_aux_heads=M, delta=D, confidence="random")
    if variant == "plain":
        kw["label_smooth_teacher"] = 1e-6  # forces the plain-ops path
    cfg = TM.MHDConfig(**kw)
    student, _, teachers, _ = _inputs(3)
    st = {k: torch.from_numpy(v) for k, v in student.items()}
    te = {k: torch.from_numpy(v) for k, v in teachers.items()}
    fracs = []
    for seed in range(200):
        _, metrics = TM.multi_head_distillation_loss(
            st, te, cfg, torch.Generator().manual_seed(seed))
        assert all(np.isfinite(float(v)) for v in metrics.values())
        fracs += [float(metrics[f"aux{k}_teacher_frac"])
                  for k in range(1, M + 1)]
    # teachers are D of the D + 1 candidates: mean frac → 2/3; the mean of
    # 600 fractions of 12 Bernoulli draws has std ≈ 0.0056
    assert abs(np.mean(fracs) - D / (D + 1)) < 0.03
    with pytest.raises(ValueError):
        TM.multi_head_distillation_loss(st, te, cfg, None)
