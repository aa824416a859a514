"""The port's Multi-head Latent Attention, DeepSeek MTP and the
deepseek-v3-671b configuration against the JAX package, fed the same
seeded numpy inputs and the reference's params through the npz path.

Covers `repro_torch.models.mla` (``_compress`` and ``mla_apply`` in the
dense form and in the query-block form, at T = 2048 where the reference
switches to it, and their gradients), reduced deepseek-v3-671b as a whole
model (``apply_lm``'s logits, ``mtp_hidden`` and ``aux_loss``;
``lm_loss``'s ``ce``, ``aux_loss``, ``mtp_ce`` and every gradient), the
MHD loss with the MTP branch left out (the reference's ``jit`` drops it:
its leaves get zero gradients in both packages), the deepseek tree
through the npz files, and a K = 2 fleet of reduced deepseek-v3 clients
under AdamW with weight decay (which moves the MTP leaves on their zero
gradients) in both packages' DecentralizedTrainer.

Tolerances are tests/test_torch_lm.py's: outputs and losses 2e-5, the
router's aux loss and gradients 1e-4 of the largest entry of each array;
the MHD loss 1e-4 (bf16 rows); step metrics 2e-4 relative / 2e-5
absolute (tests/test_torch_lm_runtime.py); the teacher schedule exactly.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as JIO
from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.models import mla as JMLA
from repro.models import transformer as JTF
from repro.models.config import MLAConfig as JMLAConfig
from repro_torch.checkpoint import io as TIO
from repro_torch.configs import get_config, get_reduced
from repro_torch.models import build_bundle
from repro_torch.models import mla as TMLA
from repro_torch.models import transformer as TTF
from repro_torch.models.config import MLAConfig
import test_torch_threads

test_torch_threads.share_cores()

for _op in (torch.exp, torch.log, torch.sqrt):
    _op(torch.ones(1))

NAME = "deepseek-v3-671b"
TOL, TOL_GRAD = 2e-5, 1e-4


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in JIO.flatten_with_paths(tree).items()}


def _grad_params(flat: dict) -> dict:
    return {k: v.requires_grad_() for k, v in
            TIO.params_from_jax(flat, device="cpu").items()}


# ---------------------------------------------------------------------------
# the MLA module
# ---------------------------------------------------------------------------

# (name, B, T, D, H, q_lora, kv_lora, dn, dr, dv): the dense form, and the
# query-block form at the reference's threshold (T·T = 2048²)
MLA_CASES = [("dense", 2, 64, 64, 4, 32, 24, 16, 8, 16),
             ("blockwise", 1, 2048, 32, 2, 16, 16, 16, 8, 16)]


@pytest.mark.parametrize("case", MLA_CASES, ids=[c[0] for c in MLA_CASES])
def test_mla_matches_jax(case):
    """``_compress``'s four outputs, ``mla_apply`` and the gradients of
    every param and of x under a random cotangent."""
    name, B, T, D, H, ql, kl, dn, dr, dv = case
    kw = dict(q_lora_rank=ql, kv_lora_rank=kl, qk_nope_head_dim=dn,
              qk_rope_head_dim=dr, v_head_dim=dv)
    jcfg, cfg = JMLAConfig(**kw), MLAConfig(**kw)
    assert (T * T >= TMLA.BLOCKWISE_SCORE_THRESHOLD) == (name == "blockwise")
    jp = jax.jit(lambda k: JMLA.init_mla(k, D, H, jcfg))(
        jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    ct = rng.standard_normal((B, T, D)).astype(np.float32)
    pos = jnp.arange(T)[None]
    parts_j = jax.jit(lambda p, xx: JMLA._compress(p, jcfg, xx, pos,
                                                   10_000.0))(
        jp, jnp.asarray(x))

    def f_j(p, xx):
        y = JMLA.mla_apply(p, xx, jcfg, H)
        return jnp.sum(y * ct), y

    # under jit, as the reference runs: one compile, not op by op
    (_, y_j), (gp_j, gx_j) = jax.jit(jax.value_and_grad(
        f_j, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    params = _grad_params(_flat(jp))
    xt = torch.from_numpy(x).requires_grad_()
    parts = TMLA._compress(params, cfg, xt, torch.arange(T)[None], 10_000.0)
    for a, b, nm in zip(parts, parts_j, ("q_nope", "q_rope", "c_kv",
                                         "k_rope")):
        assert a.shape == b.shape, nm
        assert _rel(a.detach().numpy(), b) < TOL, nm
    y = TMLA.mla_apply(params, xt, cfg, H)
    assert _rel(y.detach().numpy(), y_j) < TOL
    grads = torch.autograd.grad((y * torch.from_numpy(ct)).sum(),
                                [*params.values(), xt])
    gp_j = JIO.flatten_with_paths(gp_j)
    for k, g in zip(params, grads):
        assert _rel(g.numpy(), gp_j[k]) < TOL_GRAD, k
    assert _rel(grads[-1].numpy(), gx_j) < TOL_GRAD
    if name == "blockwise":  # one block at a time: the dense form's rows
        with torch.no_grad():
            q_n, q_r, c_kv, k_r = parts
            k_n = torch.einsum("btr,rhd->bthd", c_kv, params["w_uk"])
            v = torch.einsum("btr,rhd->bthd", c_kv, params["w_uv"])
            s = (dn + dr) ** -0.5
            torch.testing.assert_close(
                TMLA._blockwise_mla(q_n, q_r, k_n, k_r, v, s, TMLA.BLOCK_Q),
                TMLA._attend(q_n, q_r, k_n, k_r, v, s, 0), rtol=1e-5,
                atol=1e-6)


# ---------------------------------------------------------------------------
# reduced deepseek-v3 as a whole model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def deepseek():
    """The reference's reduced deepseek-v3 (a dense layer, then two MoE
    layers of 4 sigmoid-routed experts top-2 beside a shared expert, MLA,
    MTP, vocab 512, 2 aux heads): params, forward, loss and gradients,
    built once, under jit."""
    jcfg = jax_reduced(NAME)
    jp = jax.jit(lambda k: JTF.init_lm(k, jcfg))(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 48)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(tokens)}
    out_j = jax.jit(lambda p, b: JTF.apply_lm(p, jcfg, b))(jp, jbatch)
    (loss_j, m_j), g_j = jax.jit(jax.value_and_grad(
        lambda p, b: JTF.lm_loss(p, jcfg, b), has_aux=True))(jp, jbatch)
    return dict(jcfg=jcfg, jp=jp, flat=_flat(jp), tokens=tokens,
                out_j=out_j, loss_j=float(loss_j),
                m_j={k: float(v) for k, v in m_j.items()},
                g_j=JIO.flatten_with_paths(g_j))


def test_deepseek_configs_match_reference():
    """The copied configs, field for field."""
    for get, jget in ((get_config, jax_config), (get_reduced, jax_reduced)):
        assert dataclasses.asdict(get(NAME)) == dataclasses.asdict(jget(NAME))
    cfg = get_config(NAME)
    assert (cfg.mla is not None, cfg.mtp, cfg.moe_scoring,
            cfg.moe.num_shared_experts) == (True, True, "sigmoid", 1)


def test_init_lm_keys_and_shapes_match_jax(deepseek):
    """The reduced config builds with the reference's keys and shapes:
    MLA leaves stacked per stage, the MTP block unstacked."""
    port = TTF.init_lm(torch.Generator().manual_seed(0), get_reduced(NAME),
                       device="cpu")
    assert {k: tuple(v.shape) for k, v in port.items()} == \
        {k: v.shape for k, v in deepseek["flat"].items()}
    assert port["stage1/layer0/attn/w_uk"].shape == (2, 32, 4, 32)
    assert port["mtp/proj"].shape == (256, 128)
    assert port["mtp/layer/attn/w_uv"].shape == (32, 4, 32)


def test_reduced_deepseek_apply_lm_matches_jax(deepseek):
    """hidden, logits, aux heads and mtp_hidden within 2e-5; aux_loss (the
    sigmoid routers' load-balance losses) within 1e-4; no mtp_hidden when
    the branch is left out."""
    params = TIO.params_from_jax(deepseek["flat"], device="cpu")
    batch = {"tokens": torch.from_numpy(deepseek["tokens"])}
    bundle = build_bundle(get_reduced(NAME))
    with torch.no_grad():
        out = bundle.apply(params, batch)
        bare = bundle.apply(params, batch, mtp=False)
    out_j = deepseek["out_j"]
    for key in ("hidden", "logits", "aux_heads", "mtp_hidden"):
        assert out[key].shape == out_j[key].shape, key
        assert _rel(out[key].numpy(), out_j[key]) < TOL, key
    aux_j = float(out_j["aux_loss"])
    assert aux_j > 0 and abs(out["aux_loss"].item() - aux_j) <= TOL_GRAD * aux_j
    assert "mtp_hidden" not in bare
    torch.testing.assert_close(bare["logits"], out["logits"], rtol=0, atol=0)


@pytest.mark.parametrize("remat", ["none", "unit"])
def test_reduced_deepseek_lm_loss_and_grads_match_jax(deepseek, remat):
    """lm_loss and its three parts, and every gradient (the MTP leaves'
    among them), against the reference; with remat per unit (the card's
    setting at full width) as without."""
    cfg = dataclasses.replace(get_reduced(NAME), remat=remat)
    params = _grad_params(deepseek["flat"])
    loss, m = TTF.lm_loss(params, cfg,
                          {"tokens": torch.from_numpy(deepseek["tokens"])})
    assert set(m) == set(deepseek["m_j"]) == {"ce", "aux_loss", "mtp_ce"}
    np.testing.assert_allclose(loss.item(), deepseek["loss_j"], rtol=TOL)
    for k in ("ce", "mtp_ce"):
        np.testing.assert_allclose(m[k].item(), deepseek["m_j"][k], rtol=TOL)
    np.testing.assert_allclose(m["aux_loss"].item(), deepseek["m_j"][
        "aux_loss"], rtol=TOL_GRAD)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    g_j = deepseek["g_j"]
    assert set(params) == set(g_j)
    for k, g in zip(params, grads):
        assert _rel(g.numpy(), g_j[k]) < TOL_GRAD, k
    assert np.abs(g_j["mtp/proj"]).max() > 0


def test_lm_mhd_loss_skips_mtp_and_matches_jax(deepseek):
    """Eq. (1) for a deepseek client (private CE + the chained aux-head
    distillation on bf16 rows) against random teachers: the loss, its
    metrics and every gradient as the reference's; the MTP leaves' at
    zero in both; the branch never run in the port."""
    from repro.core.lm_adapter import lm_mhd_loss as jax_lm_loss
    from repro.core.mhd import MHDConfig as JMHDConfig
    from repro.models.zoo import build_bundle as jax_bundle
    from repro_torch.core.mhd import MHDConfig
    from repro_torch.core.runtime import client_loss
    from repro_torch.lm import lm_client_bundle

    jcfg, jp, tokens = deepseek["jcfg"], deepseek["jp"], deepseek["tokens"]
    priv, pub = tokens[:, :20], tokens[:, 20:40]
    rng = np.random.default_rng(5)
    n, V = 2 * 19, jcfg.vocab_size
    teachers = {"logits": rng.normal(size=(1, n, V)) * 2,
                "aux_logits": rng.normal(size=(1, 2, n, V)) * 2}
    teachers = {k: v.astype(np.float32) for k, v in teachers.items()}
    kw = dict(nu_emb=0.0, nu_aux=0.5, num_aux_heads=2, delta=1)
    (loss_j, m_j), g_j = jax.jit(jax.value_and_grad(
        lambda p, a, b, te: jax_lm_loss(jax_bundle(jcfg), p, a, b, te,
                                        JMHDConfig(**kw)), has_aux=True))(
        jp, {"tokens": jnp.asarray(priv)}, {"tokens": jnp.asarray(pub)},
        {k: jnp.asarray(v) for k, v in teachers.items()})
    g_j = JIO.flatten_with_paths(g_j)

    inner = build_bundle(get_reduced(NAME))
    seen = []

    def apply(params, batch, mtp=True):
        seen.append(mtp)
        return inner.apply(params, batch, mtp=mtp)

    bundle = lm_client_bundle(dataclasses.replace(inner, apply=apply))
    params = _grad_params(deepseek["flat"])
    loss, m = client_loss(
        bundle, params, {"tokens": torch.from_numpy(priv)},
        {"tokens": torch.from_numpy(pub)},
        {k: torch.from_numpy(v) for k, v in teachers.items()},
        MHDConfig(**kw))
    assert seen and not any(seen)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-4)
    for k in m_j:
        np.testing.assert_allclose(m[k].item(), float(m_j[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    grads = dict(zip(params, torch.autograd.grad(
        loss, list(params.values()), allow_unused=True,
        materialize_grads=True)))
    mtp_leaves = [k for k in params if k.startswith("mtp/")]
    assert len(mtp_leaves) >= 12
    for k, g in grads.items():
        if k in mtp_leaves:
            assert not g.any() and not np.any(g_j[k]), k
        else:
            assert _rel(g.numpy(), g_j[k]) < TOL_GRAD, k


def test_deepseek_params_npz_round_trip(deepseek, tmp_path):
    """The deepseek tree crosses unchanged both ways. ``mtp/proj`` shares
    its last name with a ResNet conv kernel and is kept out of the
    HWIO -> OIHW path by its two dimensions; a stacked ``w_uk``/``w_uv``
    is 4-D and is kept out by its name."""
    from repro_torch.models.resnet import is_conv_kernel

    jp, flat = deepseek["jp"], deepseek["flat"]
    assert flat["mtp/proj"].ndim == 2 and is_conv_kernel("mtp/proj", 4)
    for k in ("stage1/layer0/attn/w_uk", "stage1/layer0/attn/w_uv"):
        assert flat[k].ndim == 4 and not is_conv_kernel(k, 4)
    a = os.path.join(tmp_path, "jax.npz")
    b = os.path.join(tmp_path, "port.npz")
    JIO.save_pytree(a, jp)
    params = TIO.params_from_jax(TIO.load_pytree(a), device="cpu")
    for k in ("mtp/proj", "stage1/layer0/attn/w_uk",
              "stage1/layer0/attn/w_uv", "mtp/layer/attn/w_uk"):
        assert np.array_equal(params[k].numpy(), flat[k]), k
    TIO.save_pytree(b, TIO.params_to_jax(params))
    back = TIO.load_pytree(b)
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
    again = JIO.load_pytree(b, jp)
    for x, y in zip(jax.tree_util.tree_leaves(again),
                    jax.tree_util.tree_leaves(jp)):
        assert np.array_equal(np.asarray(x), np.asarray(y))


# ---------------------------------------------------------------------------
# a K = 2 fleet of reduced deepseek-v3 clients
# ---------------------------------------------------------------------------

STEPS, K, DOMAINS, SEQ, M = 6, 2, 6, 16, 2
MAX_POS, POS_SEED = 24, 17


def _trainer(pkg, bundles=None):
    if pkg == "jax":
        from repro import data as D
        from repro import lm as LM
        from repro.comm import CommConfig
        from repro.core import DecentralizedTrainer, MHDConfig, RunConfig
        from repro.core.graph import complete_graph
        from repro.models.zoo import build_bundle as bb
        from repro.optim.optimizers import OptimizerConfig, make_optimizer
        cfg, extra = jax_reduced(NAME), {}
    else:
        from repro_torch import data as D
        from repro_torch import lm as LM
        from repro_torch.comm import CommConfig
        from repro_torch.core import (DecentralizedTrainer, MHDConfig,
                                      RunConfig, complete_graph)
        from repro_torch.optim import OptimizerConfig, make_optimizer
        bb, cfg, extra = build_bundle, get_reduced(NAME), {"device": "cpu"}
    arrays = LM.make_text_arrays(DOMAINS, 12, SEQ, 512, seed=0, table_seed=0)
    part = D.partition_dataset(arrays["labels"], D.PartitionConfig(
        num_clients=K, num_labels=DOMAINS, labels_per_client=2, skew=100.0,
        gamma_pub=0.2, seed=0))
    if bundles is None:
        bundles = [LM.lm_client_bundle(bb(cfg), MAX_POS, POS_SEED)
                   for _ in range(K)]
    return DecentralizedTrainer(
        bundles,
        make_optimizer(OptimizerConfig(name="adamw", init_lr=1e-3,
                                       warmup_steps=2, total_steps=STEPS,
                                       weight_decay=0.1,
                                       grad_clip_norm=1.0)),
        MHDConfig(nu_emb=0.0, nu_aux=0.5, num_aux_heads=M, delta=1,
                  pool_size=2, pool_update_every=2),
        RunConfig(steps=STEPS, batch_size=4, public_batch_size=4,
                  eval_every=0, eval_batch_size=8, seed=0),
        arrays, part.client_indices, part.public_indices, complete_graph(K),
        DOMAINS, exchange="prediction_adaptive",
        comm=CommConfig(topk=8, val_dtype="float16", emb_encoding="none",
                        budget_bytes_per_token=24, compression="delta"),
        **extra)


def test_deepseek_fleet_tracks_reference():
    """Both packages' trainers from the reference's init params: the
    teacher schedule step for step, every step metric, the wire bytes;
    after the run the MTP leaves (zero gradients every step) decayed by
    AdamW as the reference's."""
    from repro_torch.lm import lm_client_bundle

    tj = _trainer("jax")
    bundles = []
    for c in tj.clients:
        flat = _flat(c.params)
        b = lm_client_bundle(build_bundle(get_reduced(NAME)), MAX_POS,
                             POS_SEED)
        bundles.append(dataclasses.replace(
            b, init=lambda gen, flat=flat: TIO.params_from_jax(
                flat, device="cpu")))
    tp = _trainer("torch", bundles)
    sched_j, sched_p = [], []
    for t in range(STEPS):
        mj, mp = tj.step(t), tp.step(t)
        assert mj.keys() == mp.keys(), t
        sched_j.append([mj[f"c{i}/distill_active"] for i in range(K)])
        sched_p.append([mp[f"c{i}/distill_active"] for i in range(K)])
        for k in mj:
            if k.endswith("_frac"):
                assert round(mp[k] * MAX_POS) == round(mj[k] * MAX_POS), \
                    (t, k)
            elif k.endswith(("distill_active", "stale_skipped",
                             "mail_staleness")):
                assert mp[k] == mj[k], (t, k)
            else:
                np.testing.assert_allclose(mp[k], mj[k], rtol=2e-4,
                                           atol=2e-5, err_msg=f"{k} @ {t}")
    assert sched_p == sched_j
    assert any(any(row) for row in sched_j)
    assert tp.meter.total_bytes == tj.meter.total_bytes
    for cj, cp, b in zip(tj.clients, tp.clients, bundles):
        start, now_j = b.init(None), _flat(cj.params)
        for k in (k for k in start if k.startswith("mtp/")):
            got = cp.params[k].numpy()
            assert not np.array_equal(got, start[k].numpy()) or \
                not start[k].any(), k
            np.testing.assert_allclose(got, now_j[k], rtol=1e-6, atol=1e-7,
                                       err_msg=k)
