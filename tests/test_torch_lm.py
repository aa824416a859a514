"""The port's LM skeleton and positions-as-samples adapter against the JAX
package, on the reduced mamba2-370m config (2 layers, d_model 128,
d_state 16, chunk 32, vocab 512, 2 aux heads), with the JAX parameters
carried across through the path-keyed npz format.

Tolerances: hidden states, logits and the loss 2e-5 (float32 CPU matmuls
summed in another order by the two frameworks); gradients 1e-4 of the
largest entry of each leaf; the LM MHD loss 1e-4 (its distillation terms
read logits cast to bf16, where a float32 ulp can flip a rounding); positions, labels and rows exactly; bf16
logits within one bf16 ulp (the cast rounds f32 values that already differ
by ~1e-6); the permutation twin exactly.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as JIO
from repro.configs import get_reduced as jax_reduced
from repro.core.lm_adapter import lm_mhd_outputs as jax_lm_outputs
from repro.models import transformer as JTF
from repro.models.zoo import build_bundle as jax_bundle
from repro_torch.checkpoint import io as TIO
from repro_torch.configs import get_reduced
from repro_torch.core.lm_adapter import jax_permutation, lm_mhd_outputs
from repro_torch.models import build_bundle
from repro_torch.models import transformer as TTF
from repro_torch.models.config import LayerSpec, uniform_stages
import test_torch_threads

test_torch_threads.share_cores()

for _op in (torch.exp, torch.log, torch.sqrt):
    _op(torch.ones(1))

NAME = "mamba2-370m"


@pytest.fixture(scope="module")
def model():
    jcfg = jax_reduced(NAME)
    jp = JTF.init_lm(jax.random.PRNGKey(0), jcfg)
    flat = {k: np.asarray(v) for k, v in JIO.flatten_with_paths(jp).items()}
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 64))
    return jcfg, jp, flat, tokens.astype(np.int32)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_init_lm_keys_and_shapes_match_jax(model):
    _, _, flat, _ = model
    port = TTF.init_lm(torch.Generator().manual_seed(0), get_reduced(NAME),
                       device="cpu")
    assert {k: tuple(v.shape) for k, v in port.items()} == \
        {k: v.shape for k, v in flat.items()}
    # an entry point of the port: the card unless the CPU is asked for
    if torch.cuda.is_available():
        assert TTF.init_lm(torch.Generator(), get_reduced(NAME))[
            "embed"].is_cuda
    else:
        with pytest.raises(RuntimeError):
            TTF.init_lm(torch.Generator(), get_reduced(NAME))


def test_apply_lm_and_lm_loss_match_jax(model):
    """The reduced config, forward and loss with JAX's params."""
    jcfg, jp, flat, tokens = model
    cfg = get_reduced(NAME)
    out_j = JTF.apply_lm(jp, jcfg, {"tokens": jnp.asarray(tokens)})
    loss_j, _ = JTF.lm_loss(jp, jcfg, {"tokens": jnp.asarray(tokens)})
    params = TIO.params_from_jax(flat, device="cpu")
    batch = {"tokens": torch.from_numpy(tokens)}
    out = TTF.apply_lm(params, cfg, batch)
    for key in ("hidden", "logits", "aux_heads"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(out_j[key]),
                                   rtol=2e-5, atol=2e-5, err_msg=key)
    loss, metrics = TTF.lm_loss(params, cfg, batch)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=2e-5)
    assert float(metrics["aux_loss"]) == 0.0


def test_lm_loss_gradients_match_jax_and_remat_changes_nothing(model):
    jcfg, jp, flat, tokens = model
    g_j = JIO.flatten_with_paths(jax.grad(
        lambda p: JTF.lm_loss(p, jcfg, {"tokens": jnp.asarray(tokens)})[0])(
            jp))
    batch = {"tokens": torch.from_numpy(tokens)}
    grads = {}
    for remat in ("none", "unit"):
        cfg = dataclasses.replace(get_reduced(NAME), remat=remat)
        params = {k: v.requires_grad_() for k, v in
                  TIO.params_from_jax(flat, device="cpu").items()}
        loss, _ = TTF.lm_loss(params, cfg, batch)
        grads[remat] = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()), allow_unused=True,
            materialize_grads=True)))
    for k, g in grads["none"].items():
        assert _rel(g.numpy(), g_j[k]) < 1e-4, k
        # checkpointing recomputes the same ops: the same gradient
        torch.testing.assert_close(grads["unit"][k], g, rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("case", ["cross", "mla", "mtp"],
                         ids=["cross-none", "mla", "mtp"])
def test_layer_kinds_ported_since_match_jax(case, model):
    """Cross attention, MLA and DeepSeek MTP, each ported since, build
    and run: the reduced skeleton with two gated
    cross-attention layers (no vision front end, so K and V come from the
    layer's own input, every key visible; the gates set to 0.5 in both
    packages, as at 0 the layer is multiplied away), with two
    full-attention MLA layers, and with the MTP block after its Mamba2
    layers, each holding its loss and metrics to the reference's from the
    same params."""
    from repro.models.config import (LayerSpec as JLayerSpec,
                                     MLAConfig as JMLAConfig,
                                     uniform_stages as j_uniform)
    from repro_torch.models.config import MLAConfig

    jcfg, _, _, tokens = model
    cfg = get_reduced(NAME)
    if case == "cross":
        spec = dict(attn="cross", ffn="none")
        cfg = dataclasses.replace(cfg, name="cross", stages=uniform_stages(
            2, LayerSpec(**spec)))
        jcfg = dataclasses.replace(jcfg, name="cross", stages=j_uniform(
            2, JLayerSpec(**spec)))
    mla = dict(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
               qk_rope_head_dim=8, v_head_dim=16)
    if case == "mla":
        spec = dict(attn="full", ffn="dense")
        cfg = dataclasses.replace(cfg, name="mla", d_ff=96, mla=MLAConfig(
            **mla), stages=uniform_stages(2, LayerSpec(**spec)))
        jcfg = dataclasses.replace(jcfg, name="mla", d_ff=96, mla=JMLAConfig(
            **mla), stages=j_uniform(2, JLayerSpec(**spec)))
    elif case == "mtp":
        cfg = dataclasses.replace(cfg, name="mtp", d_ff=96, mtp=True)
        jcfg = dataclasses.replace(jcfg, name="mtp", d_ff=96, mtp=True)
    params = TTF.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert ("stage0/layer0/attn/w_uk" in params) == (case == "mla")
    assert ("mtp/proj" in params) == (case == "mtp")
    assert ("stage0/layer0/cross_gate" in params) == (case == "cross")
    jp = jax.jit(lambda k: JTF.init_lm(k, jcfg))(jax.random.PRNGKey(0))
    if case == "cross":
        jp["stage0"]["layer0"]["cross_gate"] = jnp.full((2,), 0.5)
    flat = {k: np.asarray(v) for k, v in JIO.flatten_with_paths(jp).items()}
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: v.shape for k, v in flat.items()}
    tokens = tokens[:, :32]
    loss_j, m_j = jax.jit(lambda p, b: JTF.lm_loss(p, jcfg, b))(
        jp, {"tokens": jnp.asarray(tokens)})
    loss, m = TTF.lm_loss(TIO.params_from_jax(flat, device="cpu"), cfg,
                          {"tokens": torch.from_numpy(tokens)})
    assert set(m) == set(m_j) == {"ce", "aux_loss"} | (
        {"mtp_ce"} if case == "mtp" else set())
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=2e-5)
    for k in m_j:
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), rtol=2e-5,
                                   atol=1e-7, err_msg=k)


def _parity(jcfg, cfg, tokens, seed=0):
    """logits, aux_loss, lm_loss and every gradient of ``cfg`` against the
    reference's ``jcfg`` from the reference's params: logits and losses
    within 2e-5, aux_loss and gradients within 1e-4 of the largest entry
    (the MoE's router runs a softmax and a top-k over 4 experts)."""
    jp = JTF.init_lm(jax.random.PRNGKey(seed), jcfg)
    flat = {k: np.asarray(v) for k, v in JIO.flatten_with_paths(jp).items()}
    jbatch = {"tokens": jnp.asarray(tokens)}
    out_j = JTF.apply_lm(jp, jcfg, jbatch)
    loss_j, g_j = jax.value_and_grad(
        lambda p: JTF.lm_loss(p, jcfg, jbatch)[0])(jp)
    g_j = JIO.flatten_with_paths(g_j)
    params = {k: v.requires_grad_() for k, v in
              TIO.params_from_jax(flat, device="cpu").items()}
    batch = {"tokens": torch.from_numpy(tokens)}
    with torch.no_grad():
        out = TTF.apply_lm(params, cfg, batch)
    np.testing.assert_allclose(out["logits"].numpy(),
                               np.asarray(out_j["logits"]), rtol=2e-5,
                               atol=2e-5)
    aux_j = float(out_j["aux_loss"])
    assert aux_j > 0 and abs(out["aux_loss"].item() - aux_j) <= 1e-4 * aux_j
    loss, _ = TTF.lm_loss(params, cfg, batch)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=2e-5)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    assert set(params) == set(g_j)
    for k, g in zip(params, grads):
        assert _rel(g.numpy(), g_j[k]) < 1e-4, k
    return params


@pytest.mark.parametrize("attn,ffn", [("full", "moe"), ("mamba2", "moe"),
                                      ("swa", "moe_dense_parallel")])
def test_moe_layer_kinds_match_jax(model, attn, ffn):
    """The MoE FFN kinds in the reduced skeleton (4 experts, top-2,
    capacity 1.25, so pairs are dropped): logits, aux_loss (the routers'
    load-balance losses summed over the units) and gradients."""
    from repro.models.config import (LayerSpec as JLayerSpec,
                                     MoEConfig as JMoEConfig,
                                     uniform_stages as j_uniform)
    from repro_torch.models.config import MoEConfig

    jcfg, _, _, tokens = model
    moe = dict(num_experts=4, top_k=2, d_ff_expert=64, capacity_factor=1.25)
    kw = dict(name=f"{attn}-{ffn}", num_heads=4, num_kv_heads=2,
              window_size=16, d_ff=96)
    jcfg = dataclasses.replace(
        jcfg, stages=j_uniform(2, JLayerSpec(attn=attn, ffn=ffn)),
        moe=JMoEConfig(**moe), **kw)
    cfg = dataclasses.replace(
        get_reduced(NAME), stages=uniform_stages(2, LayerSpec(
            attn=attn, ffn=ffn)), moe=MoEConfig(**moe), **kw)
    params = _parity(jcfg, cfg, tokens[:, :32])
    assert params["stage0/layer0/ffn/w_gate"].shape == (2, 4, 128, 64)
    assert ("stage0/layer0/ffn_dense/w_up" in params) == \
        (ffn == "moe_dense_parallel")


def test_reduced_arctic_matches_jax():
    """Reduced arctic-480b (2 layers of attention with the dense residual
    SwiGLU beside a 4-expert top-2 MoE, vocab 512, 2 aux heads) as a
    whole model: logits, aux_loss and every gradient."""
    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config

    jcfg = jax_reduced("arctic-480b")
    cfg = get_reduced("arctic-480b")
    # the copied configs, field for field
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(get_config("arctic-480b")) == \
        dataclasses.asdict(jax_config("arctic-480b"))
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 48)).astype(np.int32)
    params = _parity(jcfg, cfg, tokens, seed=1)
    # the card runs arctic with remat="unit": the same gradients
    batch = {"tokens": torch.from_numpy(tokens)}
    grads = [torch.autograd.grad(
        TTF.lm_loss(params, dataclasses.replace(cfg, remat=r), batch)[0],
        list(params.values()), allow_unused=True, materialize_grads=True)
        for r in ("none", "unit")]
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("max_positions,seed", [(0, None), (40, None),
                                                (40, 17), (100, 3)])
def test_lm_mhd_outputs_match_jax(model, max_positions, seed):
    """Rows, labels and sample_rows exactly; bf16 logits within one ulp;
    the embedding within float32 tolerance."""
    jcfg, jp, flat, tokens = model
    tokens = tokens[:, :20]
    ref = jax_lm_outputs(jax_bundle(jcfg), jp, {"tokens": jnp.asarray(tokens)},
                         max_positions=max_positions, position_seed=seed)
    out = lm_mhd_outputs(build_bundle(get_reduced(NAME)),
                         TIO.params_from_jax(flat, device="cpu"),
                         {"tokens": torch.from_numpy(tokens)},
                         max_positions=max_positions, position_seed=seed)
    n = 2 * 19 if not max_positions else min(max_positions, 2 * 19)
    assert out["logits"].shape == (n, jcfg.vocab_size)
    assert out["logits"].dtype == torch.bfloat16
    assert out["aux_logits"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["labels"].numpy(),
                                  np.asarray(ref["labels"]))
    np.testing.assert_array_equal(out["sample_rows"].numpy(),
                                  np.asarray(ref["sample_rows"]))
    np.testing.assert_allclose(out["embedding"].numpy(),
                               np.asarray(ref["embedding"]), rtol=2e-5,
                               atol=2e-5)
    for key in ("logits", "aux_logits"):
        a = out[key].float().numpy()
        b = np.asarray(ref[key].astype(jnp.float32))
        np.testing.assert_allclose(a, b, rtol=2 ** -7, atol=1e-5)


def test_lm_mhd_loss_matches_jax(model):
    """Eq. (1) for an LM client (private next-token CE + the chained
    aux-head distillation on bf16 rows), against random teachers: the
    trainer's `client_loss` on an `lm_client_bundle` against the JAX
    package's `lm_mhd_loss`."""
    from repro.core.lm_adapter import lm_mhd_loss as jax_lm_loss
    from repro.core.mhd import MHDConfig as JMHDConfig
    from repro_torch.core.mhd import MHDConfig
    from repro_torch.core.runtime import client_loss
    from repro_torch.lm import lm_client_bundle

    jcfg, jp, flat, tokens = model
    priv, pub = tokens[:, :20], tokens[:, 20:40]
    rng = np.random.default_rng(5)
    n, V = 2 * 19, jcfg.vocab_size
    teachers = {"logits": rng.normal(size=(1, n, V)) * 2,
                "aux_logits": rng.normal(size=(1, 2, n, V)) * 2}
    teachers = {k: v.astype(np.float32) for k, v in teachers.items()}
    kw = dict(nu_emb=0.0, nu_aux=0.5, num_aux_heads=2, delta=1)
    loss_j, m_j = jax_lm_loss(
        jax_bundle(jcfg), jp, {"tokens": jnp.asarray(priv)},
        {"tokens": jnp.asarray(pub)},
        {k: jnp.asarray(v) for k, v in teachers.items()}, JMHDConfig(**kw))
    loss, m = client_loss(
        lm_client_bundle(build_bundle(get_reduced(NAME))),
        TIO.params_from_jax(flat, device="cpu"),
        {"tokens": torch.from_numpy(priv)}, {"tokens": torch.from_numpy(pub)},
        {k: torch.from_numpy(v) for k, v in teachers.items()},
        MHDConfig(**kw))
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-4)
    for k in m_j:
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("seed,n", [(17, 4088), (17, 38), (0, 1), (3, 2),
                                    (123456789, 5000), (2 ** 40 + 5, 3000),
                                    (7, 2_000_000)])
def test_permutation_twin_matches_jax(seed, n):
    np.testing.assert_array_equal(
        jax_permutation(seed, n),
        np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n)))


def test_lm_params_npz_round_trip(model, tmp_path):
    """A JAX LM tree saved by the JAX package loads into the port (stacked
    leaves keep their repeats axis, dense weights stay (in, out)), saves
    back to an identical npz, and loads into the JAX structure."""
    _, jp, flat, _ = model
    a = os.path.join(tmp_path, "jax.npz")
    b = os.path.join(tmp_path, "port.npz")
    JIO.save_pytree(a, jp)
    params = TIO.params_from_jax(TIO.load_pytree(a), device="cpu")
    assert params["stage0/layer0/attn/in_proj"].shape == (2, 128, 548)
    assert params["stage0/layer0/attn/conv/w"].shape == (2, 4, 288)
    TIO.save_pytree(b, TIO.params_to_jax(params))
    back = TIO.load_pytree(b)
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
    again = JIO.load_pytree(b, jp)
    for x, y in zip(jax.tree_util.tree_leaves(again),
                    jax.tree_util.tree_leaves(jp)):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def test_stacked_4d_lm_leaf_crosses_unchanged(tmp_path):
    """Only the ResNet's conv kernels change layout between the packages:
    a 4-D LM leaf — a MoE expert weight, stacked (R, E, D, F) — loads as
    the same array and saves back as the same array, beside a conv kernel
    that still goes HWIO -> OIHW and back."""
    rng = np.random.default_rng(8)
    flat = {"stage0/layer0/ffn/w_gate": rng.standard_normal((2, 4, 8, 16)),
            "stage0/layer0/ffn/w_down": rng.standard_normal((2, 4, 16, 8)),
            "stem": rng.standard_normal((3, 3, 3, 8)),
            "mu/s0b0/conv1": rng.standard_normal((3, 3, 8, 8))}
    flat = {k: v.astype(np.float32) for k, v in flat.items()}
    params = TIO.params_from_jax(flat, device="cpu")
    for k in ("stage0/layer0/ffn/w_gate", "stage0/layer0/ffn/w_down"):
        assert np.array_equal(params[k].numpy(), flat[k]), k
    assert params["stem"].shape == (8, 3, 3, 3)
    assert params["mu/s0b0/conv1"].shape == (8, 8, 3, 3)
    path = os.path.join(tmp_path, "port.npz")
    TIO.save_pytree(path, TIO.params_to_jax(params))
    back = TIO.load_pytree(path)
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
