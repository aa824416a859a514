"""The port's LM skeleton with attention against the JAX package, on two
reduced configurations with the JAX parameters carried across through the
path-keyed npz format:

  * zamba2-7b reduced: 12 layers in two periods of the 5:1 pattern (five
    Mamba2 layers, then one with the *shared* attention block and the
    dense SwiGLU FFN), d_model 128, 4 heads × 32, d_state 16, chunk 32,
    vocab 512, 2 aux heads — the shared block's one parameter set is used
    twice, so its gradient sums two uses;
  * gemma3-12b reduced: 6 layers of the 5:1 sliding-window : full
    pattern (window 32 at T = 64), GQA 4 : 2, qk_norm, scale_embeddings.

Tolerances: hidden states, logits and the loss 2e-5 (float32 CPU matmuls
summed in another order by the two frameworks); gradients 1e-4 of the
largest entry of each leaf, as tests/test_torch_lm.py; checkpointed units
give the gradients of the unchecked ones to float32 rounding.
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
from repro.models import transformer as JTF
from repro_torch.checkpoint import io as TIO
from repro_torch.configs import get_reduced
from repro_torch.models import transformer as TTF
import test_torch_threads

test_torch_threads.share_cores()

for _op in (torch.exp, torch.log, torch.sqrt):
    _op(torch.ones(1))

NAMES = ["zamba2-7b", "gemma3-12b"]


@pytest.fixture(scope="module", params=NAMES)
def model(request):
    name = request.param
    jcfg = jax_reduced(name)
    jp = JTF.init_lm(jax.random.PRNGKey(0), jcfg)
    flat = {k: np.asarray(v) for k, v in JIO.flatten_with_paths(jp).items()}
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 64))
    return name, jcfg, jp, flat, tokens.astype(np.int32)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_init_lm_keys_and_shapes_match_jax(model):
    name, _, _, flat, _ = model
    port = TTF.init_lm(torch.Generator().manual_seed(0), get_reduced(name),
                       device="cpu")
    assert {k: tuple(v.shape) for k, v in port.items()} == \
        {k: v.shape for k, v in flat.items()}


def test_apply_lm_and_lm_loss_match_jax(model):
    name, jcfg, jp, flat, tokens = model
    out_j = JTF.apply_lm(jp, jcfg, {"tokens": jnp.asarray(tokens)})
    loss_j, _ = JTF.lm_loss(jp, jcfg, {"tokens": jnp.asarray(tokens)})
    params = TIO.params_from_jax(flat, device="cpu")
    batch = {"tokens": torch.from_numpy(tokens)}
    out = TTF.apply_lm(params, get_reduced(name), batch)
    for key in ("hidden", "logits", "aux_heads"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(out_j[key]),
                                   rtol=2e-5, atol=2e-5, err_msg=key)
    loss, _ = TTF.lm_loss(params, get_reduced(name), batch)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=2e-5)


def test_lm_loss_gradients_match_jax_and_remat_changes_nothing(model):
    name, jcfg, jp, flat, tokens = model
    g_j = JIO.flatten_with_paths(jax.grad(
        lambda p: JTF.lm_loss(p, jcfg, {"tokens": jnp.asarray(tokens)})[0])(
            jp))
    batch = {"tokens": torch.from_numpy(tokens)}
    grads = {}
    for remat in ("none", "unit"):
        cfg = dataclasses.replace(get_reduced(name), remat=remat)
        params = {k: v.requires_grad_() for k, v in
                  TIO.params_from_jax(flat, device="cpu").items()}
        loss, _ = TTF.lm_loss(params, cfg, batch)
        grads[remat] = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()), allow_unused=True,
            materialize_grads=True)))
    assert set(grads["none"]) == set(g_j)
    for k, g in grads["none"].items():
        assert _rel(g.numpy(), g_j[k]) < 1e-4, k
        torch.testing.assert_close(grads["unit"][k], g, rtol=1e-6,
                                   atol=1e-7)
    if name == "zamba2-7b":  # the shared block is used by both periods
        assert "shared_attn/wq" in g_j and "shared_attn_norm/scale" in g_j
        assert np.abs(g_j["shared_attn/wq"]).max() > 0


def test_params_npz_round_trip(model, tmp_path):
    """The JAX tree saved by the JAX package loads into the port under the
    same keys and shapes, saves back to an identical npz, and loads into
    the JAX structure."""
    name, jcfg, jp, flat, _ = model
    a = os.path.join(tmp_path, "jax.npz")
    b = os.path.join(tmp_path, "port.npz")
    JIO.save_pytree(a, jp)
    params = TIO.params_from_jax(TIO.load_pytree(a), device="cpu")
    for k, v in flat.items():
        assert tuple(params[k].shape) == v.shape, k
    if name == "zamba2-7b":
        assert params["shared_attn/wq"].shape == (128, 128)
        assert params["shared_attn_norm/scale"].shape == (128,)
        assert params["stage0/layer5/ffn/w_gate"].shape == (2, 128, 256)
    TIO.save_pytree(b, TIO.params_to_jax(params))
    back = TIO.load_pytree(b)
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
    again = JIO.load_pytree(b, jp)
    for x, y in zip(jax.tree_util.tree_leaves(again),
                    jax.tree_util.tree_leaves(jp)):
        assert np.array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("field,value", [("attn_logit_softcap", 50.0)])
def test_unported_config_options_raise(field, value):
    """softcap raises naming its ROADMAP item."""
    cfg = dataclasses.replace(get_reduced("gemma3-12b"), **{field: value})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TTF.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")


@pytest.mark.parametrize("field,value", [("mtp", True),
                                         ("pos_embed", "learned")])
def test_config_options_ported_since_match_jax(field, value):
    """DeepSeek MTP and learned positions, ported since, build and run on
    reduced gemma3-12b (the MTP block's one full-attention layer on the
    flash_attention path, the tied head; a (max_seq_len, d_model)
    ``pos_embed`` added to the embeddings): lm_loss and its metrics
    against the reference's from the same params."""
    cfg = dataclasses.replace(get_reduced("gemma3-12b"), **{field: value})
    jcfg = dataclasses.replace(jax_reduced("gemma3-12b"), **{field: value})
    params = TTF.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert ("pos_embed" in params) == (field == "pos_embed")
    jp = jax.jit(lambda k: JTF.init_lm(k, jcfg))(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in JIO.flatten_with_paths(jp).items()}
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: v.shape for k, v in flat.items()}
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    loss_j, m_j = jax.jit(lambda p, b: JTF.lm_loss(p, jcfg, b))(
        jp, {"tokens": jnp.asarray(tokens)})
    loss, m = TTF.lm_loss(TIO.params_from_jax(flat, device="cpu"), cfg,
                          {"tokens": torch.from_numpy(tokens)})
    assert set(m) == set(m_j) == {"ce", "aux_loss"} | (
        {"mtp_ce"} if field == "mtp" else set())
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=2e-5)
    if field != "mtp":
        return
    np.testing.assert_allclose(m["mtp_ce"].item(), float(m_j["mtp_ce"]),
                               rtol=2e-5)
