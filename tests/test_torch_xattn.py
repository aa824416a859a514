"""The port's cross attention, modality front ends and positions against
the JAX package, fed the same seeded numpy inputs and the same params
(the port's draw, carried into the reference's tree by the path-keyed
npz layout).

Covers `repro_torch.models.layers.attention_apply` with ``kv_src`` (T ≠
S, MHA and GQA, ``mask_kind="none"``, with and without RoPE at
``kv_positions``) and its gradients; `_sinusoidal`; reduced
whisper-large-v3 (the audio front end, the ``encoder/`` subtree, learned
positions, the decoder's ``xattn`` sublayer) and reduced
llama-3.2-vision-90b (``vision_proj`` and the gated ``attn="cross"``
layers) as whole models: ``apply_lm``'s hidden states, logits and aux
heads, ``lm_loss`` and every gradient; remat equal to no remat; the npz
round trip of the new leaves. Every ``cross_gate`` is set to 0.5 in the
shared params: at its initial 0 the cross path is multiplied away.

Tolerances: outputs, losses and gradients 2e-4 relative / 2e-5 absolute
(float32 CPU matmuls summed in another order by the two frameworks), as
tests/test_torch_lm.py and tests/test_torch_hybrid.py hold theirs; the
sinusoidal table at whisper's 1,500 frames within the float32 spacing of
its largest angle (1,499 rad: 1.2e-4), where both packages round the
angle itself; checkpointed units give the gradients of unchecked ones to
float32 rounding.
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
from repro.models import layers as JL
from repro.models import transformer as JTF
from repro_torch.checkpoint import io as TIO
from repro_torch.configs import get_reduced
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TTF
import test_torch_threads

test_torch_threads.share_cores()

for _op in (torch.exp, torch.log, torch.sqrt, torch.tanh):
    _op(torch.ones(1))

RTOL, ATOL = 2e-4, 2e-5
NAMES = ["whisper-large-v3", "llama-3.2-vision-90b"]
GATE = 0.5


def nested(flat: dict) -> dict:
    """A path-keyed dict → the reference's nested tree."""
    out: dict = {}
    for k, v in flat.items():
        *parents, leaf = k.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def shared_params(cfg, seed: int = 0) -> dict:
    """The port's draw of ``cfg`` on the CPU with every ``cross_gate`` at
    GATE."""
    params = TTF.init_lm(torch.Generator().manual_seed(seed), cfg,
                         device="cpu")
    for k in params:
        if k.endswith("cross_gate"):
            params[k] = torch.full_like(params[k], GATE)
    return params


def to_jax(params: dict) -> dict:
    return nested({k: jnp.asarray(v)
                   for k, v in TIO.params_to_jax(params).items()})


def modality_batch(cfg, rng: np.random.Generator, B: int = 2,
                   T: int = 24) -> dict:
    """numpy tokens and, as the config asks, patch embeddings or T
    encoder frames under the decoder's ``decoder_len`` tokens."""
    if cfg.audio is not None:
        return {"tokens": rng.integers(0, cfg.vocab_size, (
                    B, cfg.audio.decoder_len)).astype(np.int32),
                "audio_frames": rng.standard_normal(
                    (B, T, cfg.audio.frame_dim)).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, T)).astype(
                np.int32),
            "vision_embeds": rng.standard_normal(
                (B, cfg.vision.num_patches, cfg.vision.embed_dim)).astype(
                np.float32)}


def close(a, b, what: str = "") -> None:
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=RTOL,
                               atol=ATOL, err_msg=what)


# ---------------------------------------------------------------------------
# attention with kv_src
# ---------------------------------------------------------------------------

# (name, D, D_src, H, KV, hd, T, S, rope)
XATTN_CASES = [("MHA", 64, 64, 4, 4, 16, 9, 23, False),
               ("GQA", 64, 48, 8, 2, 16, 17, 6, False),
               ("GQA rope", 64, 64, 4, 2, 16, 12, 20, True)]


@pytest.mark.parametrize("case", XATTN_CASES,
                         ids=[c[0] for c in XATTN_CASES])
def test_cross_attention_matches_jax(case):
    """Cross attention with K and V from ``kv_src`` (B, S, D_src), every
    key visible: the output and the gradients of every param, of x and of
    kv_src under a random cotangent. With RoPE, q rotates at
    ``positions`` and k at ``kv_positions``."""
    _, D, Ds, H, KV, hd, T, S, rope = case
    rng = np.random.default_rng(len(case[0]))
    dims = TL.AttnDims(d_model=D, num_heads=H, num_kv_heads=KV, head_dim=hd,
                       kv_input_dim=Ds)
    jdims = JL.AttnDims(d_model=D, num_heads=H, num_kv_heads=KV,
                        head_dim=hd, kv_input_dim=Ds)
    params = TL.init_attention(torch.Generator().manual_seed(3), dims)
    assert params["wk"].shape == (Ds, KV * hd)
    x = rng.standard_normal((2, T, D)).astype(np.float32)
    src = rng.standard_normal((2, S, Ds)).astype(np.float32)
    ct = rng.standard_normal((2, T, D)).astype(np.float32)
    kw = dict(mask_kind="none", rope_theta=1e4 if rope else None)
    if rope:
        kw["positions"] = np.arange(3, 3 + T)[None]
        kw["kv_positions"] = np.arange(S)[None] * 2

    def jfn(p, x_, s_):
        jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        out = JL.attention_apply(p, jdims, x_, kv_src=s_, **jkw)
        return jnp.sum(out * ct), out

    jp = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    (_, out_j), g_j = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1, 2),
                                                 has_aux=True))(
        jp, jnp.asarray(x), jnp.asarray(src))
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_()
    st = torch.from_numpy(src).requires_grad_()
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    out = TL.attention_apply(leaves, dims, xt, kv_src=st, **tkw)
    close(out.detach().numpy(), out_j, "out")
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(),
                                [*leaves.values(), xt, st])
    for k, g in zip(leaves, grads):
        close(g.numpy(), g_j[0][k], k)
    close(grads[-2].numpy(), g_j[1], "x")
    close(grads[-1].numpy(), g_j[2], "kv_src")


def test_logit_softcap_still_raises_with_kv_src():
    """(The name is from when the softcap raised; it runs now.)
    ``logit_softcap`` with ``kv_src`` (S = 6 against T = 4, every key
    visible) against `repro.models.layers.attention_apply` on the same
    params within 2e-5."""
    dims = TL.AttnDims(d_model=16, num_heads=2, num_kv_heads=2, head_dim=8)
    params = TL.init_attention(torch.Generator().manual_seed(0), dims)
    rng = np.random.default_rng(6)
    x = 3 * rng.standard_normal((1, 4, 16)).astype(np.float32)
    src = 3 * rng.standard_normal((1, 6, 16)).astype(np.float32)
    ref = JL.attention_apply(
        {k: jnp.asarray(v.numpy()) for k, v in params.items()},
        JL.AttnDims(d_model=16, num_heads=2, num_kv_heads=2, head_dim=8),
        jnp.asarray(x), mask_kind="none", kv_src=jnp.asarray(src),
        logit_softcap=30.0)
    out = TL.attention_apply(params, dims, torch.from_numpy(x),
                             kv_src=torch.from_numpy(src), mask_kind="none",
                             logit_softcap=30.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("T,D,tol", [(64, 128, ATOL), (448, 1280, ATOL),
                                     (1500, 1280, float(np.spacing(
                                         np.float32(1499.0))))])
def test_sinusoidal_matches_jax(T, D, tol):
    """The encoder's sin / cos table at the reduced encoder's size, at
    whisper's 448 decoder positions and at its 1,500 frames."""
    ref = np.asarray(JTF._sinusoidal(T, D))
    port = TTF._sinusoidal(T, D).numpy()
    assert port.shape == ref.shape == (T, D)
    assert np.abs(port - ref).max() <= tol


# ---------------------------------------------------------------------------
# reduced whisper-large-v3 and llama-3.2-vision-90b
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=NAMES)
def model(request):
    """One reference build per config: the config pair, the shared params
    (gates at 0.5), a batch, and the reference's outputs, loss, metrics
    and gradients under ``jax.jit``."""
    name = request.param
    cfg, jcfg = get_reduced(name), jax_reduced(name)
    params = shared_params(cfg)
    jp = to_jax(params)
    batch = modality_batch(cfg, np.random.default_rng(0))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    out_j = jax.jit(lambda p, b: JTF.apply_lm(p, jcfg, b))(jp, jbatch)
    (loss_j, m_j), g_j = jax.jit(jax.value_and_grad(
        lambda p, b: JTF.lm_loss(p, jcfg, b), has_aux=True))(jp, jbatch)
    return dict(name=name, cfg=cfg, jcfg=jcfg, params=params, jp=jp,
                batch=batch, out_j=out_j, loss_j=float(loss_j),
                metrics_j={k: float(v) for k, v in m_j.items()},
                grads_j={k: np.asarray(v) for k, v in
                         JIO.flatten_with_paths(g_j).items()})


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _loss_and_grads(params: dict, cfg, batch: dict):
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss, metrics = TTF.lm_loss(leaves, cfg, _torch_batch(batch))
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True, materialize_grads=True)
    return loss, metrics, dict(zip(leaves, grads))


def test_params_keys_and_shapes_match_jax(model):
    """The port's tree is the reference's: the front ends, the encoder,
    the cross leaves and the positions included."""
    flat = JIO.flatten_with_paths(jax.eval_shape(
        lambda k: JTF.init_lm(k, model["jcfg"]), jax.random.PRNGKey(0)))
    params = model["params"]
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: tuple(v.shape) for k, v in flat.items()}
    if model["name"] == "whisper-large-v3":
        assert {"audio_proj", "pos_embed", "encoder/final_norm/scale",
                "encoder/stage0/layer0/attn/wq",
                "stage0/layer0/xattn/wk"} <= set(params)
        assert params["encoder/stage0/layer0/attn/wq"].shape[0] == 2
    else:
        assert {"vision_proj", "stage0/layer0/cross_gate",
                "stage0/layer0/attn/wk"} <= set(params)
        assert params["stage0/layer0/cross_gate"].shape == (2,)
        assert "pos_embed" not in params


def test_apply_lm_matches_jax(model):
    cfg, out_j = model["cfg"], model["out_j"]
    with torch.no_grad():
        out = TTF.apply_lm(model["params"], cfg, _torch_batch(model["batch"]))
    for key in ("hidden", "logits", "aux_heads"):
        assert out[key].shape == out_j[key].shape, key
        close(out[key].numpy(), out_j[key], key)


def test_lm_loss_and_every_gradient_match_jax(model):
    """lm_loss, its metrics and the gradient of every leaf, the encoder's,
    the front ends', the positions', the gates' and the cross leaves'
    among them; each of those gradients is nonzero."""
    loss, metrics, grads = _loss_and_grads(model["params"], model["cfg"],
                                           model["batch"])
    close(loss.item(), model["loss_j"], "loss")
    assert set(metrics) == set(model["metrics_j"])
    for k, v in model["metrics_j"].items():
        close(float(metrics[k].detach()), v, k)
    g_j = model["grads_j"]
    assert set(grads) == set(g_j)
    for k, g in grads.items():
        close(g.numpy(), g_j[k], k)
    live = ("encoder/", "audio_proj", "pos_embed", "xattn/") \
        if model["name"] == "whisper-large-v3" else \
        ("vision_proj", "cross_gate", "stage0/layer0/attn/wk")
    for prefix in live:
        keys = [k for k in grads if prefix in k]
        assert keys, prefix
        for k in keys:
            assert float(grads[k].abs().max()) > 0, k


def test_remat_changes_nothing(model):
    """Unit remat, the encoder's units included, gives the same loss and
    gradients as none."""
    cfg = model["cfg"]
    base = _loss_and_grads(model["params"], cfg, model["batch"])
    ckpt = _loss_and_grads(model["params"], dataclasses.replace(
        cfg, remat="unit"), model["batch"])
    torch.testing.assert_close(ckpt[0], base[0], rtol=1e-6, atol=1e-7)
    for k, g in base[2].items():
        torch.testing.assert_close(ckpt[2][k], g, rtol=1e-6, atol=1e-7)


def test_params_npz_round_trip(model, tmp_path):
    """The reference's tree saved by the JAX package loads into the port
    under the same keys and shapes (the 0-d gates stacked to (repeats,),
    the encoder's stacked units), saves back to an identical npz, and
    loads into the reference's structure."""
    jp = model["jp"]
    a = os.path.join(tmp_path, "jax.npz")
    b = os.path.join(tmp_path, "port.npz")
    JIO.save_pytree(a, jp)
    params = TIO.params_from_jax(TIO.load_pytree(a), device="cpu")
    for k, v in model["params"].items():
        assert torch.equal(params[k], v), k
    TIO.save_pytree(b, TIO.params_to_jax(params))
    back = TIO.load_pytree(b)
    flat = {k: np.asarray(v) for k, v in
            JIO.flatten_with_paths(jp).items()}
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
    again = JIO.load_pytree(b, jp)
    for x, y in zip(jax.tree_util.tree_leaves(again),
                    jax.tree_util.tree_leaves(jp)):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def test_vision_embeddings_reach_the_logits(model):
    """With the gates open, other patch embeddings (or other audio frames)
    give other logits; with every gate at 0 a vision model's logits do
    not depend on the image at all."""
    cfg, batch = model["cfg"], dict(model["batch"])
    key = "audio_frames" if cfg.audio is not None else "vision_embeds"
    other = dict(batch, **{key: batch[key][::-1].copy()})
    with torch.no_grad():
        a = TTF.apply_lm(model["params"], cfg, _torch_batch(batch))["logits"]
        b = TTF.apply_lm(model["params"], cfg, _torch_batch(other))["logits"]
    assert float((a - b).abs().max()) > 1e-3
    if cfg.vision is not None:
        shut = {k: torch.zeros_like(v) if k.endswith("cross_gate") else v
                for k, v in model["params"].items()}
        with torch.no_grad():
            a = TTF.apply_lm(shut, cfg, _torch_batch(batch))["logits"]
            b = TTF.apply_lm(shut, cfg, _torch_batch(other))["logits"]
        assert torch.equal(a, b)
