"""The port's ResNet (repro_torch.models.resnet) against the JAX package's,
with the reference's init params carried across by
`repro_torch.checkpoint.io.params_from_jax`: forward outputs and the
gradients of a mean-reduced loss with respect to the images and to every
parameter.

Tolerance 1e-5 relative / 1e-5 absolute (float32 on the CPU; the two
frameworks' convolutions and GroupNorm reduce in different orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import save_pytree as jax_save_pytree
from repro.common.pytree import flatten_with_paths
from repro.models import resnet as JR
from repro_torch.checkpoint import io as TIO
from repro_torch.models import resnet as TR
import test_torch_threads

test_torch_threads.share_cores()

TOL = dict(rtol=1e-5, atol=1e-5)


def _cases():
    tiny = JR.resnet_tiny(10, num_aux_heads=2)
    return [
        ("resnet_tiny", tiny, TR.resnet_tiny(10, num_aux_heads=2), 8),
        ("resnet_tiny34", JR.resnet_tiny34(10, num_aux_heads=2),
         TR.resnet_tiny34(10, num_aux_heads=2), 8),
        ("stem_stride2", dataclasses.replace(tiny, stem_stride=2),
         dataclasses.replace(TR.resnet_tiny(10, num_aux_heads=2),
                             stem_stride=2), 16),
        ("odd_size", tiny, TR.resnet_tiny(10, num_aux_heads=2), 7),
    ]


def _jax_params(jcfg, seed=0):
    p = JR.init_resnet(jax.random.PRNGKey(seed), jcfg)
    # non-trivial GroupNorm affines, so their layouts are exercised too
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x + jnp.asarray(
            rng.normal(size=x.shape).astype(np.float32) * 0.1)
        if x.ndim == 1 else x, p)


def _cotangents(out, seed):
    """Random weights of a mean-reduced scalar loss over every output (the
    scale of a training loss's gradient)."""
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=v.shape) / np.prod(v.shape)).astype(
        np.float32) for k, v in out.items() if v is not None}


@pytest.mark.parametrize("name,jcfg,tcfg,size", _cases(),
                         ids=[c[0] for c in _cases()])
def test_forward_and_gradients_match_reference(name, jcfg, tcfg, size):
    jp = _jax_params(jcfg)
    images = np.random.default_rng(1).normal(
        size=(3, size, size, 3)).astype(np.float32)

    def jloss(params, x, ct):
        o = JR.apply_resnet(params, jcfg, x)
        return sum(jnp.sum(o[k] * ct[k]) for k in ct), o

    ct = _cotangents(jax.eval_shape(
        lambda p, x: JR.apply_resnet(p, jcfg, x), jp, images), 2)
    (g_p, g_x), jout = jax.jit(jax.grad(jloss, argnums=(0, 1),
                                        has_aux=True))(jp, images, ct)

    tp = {k: v.requires_grad_() for k, v in TIO.params_from_jax(
        {k: np.asarray(v) for k, v in flatten_with_paths(jp).items()},
        device="cpu").items()}
    x = torch.from_numpy(images).requires_grad_()
    tout = TR.apply_resnet(tp, tcfg, x)
    for k in ("embedding", "logits", "aux_logits"):
        np.testing.assert_allclose(tout[k].detach().numpy(),
                                   np.asarray(jout[k]), **TOL, err_msg=k)
    loss = sum((tout[k] * torch.from_numpy(ct[k])).sum() for k in ct)
    grads = torch.autograd.grad(loss, [x, *tp.values()])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(g_x), **TOL)
    back = TIO.params_to_jax(dict(zip(tp, grads[1:])))
    ref = {k: np.asarray(v) for k, v in flatten_with_paths(g_p).items()}
    assert back.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(back[k], ref[k], **TOL, err_msg=k)


def test_same_padding_matches_xla():
    """Stride-2 3×3 SAME pads 0 before and 1 after on an even size; 1 and
    1 on an odd size (the padding=1 trap)."""
    assert TR._same_pads(8, 3, 2) == (0, 1)
    assert TR._same_pads(7, 3, 2) == (1, 1)
    assert TR._same_pads(8, 3, 1) == (1, 1)
    assert TR._same_pads(8, 1, 2) == (0, 0)


def test_jax_checkpoint_loads_and_saves_back_identically(tmp_path):
    """A param tree saved by the JAX package loads into the port (conv
    kernels HWIO → OIHW) and saves back to the same npz contents."""
    jp = JR.init_resnet(jax.random.PRNGKey(3), JR.resnet_tiny(
        6, num_aux_heads=1))
    jax_save_pytree(str(tmp_path / "jax.npz"), jp)
    loaded = TIO.load_pytree(str(tmp_path / "jax.npz"))
    tp = TIO.params_from_jax(loaded, device="cpu")
    assert tp["stem"].shape == (8, 3, 3, 3)  # OIHW
    TIO.save_pytree(str(tmp_path / "port.npz"), TIO.params_to_jax(tp))
    again = TIO.load_pytree(str(tmp_path / "port.npz"))
    assert again.keys() == loaded.keys()
    for k in loaded:
        assert again[k].dtype == loaded[k].dtype
        np.testing.assert_array_equal(again[k], loaded[k])
    nested = {"params": tp, "opt": {"momentum": tp}}
    assert set(TIO.flatten_with_paths(nested)) == {
        f"{a}/{k}" for a in ("params", "opt/momentum") for k in tp}


def test_port_init_has_the_reference_tree():
    """Same keys and shapes as the JAX init (conv kernels transposed), and
    the draw is a pure function of the generator's seed."""
    jcfg, tcfg = JR.resnet_tiny(5, num_aux_heads=2), TR.resnet_tiny(
        5, num_aux_heads=2)
    ref = {k: np.shape(v) for k, v in flatten_with_paths(
        JR.init_resnet(jax.random.PRNGKey(0), jcfg)).items()}
    a = TR.init_resnet(torch.Generator().manual_seed(1), tcfg, device="cpu")
    b = TR.init_resnet(torch.Generator().manual_seed(1), tcfg, device="cpu")
    assert list(a) == sorted(ref)
    for k, v in TIO.params_to_jax(a).items():
        assert v.shape == ref[k], k
        np.testing.assert_array_equal(v, b[k].numpy() if v.ndim != 4
                                      else TIO.params_to_jax(b)[k])
