"""The port's attention against the JAX package: the plain
``flash_attention`` (the CPU path, and the oracle the CUDA kernels are
held against on the card) against the Pallas kernel in interpret mode and
its gradients, through ``ops.flash_attention``'s CPU route, against
``jax.grad`` of ``ref.flash_attention_ref`` — rows with no key in their
band (T > S + window) included; the logit softcap against the
reference's dense and query-block attention, which apply it (the Pallas
kernel does not); and the layers around it — RoPE, the MLP and
``attention_apply`` — against ``repro.models.layers`` with the same
parameters. Inputs come from numpy seeds.

Tolerances: the forward 2e-5 in f32 and 3e-2 in bf16, as
tests/test_kernels.py holds the Pallas kernel against its oracle; the
gradients 1e-5 of each array's largest entry (f32 sums of products in
another order by the two frameworks: the einsums' and the softmax's
rounding, a few ulp of entries of order one); the layers 2e-5 (CPU
matmuls summed in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as REF
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models import layers as JL
from repro_torch.checkpoint.io import flatten_with_paths
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.models import layers as TL
import test_torch_threads

test_torch_threads.share_cores()

for _op in (torch.exp, torch.log, torch.sqrt):
    _op(torch.ones(1))

# tests/test_kernels.py's cases: B, T, H, KV, d, causal, window
CASES = [(2, 64, 4, 2, 32, True, 0), (1, 100, 2, 2, 16, True, 24),
         (2, 32, 4, 4, 64, False, 0), (1, 256, 8, 2, 32, True, 64),
         (1, 48, 4, 1, 16, True, 0)]


def _qkv(B, T, H, KV, d, seed=0, S=None):
    rng = np.random.default_rng(seed)
    S = T if S is None else S
    return (rng.standard_normal((B, T, H, d)).astype(np.float32),
            rng.standard_normal((B, S, KV, d)).astype(np.float32),
            rng.standard_normal((B, S, KV, d)).astype(np.float32))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("B,T,H,KV,d,causal,window", CASES)
def test_plain_matches_pallas(B, T, H, KV, d, causal, window):
    q, k, v = _qkv(B, T, H, KV, d)
    o = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, window=window, block_t=32, block_s=32,
                  interpret=True)
    p = FA.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal,
                                 window=window)
    np.testing.assert_allclose(p.numpy(), np.asarray(o), rtol=2e-5,
                               atol=2e-5)


def test_plain_bf16_matches_pallas():
    q, k, v = (jnp.asarray(a).astype(jnp.bfloat16)
               for a in _qkv(1, 64, 2, 2, 32))
    o = jax_flash(q, k, v, block_t=32, block_s=32, interpret=True)
    to_t = lambda x: torch.from_numpy(np.array(x.astype(jnp.float32))
                                      ).to(torch.bfloat16)
    p = FA.flash_attention_plain(to_t(q), to_t(k), to_t(v))
    assert p.dtype == torch.bfloat16
    np.testing.assert_allclose(p.float().numpy(),
                               np.asarray(o.astype(jnp.float32)), atol=3e-2)


@pytest.mark.parametrize("B,T,H,KV,d,causal,window",
                         CASES + [(2, 40, 4, 2, 16, False, 0)])
def test_gradients_match_jax_grad(B, T, H, KV, d, causal, window):
    """dq, dk, dv of a random linear function of the output, through the
    port's flash_attention (on the CPU, autograd of the plain version) and
    through jax.grad of the reference."""
    q, k, v = _qkv(B, T, H, KV, d, seed=1)
    for name, e in _grad_rel(q, k, v, causal, window).items():
        assert e < 1e-5, name


# T = 160 > S + window = 80: rows t >= 79 have no key in their band and
# take the mean of v over the S keys (S a multiple of the Pallas key block,
# which then pads no key into that mean)
KEYLESS = dict(B=1, T=160, S=64, H=4, KV=2, d=16, window=16)


def _grad_rel(q, k, v, causal, window):
    """max over dq, dk, dv of |port − jax.grad| / max|jax.grad|, for a
    random linear function of the output."""
    w = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    g_j = jax.grad(lambda a, b, c: jnp.sum(REF.flash_attention_ref(
        a, b, c, causal=causal, window=window) * w), argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = ops.flash_attention(*leaves, causal=causal, window=window)
    g_t = torch.autograd.grad((o * torch.from_numpy(w)).sum(), leaves)
    return {name: _rel(a.numpy(), b)
            for name, a, b in zip(("dq", "dk", "dv"), g_t, g_j)}


@pytest.mark.parametrize("causal", [True, False])
def test_rows_with_no_key_match_pallas(causal):
    c = KEYLESS
    q, k, v = _qkv(c["B"], c["T"], c["H"], c["KV"], c["d"], S=c["S"])
    o = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, window=c["window"], block_t=32, block_s=32,
                  interpret=True)
    p = FA.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal,
                                 window=c["window"])
    np.testing.assert_allclose(p.numpy(), np.asarray(o), rtol=2e-5,
                               atol=2e-5)
    # the keyless rows are the mean of v over the S keys
    G = c["H"] // c["KV"]
    mean_v = np.repeat(v.mean(axis=1), G, axis=1)  # (B, H, d)
    t0 = c["S"] + c["window"] - 1
    np.testing.assert_allclose(p.numpy()[:, t0:], np.broadcast_to(
        mean_v[:, None], p[:, t0:].shape), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_rows_with_no_key_gradients_match_jax_grad(causal):
    c = KEYLESS
    q, k, v = _qkv(c["B"], c["T"], c["H"], c["KV"], c["d"], seed=1,
                   S=c["S"])
    for name, e in _grad_rel(q, k, v, causal, c["window"]).items():
        assert e < 1e-5, name


def test_cpu_route_counts_no_launch_and_kernel_refuses_cpu():
    ops.reset_launch_counts()
    q = torch.randn(1, 8, 2, 4, requires_grad=True)
    ops.flash_attention(q, q.detach(), q.detach()).sum().backward()
    assert ops.launch_counts()["flash_attention_fwd"] == 0
    assert ops.launch_counts()["flash_attention_bwd"] == 0
    with pytest.raises(ValueError):
        FA.flash_attention_fwd_kernel(q, q, q)


# the softcap cases: B, T, H, KV, d, mask kind, window; the reference's
# two full-sequence forms, `attention_scores` with its mask and
# `_blockwise_attention` over query blocks of 16 (T = 40 pads the last)
SOFTCAP_CASES = [(2, 40, 4, 2, 16, "causal", 0), (1, 40, 4, 1, 32, "swa", 12),
                 (2, 24, 2, 2, 16, "none", 0)]


def _reference_attention(form, q, k, v, mask_kind, window, cap):
    B, T = q.shape[:2]
    S = k.shape[1]
    if form == "blockwise":
        return JL._blockwise_attention(q, k, v, mask_kind, window, cap,
                                       block_q=16)
    t, u = jnp.arange(T)[:, None], jnp.arange(S)[None, :]
    mask = jnp.ones((T, S), bool)
    if mask_kind != "none":
        mask &= u <= t
    if mask_kind == "swa":
        mask &= u > t - window
    return JL.attention_scores(q, k, v, mask[None, None, None], cap)


@pytest.mark.parametrize("cap", [50.0, 5.0])
@pytest.mark.parametrize("B,T,H,KV,d,mask_kind,window", SOFTCAP_CASES)
def test_softcap_plain_matches_the_reference_forms(B, T, H, KV, d,
                                                   mask_kind, window, cap):
    """``flash_attention_plain`` with ``softcap`` c (the CPU route and the
    card's float64 oracle) against the reference's dense
    `attention_scores` and its query-block `_blockwise_attention`, each
    capping c·tanh(s / c) before the mask: the output within 2e-5 and dq,
    dk, dv of a random linear function of it within 1e-5 of each array's
    largest entry (through ``ops.flash_attention``'s CPU route and
    ``jax.grad``). Scores scaled ×4 so that c = 5 saturates tanh."""
    q, k, v = _qkv(B, T, H, KV, d, seed=3)
    q = q * 4.0
    w = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)
    causal = mask_kind != "none"
    win = window if mask_kind == "swa" else 0
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = ops.flash_attention(*leaves, causal=causal, window=win, softcap=cap)
    g_t = torch.autograd.grad((o * torch.from_numpy(w)).sum(), leaves)
    plain = FA.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                     causal=causal, window=win, softcap=cap)
    assert torch.equal(plain, o.detach())
    for form in ("dense", "blockwise"):
        r = _reference_attention(form, *(jnp.asarray(a) for a in (q, k, v)),
                                 mask_kind, win, cap)
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r),
                                   rtol=2e-5, atol=2e-5, err_msg=form)
        g_j = jax.grad(lambda a, b, c: jnp.sum(_reference_attention(
            form, a, b, c, mask_kind, win, cap) * w), argnums=(0, 1, 2))(
                *(jnp.asarray(a) for a in (q, k, v)))
        for name, a, b in zip(("dq", "dk", "dv"), g_t, g_j):
            assert _rel(a.numpy(), b) < 1e-5, (form, name)
    uncapped = FA.flash_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal, window=win)
    assert _rel(plain.numpy(), uncapped.numpy()) > 1e-3


def test_logit_softcap_raises():
    """(The name is from when the softcap raised; it runs now.)
    ``attention_apply`` with ``logit_softcap`` c = 50 and 5 (GQA, sliding
    window) against `repro.models.layers.attention_apply` on the same
    params within 2e-5, the cap changing the output (inputs ×3, so that
    the scores reach the cap). Cross attention runs too: ``kv_src`` of
    another length (S = 6 against T = 4), every key visible, within 2e-5
    of the reference."""
    dims_kw = dict(d_model=32, num_heads=4, num_kv_heads=2, head_dim=8)
    jp = JL.init_attention(jax.random.PRNGKey(2), JL.AttnDims(**dims_kw))
    tp = {k: torch.from_numpy(np.array(v))
          for k, v in flatten_with_paths(jp).items()}
    x = 3 * np.random.default_rng(8).standard_normal((2, 20, 32)).astype(
        np.float32)
    t0 = TL.attention_apply(tp, TL.AttnDims(**dims_kw), torch.from_numpy(x),
                            mask_kind="swa", window=8)
    for cap in (50.0, 5.0):
        r = JL.attention_apply(jp, JL.AttnDims(**dims_kw), jnp.asarray(x),
                               mask_kind="swa", window=8, logit_softcap=cap)
        t = TL.attention_apply(tp, TL.AttnDims(**dims_kw),
                               torch.from_numpy(x), mask_kind="swa",
                               window=8, logit_softcap=cap)
        np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=2e-5,
                                   atol=2e-5, err_msg=str(cap))
        assert _rel(t.numpy(), t0.numpy()) > 1e-4, cap
    dims = TL.AttnDims(d_model=16, num_heads=2, num_kv_heads=2, head_dim=8)
    params = TL.init_attention(torch.Generator().manual_seed(0), dims)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 4, 16)).astype(np.float32)
    src = rng.standard_normal((1, 6, 16)).astype(np.float32)
    ref = JL.attention_apply(
        {k: jnp.asarray(v.numpy()) for k, v in params.items()},
        JL.AttnDims(d_model=16, num_heads=2, num_kv_heads=2, head_dim=8),
        jnp.asarray(x), mask_kind="none", kv_src=jnp.asarray(src),
        rope_theta=None)
    out = TL.attention_apply(params, dims, torch.from_numpy(x),
                             mask_kind="none", kv_src=torch.from_numpy(src),
                             rope_theta=None)
    assert out.shape == (1, 4, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


# ---------------------------------------------------------------------------
# the layers around the kernel
# ---------------------------------------------------------------------------

def test_apply_rope_matches_jax():
    x = np.random.default_rng(4).standard_normal((2, 9, 3, 16)).astype(
        np.float32)
    pos = np.arange(9)[None]
    r = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    t = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("act", ["silu", "gelu", "relu2"])
def test_mlp_apply_matches_jax(act):
    jp = JL.init_mlp(jax.random.PRNGKey(0), 24, 40, act)
    x = np.random.default_rng(5).standard_normal((2, 7, 24)).astype(
        np.float32)
    r = JL.mlp_apply(jp, jnp.asarray(x), act)
    tp = {k: torch.from_numpy(np.array(v))
          for k, v in flatten_with_paths(jp).items()}
    t = TL.mlp_apply(tp, torch.from_numpy(x), act)
    np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("H,KV,bias,qk_norm,mask_kind,window", [
    (4, 4, False, False, "causal", 0),     # full, MHA (zamba2's block)
    (4, 2, False, True, "swa", 8),         # sliding window, GQA, qk_norm
    (4, 1, True, False, "causal", 0),      # MQA with qkv bias
    (2, 2, True, True, "swa", 20)])        # bias and qk_norm, window = T
def test_attention_apply_matches_jax(H, KV, bias, qk_norm, mask_kind,
                                     window):
    dims_kw = dict(d_model=32, num_heads=H, num_kv_heads=KV, head_dim=8,
                   qkv_bias=bias, qk_norm=qk_norm)
    jp = JL.init_attention(jax.random.PRNGKey(1), JL.AttnDims(**dims_kw))
    if bias:  # nonzero biases, so that they count
        rng = np.random.default_rng(6)
        jp = {k: (jnp.asarray(rng.standard_normal(v.shape).astype(
            np.float32)) if k.startswith("b") else v) for k, v in jp.items()}
    x = np.random.default_rng(7).standard_normal((2, 20, 32)).astype(
        np.float32)
    r = JL.attention_apply(jp, JL.AttnDims(**dims_kw), jnp.asarray(x),
                           mask_kind=mask_kind, window=window)
    tp = {k: torch.from_numpy(np.array(v))
          for k, v in flatten_with_paths(jp).items()}
    t = TL.attention_apply(tp, TL.AttnDims(**dims_kw), torch.from_numpy(x),
                           mask_kind=mask_kind, window=window)
    np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=2e-5,
                               atol=2e-5)
