"""The port's kernels (repro_torch.kernels) against the JAX package's Pallas
kernels, run in interpret mode on the CPU as tests/test_kernels.py and
tests/test_extensions.py run them.

On the CPU every wrapper takes its plain PyTorch version, so these tests
hold the plain versions (the port's CPU path and the oracle its CUDA and
Triton kernels are compared with on the card) against the reference, and
gradcheck each backward formula in float64. The kernels themselves run
only on a card: the tests marked ``cuda`` compare them with the plain
versions there and skip elsewhere.

Tolerances: top-k values and indices exact; f32 results 1e-4 as in
tests/test_kernels.py (the plain version sums in another order than the
Pallas body); the lse 1e-6 relative; float64 gradients 1e-9.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dist_ce import dist_ce as jax_dist_ce
from repro.kernels.emb_dist import emb_dist as jax_emb_dist
from repro.kernels.topk_wire import topk_wire as jax_topk_wire
from repro_torch.kernels import ops
from repro_torch.kernels import dist_ce as DCE
from repro_torch.kernels import emb_dist as EMB
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import topk_wire as TOPK
import test_torch_threads

test_torch_threads.share_cores()

# PyTorch's CPU build picks each vectorized math kernel at its first call,
# and a first call spread over several threads was seen to compute
# exp / log / sqrt with another variant (up to 1e-4 relative, 37 ulp on a
# logsumexp). One single-element call of each, made while pytest collects
# this file, settles the choice for the whole process.
for _op in (torch.exp, torch.log, torch.sqrt):
    _op(torch.ones(1))


def _logits(B, V, seed, scale=3.0):
    return (np.random.default_rng(seed).standard_normal((B, V))
            * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# plain versions vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,V", [(8, 512), (37, 1000), (3, 130)])
def test_dist_ce_plain_matches_pallas(B, V):
    s, t = _logits(B, V, 0), _logits(B, V, 1)
    ce, tc, sc = jax_dist_ce(jnp.asarray(s), jnp.asarray(t), interpret=True,
                             block_rows=16, block_v=128)
    p_ce, p_tc, p_sc, _ = DCE.dist_ce_fwd_plain(torch.from_numpy(s),
                                                torch.from_numpy(t))
    for a, b in ((ce, p_ce), (tc, p_tc), (sc, p_sc)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-4)


def test_dist_ce_plain_bf16_matches_pallas():
    s = jnp.asarray(_logits(16, 300, 2)).astype(jnp.bfloat16)
    t = jnp.asarray(_logits(16, 300, 3)).astype(jnp.bfloat16)
    ce, tc, _ = jax_dist_ce(s, t, interpret=True, block_rows=16,
                            block_v=128)
    to_t = lambda x: torch.from_numpy(np.array(x.astype(jnp.float32))
                                      ).to(torch.bfloat16)
    p_ce, p_tc, _, _ = DCE.dist_ce_fwd_plain(to_t(s), to_t(t))
    np.testing.assert_allclose(p_ce.numpy(), np.asarray(ce), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(p_tc.numpy(), np.asarray(tc), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("B,E", [(16, 64), (37, 128), (5, 512)])
def test_emb_dist_plain_matches_pallas(B, E):
    s, t = _logits(B, E, 4, 1.0), _logits(B, E, 5, 1.0)
    o = jax_emb_dist(jnp.asarray(s), jnp.asarray(t), interpret=True,
                     block_rows=16)
    p = EMB.emb_dist_plain(torch.from_numpy(s), torch.from_numpy(t))
    np.testing.assert_allclose(p.numpy(), np.asarray(o), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("B,V,k", [(4, 130, 8), (7, 1024, 32), (2, 64, 4),
                                   (3, 40, 40)])
def test_topk_wire_plain_matches_pallas(B, V, k):
    x = _logits(B, V, 6)
    v, i, lse = jax_topk_wire(jnp.asarray(x), k, block_rows=4,
                              interpret=True)
    pv, pi, plse = TOPK.topk_wire_plain(torch.from_numpy(x), k)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(v))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(i))
    assert pi.dtype == torch.int32
    np.testing.assert_allclose(plse.numpy(), np.asarray(lse), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("row,k", [([1, 3, 3, 2, 3, 0], 4),
                                   ([5, 5, 5, 5, 5, 5, 5, 5], 5),
                                   ([0, -1, 2, 2, -1, 0, 2, 7], 8)])
def test_topk_wire_ties_go_to_lowest_column(row, k):
    """Ties resolve as in the Pallas kernel and lax.top_k (lowest column
    first) — not as torch.topk does — so wire bytes match."""
    x = np.tile(np.asarray(row, np.float32), (4, 1))
    _, i, _ = jax_topk_wire(jnp.asarray(x), k, block_rows=4, interpret=True)
    _, pi, _ = TOPK.topk_wire_plain(torch.from_numpy(x), k)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(i))
    np.testing.assert_array_equal(
        pi.numpy(), np.asarray(jax.lax.top_k(jnp.asarray(x), k)[1]))


def test_topk_wire_integer_ties_sweep():
    x = np.random.default_rng(7).integers(-3, 3, (16, 257)).astype(
        np.float32)
    v, i, lse = jax_topk_wire(jnp.asarray(x), 32, block_rows=4,
                              interpret=True)
    pv, pi, plse = ops.topk_wire(torch.from_numpy(x), 32)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(i))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(v))
    np.testing.assert_allclose(plse.numpy(), np.asarray(lse), rtol=1e-6)


# ---------------------------------------------------------------------------
# backward formulas (the TPU kernels have none)
# ---------------------------------------------------------------------------

def test_dist_ce_backward_formula_matches_autograd_f64():
    rng = np.random.default_rng(8)
    s = torch.tensor(rng.standard_normal((6, 37)) * 3, dtype=torch.float64,
                     requires_grad=True)
    t = torch.tensor(rng.standard_normal((6, 37)) * 3, dtype=torch.float64)
    g = torch.tensor(rng.standard_normal(6), dtype=torch.float64)
    ce, _, _, stats = DCE.dist_ce_fwd_plain(s, t)
    (auto,) = torch.autograd.grad((ce * g).sum(), s)
    formula = DCE.dist_ce_bwd_plain(s.detach(), t, stats.detach(), g)
    np.testing.assert_allclose(formula.numpy(), auto.numpy(), rtol=1e-9,
                               atol=1e-12)


def test_emb_dist_backward_formula_matches_autograd_f64():
    rng = np.random.default_rng(9)
    s = torch.tensor(rng.standard_normal((5, 24)), dtype=torch.float64,
                     requires_grad=True)
    t = torch.tensor(rng.standard_normal((5, 24)), dtype=torch.float64)
    g = torch.tensor(rng.standard_normal(5), dtype=torch.float64)
    (auto,) = torch.autograd.grad((EMB.emb_dist_plain(s, t) * g).sum(), s)
    formula = EMB.emb_dist_bwd_plain(s.detach(), t, g)
    np.testing.assert_allclose(formula.numpy(), auto.numpy(), rtol=1e-9,
                               atol=1e-12)


def test_emb_dist_backward_is_finite_at_zero_row():
    s = torch.zeros(2, 8, dtype=torch.float64)
    s[1] = 1.0
    t = torch.ones(2, 8, dtype=torch.float64)
    g = torch.ones(2, dtype=torch.float64)
    assert torch.isfinite(EMB.emb_dist_bwd_plain(s, t, g)).all()


@pytest.mark.parametrize("fn", [lambda s, t: ops.dist_ce(s, t)[0],
                                lambda s, t: ops.emb_dist(s, t)],
                         ids=["dist_ce", "emb_dist"])
def test_autograd_functions_gradcheck_f64(fn):
    rng = np.random.default_rng(10)
    s = torch.tensor(rng.standard_normal((4, 11)), dtype=torch.float64,
                     requires_grad=True)
    t = torch.tensor(rng.standard_normal((4, 11)), dtype=torch.float64)
    assert torch.autograd.gradcheck(lambda x: fn(x, t), (s,))


def test_teacher_gets_no_gradient():
    s = torch.randn(3, 10, requires_grad=True)
    t = torch.randn(3, 10, requires_grad=True)
    ce, tc, sc = ops.dist_ce(s, t)
    (ce.sum() + ops.emb_dist(s, t).sum()).backward()
    assert t.grad is None and s.grad is not None
    assert not tc.requires_grad and not sc.requires_grad


def test_cpu_tensor_takes_plain_version_and_counts_nothing():
    ops.reset_launch_counts()
    x = torch.randn(5, 50)
    ops.topk_wire(x, 5)
    ops.dist_ce(x, x)
    ops.emb_dist(x, x)
    assert set(ops.launch_counts().values()) == {0}
    assert [i["name"] for i, _ in ops.KERNELS] == [
        "topk_wire", "dist_ce_fwd", "dist_ce_bwd", "emb_dist_fwd",
        "emb_dist_bwd", "ssd_scan_fwd", "ssd_scan_bwd", "flash_attention_fwd",
        "flash_attention_bwd"]


def test_kernel_entry_points_refuse_cpu_tensors():
    x = torch.randn(4, 16)
    with pytest.raises(ValueError):
        TOPK.topk_wire_kernel(x, 4)
    with pytest.raises(ValueError):
        DCE.dist_ce_fwd_kernel(x, x)
    with pytest.raises(ValueError):
        EMB.emb_dist_fwd_kernel(x, x)


# ---------------------------------------------------------------------------
# the kernels themselves: on a card only
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_topk_wire_kernel_matches_plain(cuda):
    x = torch.from_numpy(_logits(640, 1000, 11)).to(cuda)
    v, i, lse = TOPK.topk_wire_kernel(x, 32)
    pv, pi, plse = TOPK.topk_wire_plain(x, 32)
    assert torch.equal(v, pv) and torch.equal(i, pi)
    torch.testing.assert_close(lse, plse, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_triton_kernels_match_plain(cuda):
    s = torch.from_numpy(_logits(64, 1000, 12)).to(cuda)
    t = torch.from_numpy(_logits(64, 1000, 13)).to(cuda)
    out, ref_out = DCE.dist_ce_fwd_kernel(s, t), DCE.dist_ce_fwd_plain(s, t)
    for a, b in zip(out[:3], ref_out[:3]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    e_s, e_t = s[:32, :512].contiguous(), t[:32, :512].contiguous()
    torch.testing.assert_close(EMB.emb_dist_fwd_kernel(e_s, e_t),
                               EMB.emb_dist_plain(e_s, e_t), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,S,H,KV,d,causal,window", [
    (2, 200, 200, 8, 8, 112, True, 0), (1, 300, 300, 8, 4, 256, True, 64),
    (2, 70, 50, 4, 2, 64, False, 0), (1, 300, 100, 8, 4, 64, False, 64),
    (1, 260, 100, 4, 2, 128, True, 32), (1, 1024, 1024, 16, 4, 128, True, 0),
    (2, 513, 513, 8, 8, 112, True, 0)])
def test_flash_attention_kernels_match_plain(cuda, B, T, S, H, KV, d, causal,
                                             window):
    """The forward and the three gradients against the plain version in
    float64, as max|d| / max|plain| (f32 sums in another order); the fourth
    and fifth cases have rows with no key in their band (T > S + window).
    The backward adds dQ into one f32 buffer from every key tile's block,
    for each of the G query heads of its kv head: the last two cases take
    16 key tiles with G = 4, and a ragged last tile at T = 513, d = 112."""
    g = torch.Generator(device=cuda).manual_seed(14)
    q = torch.randn(B, T, H, d, generator=g, device=cuda)
    k, v = (torch.randn(B, S, KV, d, generator=g, device=cuda)
            for _ in range(2))
    do = torch.randn(B, T, H, d, generator=g, device=cuda)
    o, lse = FA.flash_attention_fwd_kernel(q, k, v, causal=causal,
                                           window=window)
    grads = FA.flash_attention_bwd_kernel(q, k, v, o, lse, do,
                                          causal=causal, window=window)
    leaves = [x.double().requires_grad_() for x in (q, k, v)]
    o2 = FA.flash_attention_plain(*leaves, causal=causal, window=window)
    grads2 = torch.autograd.grad(o2, leaves, do.double())
    for a, b in zip((o, *grads), (o2, *grads2)):
        b = b.detach()
        assert float((a.double() - b).abs().max() / b.abs().max()) < 1e-4


@pytest.mark.cuda
def test_flash_attention_backward_repeats(cuda):
    """dK and dV are summed by one block each in a fixed order, so two runs
    on one input agree bitwise; dQ is summed by f32 atomics in the order
    the blocks run, so it may differ in its last bits, within 1e-4 of its
    largest entry."""
    g = torch.Generator(device=cuda).manual_seed(15)
    q, k, v, do = (torch.randn(1, 1024, 16, 128, generator=g, device=cuda)
                   for _ in range(4))
    k, v = k[:, :, :4].contiguous(), v[:, :, :4].contiguous()
    o, lse = FA.flash_attention_fwd_kernel(q, k, v, causal=True)
    dq1, dk1, dv1 = FA.flash_attention_bwd_kernel(q, k, v, o, lse, do,
                                                  causal=True, window=0)
    dq2, dk2, dv2 = FA.flash_attention_bwd_kernel(q, k, v, o, lse, do,
                                                  causal=True, window=0)
    assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)
    assert float((dq1 - dq2).abs().max() / dq1.abs().max()) <= 1e-4
