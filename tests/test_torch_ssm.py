"""The port's SSD scan and Mamba2 block against the JAX package.

`ssd_scan_plain` (the CPU path, and the oracle the CUDA kernels are held
against on the card) is compared with the Pallas ``ssd_scan`` in interpret
mode at tests/test_kernels.py's shapes, with ``ssd_reference`` and
``ssd_chunked``, and its gradients with ``jax.grad`` of ``ssd_chunked``.
`mamba2_apply` is compared forward and in every parameter gradient, with
the JAX parameters carried across, at T = 64 (chunked) and T = 50 (the
sequential recurrence). Inputs come from numpy seeds.

Tolerances: the scans 3e-4 as tests/test_kernels.py holds the Pallas
kernel against its oracle (float32 sums of products in another order);
gradients 1e-5 of the largest entry (max|d| / max|ref|); the Mamba2 block
2e-5 forward and 1e-4 of the largest gradient entry (the two frameworks'
CPU matmuls also sum in another order). The CUDA kernels themselves run
only on a card (the ``cuda``-marked test; chip_smoke.py holds them at the
LM path's shapes).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as REF
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.models import ssm as JSSM
from repro_torch.checkpoint.io import flatten_with_paths, params_from_jax
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.models import ssm as TSSM
import test_torch_threads

test_torch_threads.share_cores()

for _op in (torch.exp, torch.log, torch.sqrt):
    _op(torch.ones(1))


def _inputs(Bt, T, H, P, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bt, T, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bt, T, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H))).astype(np.float32)
    B = rng.standard_normal((Bt, T, N)).astype(np.float32)
    C = rng.standard_normal((Bt, T, N)).astype(np.float32)
    D = rng.standard_normal(H).astype(np.float32)
    return x, dt, A, B, C, D


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("Bt,T,H,P,N,chunk", [
    (2, 64, 4, 16, 8, 16),
    (1, 128, 2, 32, 16, 32),
    (2, 32, 3, 8, 4, 8),
    (1, 64, 1, 64, 32, 64),
])
def test_ssd_plain_matches_pallas(Bt, T, H, P, N, chunk):
    ins = _inputs(Bt, T, H, P, N)
    y, st = jax_ssd_scan(*map(jnp.asarray, ins), chunk=chunk, interpret=True)
    py, pst = SSD.ssd_scan_plain(*map(torch.from_numpy, ins), chunk)
    np.testing.assert_allclose(py.numpy(), np.asarray(y), rtol=3e-4,
                               atol=3e-4)
    np.testing.assert_allclose(pst.numpy(), np.asarray(st), rtol=3e-4,
                               atol=3e-4)


@pytest.mark.parametrize("T,chunk", [(64, 16), (50, 16), (1, 16)])
def test_ssd_plain_matches_reference_and_chunked(T, chunk):
    """T a multiple of the chunk takes the chunked math, any other T the
    sequential recurrence, as mamba2_apply chooses; both equal the
    reference's sequential oracle."""
    ins = _inputs(2, T, 3, 8, 4, seed=1)
    y_r, st_r = REF.ssd_scan_ref(*map(jnp.asarray, ins))
    py, pst = SSD.ssd_scan_plain(*map(torch.from_numpy, ins), chunk)
    np.testing.assert_allclose(py.numpy(), np.asarray(y_r), rtol=3e-4,
                               atol=3e-4)
    np.testing.assert_allclose(pst.numpy(), np.asarray(st_r), rtol=3e-4,
                               atol=3e-4)
    if T % chunk == 0:
        y_c, st_c = JSSM.ssd_chunked(*map(jnp.asarray, ins),
                                     chunk_size=chunk)
        np.testing.assert_allclose(py.numpy(), np.asarray(y_c), rtol=3e-4,
                                   atol=3e-4)


def test_ssd_plain_gradients_match_jax():
    """All six gradients of a random linear function of y and the final
    state, against jax.grad of ssd_chunked."""
    Bt, T, H, P, N, chunk = 2, 64, 3, 16, 8, 16
    ins = _inputs(Bt, T, H, P, N, seed=2)
    rng = np.random.default_rng(3)
    gy = rng.standard_normal((Bt, T, H, P)).astype(np.float32)
    gf = rng.standard_normal((Bt, H, P, N)).astype(np.float32)

    def f(*a):
        y, st = JSSM.ssd_chunked(*a, chunk_size=chunk)
        return jnp.sum(y * gy) + jnp.sum(st * gf)

    g_jax = jax.grad(f, argnums=tuple(range(6)))(*map(jnp.asarray, ins))
    leaves = [torch.from_numpy(a).requires_grad_() for a in ins]
    y, st = SSD.ssd_scan_plain(*leaves, chunk)
    g_t = torch.autograd.grad((y * torch.from_numpy(gy)).sum()
                              + (st * torch.from_numpy(gf)).sum(), leaves)
    for name, a, b in zip(("x", "dt", "A", "B", "C", "D"), g_t, g_jax):
        assert _rel(a.numpy(), b) < 1e-5, name


@pytest.mark.parametrize("T", [64, 50])
def test_mamba2_apply_matches_jax(T):
    from repro.configs import get_reduced as jax_reduced

    cfg = jax_reduced("mamba2-370m").mamba
    d_model = 128
    jp = JSSM.init_mamba2(jax.random.PRNGKey(0), d_model, cfg)
    # a dt_bias and A_log away from init, so every path carries gradient
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, T, d_model)) * 0.5).astype(np.float32)
    gout = rng.standard_normal((2, T, d_model)).astype(np.float32)

    def f(p, xx):
        return jnp.sum(JSSM.mamba2_apply(p, xx, cfg) * gout)

    y_jax = JSSM.mamba2_apply(jp, jnp.asarray(x), cfg)
    g_jax = flatten_with_paths(jax.grad(f)(jp, jnp.asarray(x)))
    params = params_from_jax(flatten_with_paths(jp), device="cpu")
    params = {k: v.requires_grad_() for k, v in params.items()}
    y = TSSM.mamba2_apply(params, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_jax),
                               rtol=2e-5, atol=2e-5)
    grads = torch.autograd.grad((y * torch.from_numpy(gout)).sum(),
                                list(params.values()))
    assert set(params) == set(g_jax)
    for k, g in zip(params, grads):
        assert _rel(g.numpy(), g_jax[k]) < 1e-4, k


def test_cpu_ssd_takes_plain_version_and_counts_nothing():
    ops.reset_launch_counts()
    ins = [torch.from_numpy(a) for a in _inputs(1, 16, 2, 8, 4)]
    y, st = ops.ssd_scan(*ins, 8)
    py, pst = SSD.ssd_scan_plain(*ins, 8)
    assert torch.equal(y, py) and torch.equal(st, pst)
    assert ops.launch_counts()["ssd_scan_fwd"] == 0
    assert ops.launch_counts()["ssd_scan_bwd"] == 0


def test_ssd_kernel_entry_points_refuse_cpu_tensors():
    ins = [torch.from_numpy(a) for a in _inputs(1, 8, 2, 8, 4)]
    with pytest.raises(ValueError, match="CUDA"):
        SSD.ssd_scan_fwd_kernel(*ins)
    with pytest.raises(ValueError, match="CUDA"):
        SSD.ssd_scan_bwd_kernel(*ins, None, ins[0])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ssd_scan kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_ssd_kernels_match_plain(cuda):
    ins = [torch.from_numpy(a).to(cuda) for a in _inputs(2, 200, 4, 64, 32)]
    leaves = [t.clone().requires_grad_() for t in ins]
    y, st = SSD.SSDScan.apply(*leaves)
    gk = torch.autograd.grad(y.sum() + st.sum(), leaves)
    leaves2 = [t.clone().requires_grad_() for t in ins]
    y2, st2 = SSD.ssd_scan_plain(*leaves2, 64)
    gp = torch.autograd.grad(y2.sum() + st2.sum(), leaves2)
    assert _rel(y.detach().cpu(), y2.detach().cpu()) < 1e-4
    assert _rel(st.detach().cpu(), st2.detach().cpu()) < 1e-4
    for a, b in zip(gk, gp):
        assert _rel(a.cpu(), b.cpu()) < 1e-4
