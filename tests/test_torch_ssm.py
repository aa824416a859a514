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
only on a card (the ``cuda``-marked tests; chip_smoke.py holds them at the
LM paths' shapes); the plain chunk-start states those tests hold the
forward's saved states against are checked here against the Pallas
kernel.
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


# the kernels' cases: both LM paths' shapes at batch 1 (N = 128, and the
# hybrid path's N = 64), T = 1, a ragged T, dt·A = -10 a step and A = 0;
# held against the plain version in float64 at chip_smoke.py's tolerances:
# 1e-4 for float32 sums in another order and chunking, 2e-3 at dt·A = -10,
# where the kernels' cumsum over a 64-chunk reaches -640 and s_t - s_u
# carries ~4e-5 of absolute rounding into every e^-10(t-u) term
SSD_KERNEL_CASES = [
    ("lm", (1, 512, 32, 64, 128), "model"),
    ("hybrid", (1, 512, 112, 64, 64), "model"),
    ("T=1", (2, 1, 4, 64, 128), "model"),
    ("T=200", (2, 200, 4, 64, 32), "model"),
    ("decay", (1, 512, 8, 64, 128), "decay"),
    ("A=0", (1, 512, 4, 64, 128), "A=0"),
]


def _kernel_inputs(shape, kind, seed=0):
    """`_inputs` with dt around 0.05 (the model's range) and, for "decay",
    dt·A = -10 every step, for "A=0", no decay at all."""
    Bt, T, H, P, N = shape
    x, dt, A, B, C, D = _inputs(Bt, T, H, P, N, seed)
    dt = (dt * 0.05).astype(np.float32)
    if kind == "decay":
        dt = np.broadcast_to(10.0 / -A, dt.shape).astype(np.float32)
    if kind == "A=0":
        A = np.zeros_like(A)
    return x, dt, A, B, C, D


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,kind", SSD_KERNEL_CASES,
                         ids=[c[0] for c in SSD_KERNEL_CASES])
def test_ssd_kernels_match_plain(cuda, name, shape, kind):
    """y, the final state and all six gradients of a random linear function
    of both, kernels against the plain version in float64."""
    tol = 2e-3 if kind == "decay" else 1e-4
    ins = _kernel_inputs(shape, kind)
    rng = np.random.default_rng(7)
    gy = torch.from_numpy(rng.standard_normal(ins[0].shape)).to(cuda)
    gf = torch.from_numpy(rng.standard_normal(
        (shape[0], shape[2], shape[3], shape[4]))).to(cuda)
    leaves = [torch.from_numpy(a).to(cuda).requires_grad_() for a in ins]
    y, st = SSD.SSDScan.apply(*leaves)
    gk = torch.autograd.grad((y * gy.float()).sum() + (st * gf.float()).sum(),
                             leaves)
    leaves2 = [torch.from_numpy(a).to(cuda).double().requires_grad_()
               for a in ins]
    y2, st2 = SSD.ssd_scan_plain(*leaves2, 64)
    gp = torch.autograd.grad((y2 * gy).sum() + (st2 * gf).sum(), leaves2)
    assert _rel(y.detach().cpu(), y2.detach().cpu()) < tol
    assert _rel(st.detach().cpu(), st2.detach().cpu()) < tol
    scale = max(float(b.abs().max()) for b in gp)
    for nm, a, b in zip(("x", "dt", "A", "B", "C", "D"), gk, gp):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        # a gradient that is exactly zero on the plain side (dA at T = 1)
        # is held at the tolerance times the case's largest gradient entry
        err = _rel(a, b) if np.abs(b).max() > 0 else \
            float(np.abs(a - b).max()) / scale
        assert err < tol, nm


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 200, 4, 64, 32), (1, 512, 8, 64, 128),
                                   (1, 300, 16, 64, 64)])
def test_ssd_forward_saved_states_match_plain(cuda, shape):
    """The chunk-start states the forward saves for the backward equal the
    plain state after each prefix of 64·c steps."""
    ins = [torch.from_numpy(a).to(cuda)
           for a in _kernel_inputs(shape, "model", seed=3)]
    _, _, states = SSD.ssd_scan_fwd_kernel(*ins, save_states=True)
    ref = SSD.ssd_chunk_states_plain(*(t.double() for t in ins), 64)
    assert states.shape == ref.shape
    assert _rel(states.cpu(), ref.cpu()) < 1e-4


@pytest.mark.cuda
def test_ssd_forward_repeats(cuda):
    """The forward has no atomics: two calls on one input agree bitwise in
    y, the final state and the saved states."""
    ins = [torch.from_numpy(a).to(cuda)
           for a in _kernel_inputs((2, 300, 8, 64, 128), "model", seed=4)]
    first = SSD.ssd_scan_fwd_kernel(*ins, save_states=True)
    second = SSD.ssd_scan_fwd_kernel(*ins, save_states=True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_ssd_backward_repeats(cuda):
    """The backward has no atomics: two calls on one input, with a final
    state's gradient and a ragged T, agree bitwise in all six gradients."""
    shape = (2, 300, 8, 64, 128)
    ins = [torch.from_numpy(a).to(cuda)
           for a in _kernel_inputs(shape, "model", seed=6)]
    _, _, states = SSD.ssd_scan_fwd_kernel(*ins, save_states=True)
    rng = np.random.default_rng(8)
    dy = torch.from_numpy(rng.standard_normal(ins[0].shape,
                                              dtype=np.float32)).to(cuda)
    dfin = torch.from_numpy(rng.standard_normal(
        (shape[0], shape[2], shape[3], shape[4]), dtype=np.float32)).to(cuda)
    first = SSD.ssd_scan_bwd_kernel(*ins, states, dy, dfin)
    second = SSD.ssd_scan_bwd_kernel(*ins, states, dy, dfin)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("Bt,T,H,P,N", [(1, 150, 2, 8, 4),
                                        (2, 130, 3, 16, 8)])
def test_ssd_chunk_states_plain_matches_pallas(Bt, T, H, P, N):
    """The plain chunk-start states the kernel's saved states are held
    against: zero, then the final state of the Pallas kernel (interpret
    mode) on each prefix of 64·c steps."""
    ins = _inputs(Bt, T, H, P, N, seed=5)
    states = SSD.ssd_chunk_states_plain(*map(torch.from_numpy, ins), 64)
    assert states.shape == (Bt, H, -(-T // 64), P, N)
    assert not states[:, :, 0].any()
    for c in range(1, states.shape[2]):
        t = 64 * c
        pre = [ins[0][:, :t], ins[1][:, :t], ins[2], ins[3][:, :t],
               ins[4][:, :t], ins[5]]
        _, st = jax_ssd_scan(*map(jnp.asarray, pre), chunk=16,
                             interpret=True)
        np.testing.assert_allclose(states[:, :, c].numpy(), np.asarray(st),
                                   rtol=3e-4, atol=3e-4)
