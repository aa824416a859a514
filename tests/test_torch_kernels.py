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
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
from repro.kernels.dist_ce import dist_ce as jax_dist_ce
from repro.kernels.emb_dist import emb_dist as jax_emb_dist
from repro.kernels.topk_wire import topk_wire as jax_topk_wire
from repro_torch.kernels import build, ops
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


@pytest.mark.parametrize("B,V,k,ties", [
    pytest.param(4, 130, 8, False, id="4-130-8"),
    pytest.param(7, 1024, 32, False, id="7-1024-32"),
    pytest.param(2, 64, 4, False, id="2-64-4"),
    pytest.param(3, 40, 40, False, id="3-40-40"),
    # an odd V: in a (B, V) f32 array every row but the first starts off
    # 16 bytes, which the CUDA kernel reads by a scalar head and tail
    pytest.param(3, 1001, 8, False, id="3-1001-8"),
    # integer rows a few thousand wide: most entries tie with others
    pytest.param(4, 3000, 8, True, id="4-3000-8-ties"),
    pytest.param(4, 3000, 32, True, id="4-3000-32-ties")])
def test_topk_wire_plain_matches_pallas(B, V, k, ties):
    x = (np.random.default_rng(6).integers(-3, 3, (B, V)).astype(np.float32)
         if ties else _logits(B, V, 6))
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


def test_emb_dist_is_the_cuda_kernel():
    info = {i["name"]: i for i, _ in ops.KERNELS}
    root = Path(__file__).resolve().parents[1]
    for name in ("emb_dist_fwd", "emb_dist_bwd"):
        assert info[name]["route"] == "cuda"
        assert info[name]["source"] == \
            "src/repro_torch/kernels/csrc/emb_dist.cu"
        assert info[name]["replaces"] == "src/repro/kernels/emb_dist.py:39"
    assert (root / info["emb_dist_fwd"]["source"]).is_file()
    assert not list(build.CSRC.glob("emb_dist*.py"))


EMB_E = [1, 3, 511, 512, 513, 1024, 1028, 8191, 8192]


@pytest.mark.parametrize("E", EMB_E)
@pytest.mark.parametrize("size", [4, 2])
def test_emb_dist_geometry_covers_each_element_once(E, size):
    """`launch_geometry`'s (block, warp, lane, vector) map, as the kernels
    index: each row of a block's groups gets each of its E columns from
    exactly one (warp, lane, chunk, element) of its group, in loads that
    stay inside the row; the 16-byte path only for aligned rows whose E
    the vector divides; at most 8 warps a block, a warp at most 1,024
    elements."""
    for aligned in (True, False):
        g = EMB.launch_geometry(E, size, size, aligned)
        vec16 = aligned and E % (16 // size) == 0
        assert g.path == ("vec16" if vec16 else "scalar")
        assert g.vec * size == 16 if vec16 else g.vec == 1
        assert g.threads == 32 * g.warps_per_row * g.rows_per_block <= 256
        assert g.vec * g.chunks * 32 == EMB.WARP_SPAN
        B = 2 * g.rows_per_block + 1
        seen = np.zeros((g.grid(B) * g.rows_per_block, E), np.int64)
        w, lane, c, v = np.meshgrid(np.arange(g.threads // 32),
                                    np.arange(32), np.arange(g.chunks),
                                    np.arange(g.vec), indexing="ij")
        for block in range(g.grid(B)):
            row = block * g.rows_per_block + w // g.warps_per_row
            col = EMB.element_index(g, w % g.warps_per_row, lane, c, v)
            # a vector is loaded whole or not at all: its first column
            # decides, and its last stays inside the row
            first = EMB.element_index(g, w % g.warps_per_row, lane, c, 0)
            take = first < E
            assert (col[take] < E).all()
            np.add.at(seen, (row[take], col[take]), 1)
        assert (seen[:B] == 1).all(), (E, size, aligned)


def test_emb_dist_takes_16_byte_loads_only_when_aligned():
    base = torch.zeros(8, 1032)
    s = base[:, :1024]
    assert EMB._geometry(s, s).path == "vec16"          # stride 1032
    assert EMB._geometry(base[:, 1:1025], s).path == "scalar"  # off 4 bytes
    assert EMB._geometry(base[:, 2:1026], s).path == "scalar"
    odd = torch.zeros(8, 1030)[:, :1024]                # stride 1030
    assert EMB._geometry(odd, s).path == "scalar"
    half = torch.zeros(8, 1024, dtype=torch.bfloat16)
    assert EMB._geometry(half, half).vec == 8
    assert EMB._geometry(half, s).vec == 4              # bf16 s, f32 t
    assert EMB._geometry(half[:, 4:], half[:, 4:]).path == "scalar"
    assert EMB._geometry(half[:, 4:], s).path == "vec16"  # 8-byte vectors
    wide = torch.zeros(8, 1028, dtype=torch.bfloat16)
    assert EMB._geometry(wide[:, 2:1026], s).path == "scalar"  # off 4


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


def _neg_inf_rows(B, V, seed):
    """Every 7th column -inf, row 1 all -inf, row 2 -inf from column 3."""
    x = _logits(B, V, seed)
    x[:, ::7] = -np.inf
    x[1] = -np.inf
    x[2, 3:] = -np.inf
    return x


# the one-pass kernel's edges, as chip_smoke.phase_topk holds them
TOPK_KERNEL_CASES = {
    "V=50257": (lambda: _logits(64, 50257, 20), 8),
    "k=32 at V=50280": (lambda: _logits(64, 50280, 21), 32),
    "k=64 at V=32000": (lambda: _logits(64, 32000, 22), 64),
    "k=512 at V=32000": (lambda: _logits(8, 32000, 23), 512),
    "ties at V=50280": (lambda: np.random.default_rng(24).integers(
        -3, 3, (64, 50280)).astype(np.float32), 8),
    "-inf columns": (lambda: _neg_inf_rows(16, 50280, 25), 8),
    "V=3": (lambda: _logits(9, 3, 26), 3),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TOPK_KERNEL_CASES))
def test_topk_wire_kernel_edges(cuda, name):
    make, k = TOPK_KERNEL_CASES[name]
    x = torch.from_numpy(make()).to(cuda)
    v, i, lse = TOPK.topk_wire_kernel(x, k)
    pv, pi, plse = TOPK.topk_wire_plain(x, k)
    assert torch.equal(v, pv) and torch.equal(i, pi)
    torch.testing.assert_close(lse, plse, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_dist_ce_kernels_match_plain(cuda):
    s = torch.from_numpy(_logits(64, 1000, 12)).to(cuda)
    t = torch.from_numpy(_logits(64, 1000, 13)).to(cuda)
    out, ref_out = DCE.dist_ce_fwd_kernel(s, t), DCE.dist_ce_fwd_plain(s, t)
    for a, b in zip(out[:3], ref_out[:3]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def _emb_rows(dev, B, E, dtype, seed, stride=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, stride or E, generator=g, device=dev).to(dtype)
    return x[:, :E]


# (B, E, student dtype, teacher dtype, row stride)
EMB_KERNEL_CASES = {
    "resnet 32x512": (32, 512, torch.float32, torch.float32, None),
    "pod 2044x1024": (2044, 1024, torch.float32, torch.float32, None),
    "odd E": (37, 1001, torch.float32, torch.float32, None),
    "E=8192": (64, 8192, torch.float32, torch.float32, None),
    "E=1028": (33, 1028, torch.float32, torch.float32, None),
    "bf16 student, f32 teacher": (64, 1024, torch.bfloat16, torch.float32,
                                  None),
    "f16 both": (16, 2048, torch.float16, torch.float16, None),
    "B=0": (0, 512, torch.float32, torch.float32, None),
    "row stride above E": (40, 512, torch.float32, torch.float32, 520),
    "row stride off 16 bytes": (40, 512, torch.float32, torch.float32, 514),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(EMB_KERNEL_CASES))
def test_emb_dist_kernels_match_plain(cuda, name):
    B, E, s_dt, t_dt, stride = EMB_KERNEL_CASES[name]
    s = _emb_rows(cuda, B, E, s_dt, 40, stride)
    t = _emb_rows(cuda, B, E, t_dt, 41, stride)
    g = torch.randn(B, device=cuda)
    torch.testing.assert_close(EMB.emb_dist_fwd_kernel(s, t),
                               EMB.emb_dist_plain(s, t), rtol=1e-4,
                               atol=1e-4)
    gs, ref = EMB.emb_dist_bwd_kernel(s, t, g), EMB.emb_dist_bwd_plain(s, t, g)
    assert gs.dtype == s.dtype and gs.shape == (B, E)
    # a 2-byte gradient may round the other way from a last-bit difference
    tol = (1e-4, 1e-6) if s_dt == torch.float32 else (1e-2, 1e-4)
    torch.testing.assert_close(gs.float(), ref.float(), rtol=tol[0],
                               atol=tol[1])
    same = EMB.emb_dist_fwd_kernel(s, s.clone())
    assert (same == 0).all()


@pytest.mark.cuda
def test_emb_dist_refused_launch_raises(cuda, monkeypatch):
    """A launch the library refuses (here a vector width it has no kernel
    for) raises; nothing falls back."""
    s = torch.randn(4, 512, device=cuda)
    monkeypatch.setattr(EMB, "launch_geometry", lambda *a: EMB.Geometry(
        "vec16", 3, 1, 1, 4, 128))
    for call in (lambda: EMB.emb_dist_fwd_kernel(s, s),
                 lambda: EMB.emb_dist_bwd_kernel(s, s, s[:, 0])):
        with pytest.raises(RuntimeError, match="launch failed"):
            call()


def _check_flash_kernels(dev, B, T, S, H, KV, d, causal, window, dtype,
                         tol, softcap=0.0):
    """The forward (o and lse) and the three gradients against the plain
    version in float64, each as max|d| / max|plain|; the lse on the rows
    with a key in their band, and <= -1e29 on the rows with none. Under a
    ``softcap`` q is scaled by chip_smoke's SOFTCAP_Q_SCALE, so that the
    scores reach the cap."""
    g = torch.Generator(device=dev).manual_seed(14)
    q = torch.randn(B, T, H, d, generator=g, device=dev)
    if softcap:
        q = q * CS.SOFTCAP_Q_SCALE
    k, v = (torch.randn(B, S, KV, d, generator=g, device=dev)
            for _ in range(2))
    do = torch.randn(B, T, H, d, generator=g, device=dev)
    q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
    o, lse = FA.flash_attention_fwd_kernel(q, k, v, causal=causal,
                                           window=window, softcap=softcap)
    grads = FA.flash_attention_bwd_kernel(q, k, v, o, lse, do,
                                          causal=causal, window=window,
                                          softcap=softcap)
    leaves = [x.double().requires_grad_() for x in (q, k, v)]
    o2 = FA.flash_attention_plain(*leaves, causal=causal, window=window,
                                  softcap=softcap)
    grads2 = torch.autograd.grad(o2, leaves, do.double())
    lse2 = CS._flash_lse_plain(leaves[0].detach(), leaves[1].detach(),
                               causal, window, softcap)
    live = lse2 > -1e29
    assert bool((lse[~live] <= -1e29).all())
    for a, b in zip((o, lse[live], *grads), (o2, lse2[live], *grads2)):
        b = b.detach()
        assert float((a.double() - b).abs().max() / b.abs().max()) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,S,H,KV,d,causal,window", [
    (2, 200, 200, 8, 8, 112, True, 0), (1, 300, 300, 8, 4, 256, True, 64),
    (2, 70, 50, 4, 2, 64, False, 0), (1, 300, 100, 8, 4, 64, False, 64),
    (1, 260, 100, 4, 2, 128, True, 32), (1, 1024, 1024, 16, 4, 128, True, 0),
    (2, 513, 513, 8, 8, 112, True, 0), (2, 200, 200, 8, 4, 100, True, 0),
    (1, 130, 130, 4, 2, 50, True, 0)])
def test_flash_attention_kernels_match_plain(cuda, B, T, S, H, KV, d, causal,
                                             window):
    """f32 sums in another order, so 1e-4 relative; the fourth and fifth
    cases have rows with no key in their band (T > S + window). The
    backward adds dQ into one f32 buffer from every key tile's block, for
    each of the G query heads of its kv head: the sixth and seventh cases
    take 16 key tiles with G = 4, and a ragged last tile at T = 513, d =
    112. The last two have d % 8 != 0 (a ragged last slice of the head
    dim), the last also d % 4 != 0 (rows staged by the scalar loop) and a
    T that is not a multiple of the forward's 128-row query tile."""
    _check_flash_kernels(cuda, B, T, S, H, KV, d, causal, window,
                         torch.float32, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("softcap", [50.0, 5.0])
@pytest.mark.parametrize("B,T,S,H,KV,d,causal,window", [
    (2, 512, 512, 24, 8, 128, True, 0), (1, 300, 300, 8, 4, 128, True, 64),
    (2, 70, 50, 4, 2, 64, False, 0), (1, 260, 100, 4, 2, 128, True, 32)])
def test_flash_attention_softcap_kernels_match_plain(cuda, B, T, S, H, KV,
                                                     d, causal, window,
                                                     softcap):
    """The kernels with a logit softcap c (the scaled scores capped to c
    tanh(s / c) before the mask, dS times 1 - (capped / c)^2) against the
    plain version in float64 at 1e-4 relative: the tp path's minitron-4b
    shape, a sliding-window GQA case, non-causal S != T, and rows with no
    key in their band; at c = 5 tanh saturates."""
    _check_flash_kernels(cuda, B, T, S, H, KV, d, causal, window,
                         torch.float32, 1e-4, softcap)


@pytest.mark.cuda
def test_flash_attention_bf16_kernels_match_plain(cuda):
    """bf16 inputs at the hybrid path's shape, widened to f32 in the
    kernels: the outputs differ from the float64 plain version by their
    rounding to bf16 (2^-9 relative) and, in the backward, by O and dO in
    bf16 entering D = rowsum(dO o O); 2e-2, as chip_smoke holds them."""
    _check_flash_kernels(cuda, 8, 512, 512, 32, 32, 112, True, 0,
                         torch.bfloat16, 2e-2)


def _load_script(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# the forward's ablation script, which holds the backward's as BWD
FWD_ABLATION = _load_script(Path(__file__).resolve().parents[1] / "tools"
                            / "flash_fwd_ablation.py")
ABLATIONS = {"fwd": FWD_ABLATION.VARIANTS,
             "bwd": FWD_ABLATION.BWD.VARIANTS}


@pytest.mark.parametrize("direction,name", [
    (direction, name) for direction, table in ABLATIONS.items()
    for name, patches in table.items() if patches])
def test_flash_attention_ablation_patches_apply(direction, name):
    """tools/flash_fwd_ablation.py and scripts/flash_bwd_ablation.py build
    copies of flash_attention.cu patched by text: each text a variant
    replaces occurs exactly once in the committed source, and the copy
    differs from it."""
    source = (build.CSRC / "flash_attention.cu").read_text()
    patches = ABLATIONS[direction][name]
    assert FWD_ABLATION.patched(source, name, patches) != source


SSD_ABLATION = _load_script(Path(__file__).resolve().parents[1]
                            / "ablations" / "ssd_fwd.py")


@pytest.mark.parametrize("name", [name for name, patches
                                  in SSD_ABLATION.VARIANTS.items() if patches])
def test_ssd_scan_ablation_patches_apply(name):
    """ablations/ssd_fwd.py builds copies of ssd_scan.cu patched by
    text: each text a variant replaces occurs exactly once in the
    committed source, and the copy differs from it."""
    source = (build.CSRC / "ssd_scan.cu").read_text()
    patches = SSD_ABLATION.VARIANTS[name]
    assert SSD_ABLATION.patched(source, name, patches) != source


SSD_BWD_ABLATION = _load_script(Path(__file__).resolve().parents[1]
                                / "ablations" / "ssd_bwd.py")


@pytest.mark.parametrize("name", [name for name, patches
                                  in SSD_BWD_ABLATION.VARIANTS.items()
                                  if patches])
def test_ssd_scan_bwd_ablation_patches_apply(name):
    """ablations/ssd_bwd.py builds copies of ssd_scan.cu patched by text:
    each text a variant replaces occurs exactly once in the committed
    source, and the copy differs from it."""
    source = (build.CSRC / "ssd_scan.cu").read_text()
    patches = SSD_BWD_ABLATION.VARIANTS[name]
    assert SSD_BWD_ABLATION.patched(source, name, patches) != source


TOPK_ABLATION = _load_script(Path(__file__).resolve().parents[1]
                             / "ablations" / "topk_wire.py")


@pytest.mark.parametrize("name", [name for name, patches
                                  in TOPK_ABLATION.VARIANTS.items()
                                  if patches])
def test_topk_wire_ablation_patches_apply(name):
    """ablations/topk_wire.py builds copies of topk_wire.cu patched by
    text: each text a variant replaces occurs exactly once in the
    committed source, and the copy differs from it."""
    source = (build.CSRC / "topk_wire.cu").read_text()
    patches = TOPK_ABLATION.VARIANTS[name]
    assert TOPK_ABLATION.patched(source, name, patches) != source


EMB_ABLATION = _load_script(Path(__file__).resolve().parents[1]
                            / "ablations" / "emb_dist.py")


@pytest.mark.parametrize("name", [name for name, (patches, _, _)
                                  in EMB_ABLATION.VARIANTS.items()
                                  if patches])
def test_emb_dist_ablation_patches_apply(name):
    """ablations/emb_dist.py builds copies of emb_dist.cu patched by text:
    each text a variant replaces occurs exactly once in the committed
    source, and the copy differs from it."""
    source = (build.CSRC / "emb_dist.cu").read_text()
    patches = EMB_ABLATION.VARIANTS[name][0]
    assert EMB_ABLATION.patched(source, name, patches) != source


@pytest.mark.cuda
def test_flash_attention_forward_repeats(cuda):
    """The forward sums every row in a fixed order, with no atomics: two
    runs on one input agree bitwise in o and lse."""
    g = torch.Generator(device=cuda).manual_seed(16)
    q = torch.randn(2, 1000, 16, 112, generator=g, device=cuda)
    k, v = (torch.randn(2, 1000, 4, 112, generator=g, device=cuda)
            for _ in range(2))
    o1, lse1 = FA.flash_attention_fwd_kernel(q, k, v, causal=True)
    o2, lse2 = FA.flash_attention_fwd_kernel(q, k, v, causal=True)
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)


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
