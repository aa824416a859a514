"""The port's Mixture-of-Experts FFN (`repro_torch.models.moe`) against the
JAX package's (`repro.models.moe`), fed the same seeded numpy inputs and
the reference's params through `params_from_jax`.

Tolerances: expert ids, slot positions and keep masks exactly; outputs,
aux losses and gradients within 1e-4 of the largest entry of each array
(float32 CPU matmuls summed in another order by the two frameworks, the
tolerance tests/test_torch_lm.py uses); rows of dropped tokens exactly
zero in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as JIO
from repro.models import moe as JM
from repro.models.config import MoEConfig as JMoEConfig
from repro_torch.checkpoint import io as TIO
from repro_torch.models import moe as TM
from repro_torch.models.config import MoEConfig
import test_torch_threads

test_torch_threads.share_cores()

for _op in (torch.exp, torch.log, torch.sqrt):
    _op(torch.ones(1))

TOL = 1e-4
D, FF = 16, 32


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _cfgs(E=4, K=2, cf=1.25, shared=0, aux=0.01):
    kw = dict(num_experts=E, top_k=K, d_ff_expert=FF,
              num_shared_experts=shared, capacity_factor=cf,
              router_aux_weight=aux)
    return JMoEConfig(**kw), MoEConfig(**kw)


def _both(E=4, K=2, cf=1.25, shared=0, seed=0, tokens=16):
    """(jax cfg, port cfg, jax params, port params, x as numpy)."""
    jcfg, tcfg = _cfgs(E, K, cf, shared)
    jp = JM.init_moe(jax.random.PRNGKey(seed), D, jcfg)
    flat = {k: np.asarray(v) for k, v in JIO.flatten_with_paths(jp).items()}
    tp = TIO.params_from_jax(flat, device="cpu")
    x = np.random.default_rng(seed + 1).standard_normal(
        (2, tokens // 2, D)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def _recount(ids: np.ndarray, E: int, C: int):
    """Slot positions by a running count per expert in token-major order."""
    seen = np.zeros(E, np.int64)
    pos = np.empty(ids.size, np.int64)
    for i, e in enumerate(ids.reshape(-1)):
        pos[i] = seen[e]
        seen[e] += 1
    return pos, pos < C


def test_init_moe_keys_and_shapes_match_jax():
    for shared in (0, 1):
        jcfg, tcfg, _, tp, _ = _both(shared=shared)
        jflat = JIO.flatten_with_paths(
            JM.init_moe(jax.random.PRNGKey(0), D, jcfg))
        port = TM.init_moe(torch.Generator().manual_seed(0), D, tcfg)
        assert {k: tuple(v.shape) for k, v in port.items()} == \
            {k: tuple(v.shape) for k, v in jflat.items()}
        assert port["router"].dtype == torch.float32
        assert ("shared/w_up" in port) == bool(shared)


@pytest.mark.parametrize("scoring", ["softmax", "sigmoid"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_router_topk_matches_jax(scoring, k):
    logits = np.random.default_rng(k).standard_normal((40, 8)).astype(
        np.float32) * 2
    wj, ij, pj = JM.router_topk(jnp.asarray(logits), k, scoring)
    wt, it, pt = TM.router_topk(torch.from_numpy(logits), k, scoring)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert _rel(wt.numpy(), wj) < TOL and _rel(pt.numpy(), pj) < TOL
    if scoring == "sigmoid":
        np.testing.assert_allclose(wt.sum(-1).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("scoring", ["softmax", "sigmoid"])
def test_router_ties_go_to_the_lowest_expert(scoring):
    """Equal scores: jax.lax.top_k keeps the lowest index first, and so
    must the port (torch.topk promises no order among equal values)."""
    logits = np.zeros((6, 8), np.float32)
    logits[1, [2, 5, 7]] = 1.0  # a three-way tie at the top
    logits[2, :] = -3.0
    logits[3, [6, 1]] = 2.5
    logits[4, ::-1] = np.arange(8)  # strictly ordered, descending index
    logits[5, [3, 4]] = [1.0, 1.0]
    for k in (1, 2, 3, 8):
        _, ij, _ = JM.router_topk(jnp.asarray(logits), k, scoring)
        _, it, _ = TM.router_topk(torch.from_numpy(logits), k, scoring)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(it.numpy()[0], np.arange(8))
    np.testing.assert_array_equal(it.numpy()[1, :3], [2, 5, 7])


def test_load_balance_loss_matches_jax():
    rng = np.random.default_rng(3)
    probs = rng.dirichlet(np.ones(8), size=50).astype(np.float32)
    ids = np.argsort(-probs, axis=-1, kind="stable")[:, :2].astype(np.int32)
    lj = float(JM.load_balance_loss(jnp.asarray(probs), jnp.asarray(ids), 8))
    lt = TM.load_balance_loss(torch.from_numpy(probs), torch.from_numpy(ids),
                              8).item()
    assert abs(lt - lj) <= TOL * abs(lj)
    uniform = torch.full((800, 8), 1.0 / 8)
    rows = torch.arange(800)
    ids = torch.stack([rows % 8, (rows + 1) % 8], -1)
    assert TM.load_balance_loss(uniform, ids, 8).item() == \
        pytest.approx(1.0, rel=1e-6)


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("scoring", ["softmax", "sigmoid"])
def test_moe_apply_matches_jax(shared, scoring):
    jcfg, tcfg, jp, tp, x = _both(shared=shared, seed=shared)
    yj, aj = JM.moe_apply(jp, jnp.asarray(x), jcfg, scoring=scoring)
    yt, at = TM.moe_apply(tp, torch.from_numpy(x), tcfg, scoring=scoring)
    assert yt.shape == x.shape
    assert _rel(yt.numpy(), yj) < TOL
    assert abs(at.item() - float(aj)) <= TOL * abs(float(aj))


def test_capacity_drops_the_same_pairs_and_rows():
    """cf = 0.25 at E = 2, k = 1: C = 2 of 16 tokens. The slot positions
    and keep mask are the numpy recount of the reference's expert ids, and
    the dropped tokens' rows are exactly zero in both packages."""
    jcfg, tcfg, jp, tp, x = _both(E=2, K=1, cf=0.25)
    yj = np.asarray(JM.moe_apply(jp, jnp.asarray(x), jcfg)[0]).reshape(-1, D)
    yt = TM.moe_apply(tp, torch.from_numpy(x), tcfg)[0].numpy().reshape(-1, D)
    xf = torch.from_numpy(x.reshape(-1, D))
    _, ij, _ = JM.router_topk(jnp.asarray(x.reshape(-1, D)) @ jp["router"],
                              1)
    C = TM.capacity(xf.shape[0], tcfg)
    assert C == 2
    _, it, _ = TM.router_topk(xf @ tp["router"], 1)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    pos, keep = TM.slot_positions(it.reshape(-1), 2, C)
    want_pos, want_keep = _recount(np.asarray(ij), 2, C)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert (~want_keep).sum() > 0
    np.testing.assert_array_equal(yt[~want_keep], 0.0)
    np.testing.assert_array_equal(yj[~want_keep], 0.0)
    assert np.all(np.abs(yt[want_keep]).max(-1) > 0)
    assert _rel(yt, yj) < TOL


def test_full_capacity_is_the_direct_per_token_evaluation():
    """tests/test_moe.py's case on the port: with nothing dropped, the
    scatter dispatch equals each token's experts evaluated one by one (in
    float64 here)."""
    _, tcfg, _, tp, x = _both(cf=8.0, tokens=12)
    y, _ = TM.moe_apply(tp, torch.from_numpy(x), tcfg)
    xf = torch.from_numpy(x.reshape(-1, D)).double()
    p64 = {k: v.double() for k, v in tp.items()}
    w, ids, _ = TM.router_topk(xf @ p64["router"], 2)
    want = torch.zeros_like(xf)
    for n in range(xf.shape[0]):
        for j in range(2):
            e = int(ids[n, j])
            h = torch.nn.functional.silu(xf[n] @ p64["w_gate"][e]) * \
                (xf[n] @ p64["w_up"][e])
            want[n] += w[n, j] * (h @ p64["w_down"][e])
    assert _rel(y.reshape(-1, D).numpy(), want.numpy()) < TOL


@pytest.mark.parametrize("shared,cf", [(0, 1.25), (1, 0.5)])
def test_gradients_match_jax(shared, cf):
    """d/dx and d/d(every leaf) of Σ y·r + aux against jax.grad, with
    pairs dropped at cf = 0.5."""
    jcfg, tcfg, jp, tp, x = _both(shared=shared, cf=cf, seed=4)
    r = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def f_j(p, xx):
        y, aux = JM.moe_apply(p, xx, jcfg)
        return jnp.sum(y * r) + aux

    gp_j, gx_j = jax.grad(f_j, argnums=(0, 1))(jp, jnp.asarray(x))
    gp_j = JIO.flatten_with_paths(gp_j)
    params = {k: v.clone().requires_grad_() for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = TM.moe_apply(params, xt, tcfg)
    loss = (y * torch.from_numpy(r)).sum() + aux
    grads = torch.autograd.grad(loss, [xt, *params.values()])
    assert _rel(grads[0].numpy(), gx_j) < TOL
    assert set(params) == set(gp_j)
    for k, g in zip(params, grads[1:]):
        assert _rel(g.numpy(), gp_j[k]) < TOL, k


_JAX_MOE = {}


def _jax_moe(cfg):
    if cfg not in _JAX_MOE:
        _JAX_MOE[cfg] = jax.jit(lambda p, x: JM.moe_apply(p, x, cfg))
    return _JAX_MOE[cfg]


def test_moe_dispatch_invariants_match_jax():
    """tests/test_moe.py's property on both packages (seeded numpy params
    in place of its jax.random draw): the same output and aux, finite,
    the shape kept, aux within [0, weight·E·k·4]."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=15, deadline=None)
    @given(E=st.sampled_from([2, 4, 8]), K=st.integers(1, 2),
           T=st.integers(2, 24), seed=st.integers(0, 5))
    def check(E, K, T, seed):
        kw = dict(num_experts=E, top_k=min(K, E), d_ff_expert=8,
                  capacity_factor=1.0, router_aux_weight=0.01)
        jcfg, tcfg = JMoEConfig(**kw), MoEConfig(**kw)
        rng = np.random.default_rng(seed)
        flat = {k: (rng.standard_normal(shape) / np.sqrt(shape[-2])
                    ).astype(np.float32)
                for k, shape in (("router", (8, E)), ("w_gate", (E, 8, 8)),
                                 ("w_up", (E, 8, 8)), ("w_down", (E, 8, 8)))}
        x = rng.standard_normal((1, T, 8)).astype(np.float32)
        yj, aj = _jax_moe(jcfg)({k: jnp.asarray(v) for k, v in flat.items()},
                             jnp.asarray(x))
        yt, at = TM.moe_apply(TIO.params_from_jax(flat, device="cpu"),
                              torch.from_numpy(x), tcfg)
        assert yt.shape == x.shape and torch.isfinite(yt).all()
        assert 0.0 <= at.item() <= 0.01 * E * tcfg.top_k * 4
        assert _rel(yt.numpy(), yj) < TOL
        assert abs(at.item() - float(aj)) <= TOL * abs(float(aj)) + 1e-9

    check()
