"""The port's hand-written optimizers and schedules against the JAX
package's: N steps on a fixed gradient stream from the same start.

Tolerance 1e-6 relative / 1e-7 absolute over 12 steps (float32; the
elementwise updates are the same arithmetic, the global norm sums in
another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as JO
from repro.optim import schedules as JS
from repro_torch.optim import optimizers as TO
from repro_torch.optim import schedules as TS
import test_torch_threads

test_torch_threads.share_cores()

STEPS = 12


def _tree(rng, scale=1.0):
    return {"conv": (rng.normal(size=(3, 3, 2, 4)) * scale).astype(np.float32),
            "gn": {"scale": (rng.normal(size=(4,)) * scale).astype(np.float32)},
            "head": (rng.normal(size=(6, 5)) * scale).astype(np.float32)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in sorted(tree.items()):
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


@pytest.mark.parametrize("name,kw", [
    ("sgd_momentum", dict(weight_decay=0.0, grad_clip_norm=None)),
    ("sgd_momentum", dict(weight_decay=1e-3, grad_clip_norm=1.0)),
    ("adamw", dict(weight_decay=0.0, grad_clip_norm=None)),
    ("adamw", dict(weight_decay=0.05, grad_clip_norm=1.0)),
], ids=["sgd", "sgd_wd_clip", "adamw", "adamw_wd_clip"])
def test_optimizer_trajectory_matches_reference(name, kw):
    cfg = dict(name=name, init_lr=0.1, total_steps=STEPS, warmup_steps=2,
               **kw)
    jopt = JO.make_optimizer(JO.OptimizerConfig(**cfg))
    topt = TO.make_optimizer(TO.OptimizerConfig(**cfg))
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    jp = {k: jnp.asarray(v) for k, v in _flat(p0).items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in _flat(p0).items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(STEPS):
        g = _flat(_tree(rng, scale=3.0))
        jp, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                             jp, step)
        tp, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                             ts, tp, step)
        for k in jp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{k} at step {step}")


def test_update_returns_new_tensors():
    """The params exchange keeps old parameter dicts in teacher pools, so
    an update must never write into the params it is given."""
    opt = TO.sgd_momentum(TS.constant_schedule(0.1))
    p = {"w": torch.ones(3)}
    state = opt.init(p)
    new, _ = opt.update({"w": torch.ones(3)}, state, p, 0)
    assert torch.equal(p["w"], torch.ones(3)) and not torch.equal(
        new["w"], p["w"])


@pytest.mark.parametrize("name", ["sgd_momentum", "adamw"])
def test_update_consumes_grads_and_state(name):
    """An update takes each leaf out of its gradient and state dicts as it
    makes the new one (so one leaf's old and new state are alive at a
    time), leaves the params as they were, and computes what a clipped
    update from copies of the same inputs computes."""
    opt = TO.make_optimizer(TO.OptimizerConfig(
        name=name, init_lr=0.1, total_steps=4, grad_clip_norm=1.0))
    rng = np.random.default_rng(2)
    p = {k: torch.from_numpy(v) for k, v in _flat(_tree(rng)).items()}
    g = {k: torch.from_numpy(v) for k, v in _flat(_tree(rng, 3.0)).items()}
    state = opt.init(p)
    for _ in range(2):  # a state with moments that are not zero
        p, state = opt.update(dict(g), state, p, 0)
    copy = {k: {n: t.clone() for n, t in d.items()} for k, d in state.items()}
    p_before = {k: v.clone() for k, v in p.items()}
    grads = dict(g)
    new_p, new_s = opt.update(grads, state, p, 1)
    assert grads == {} and all(d == {} for d in state.values())
    for k in p:
        assert torch.equal(p[k], p_before[k]), k
    again_p, again_s = opt.update(dict(g), copy, p_before, 1)
    for k in p:
        assert torch.equal(new_p[k], again_p[k]), k
        for n in new_s:
            assert torch.equal(new_s[n][k], again_s[n][k]), (n, k)


def test_clip_by_global_norm_matches_reference():
    g = _flat(_tree(np.random.default_rng(1), scale=5.0))
    jc, jn = JO.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()},
                                    1.0)
    tc, tn = TO.clip_by_global_norm({k: torch.from_numpy(v)
                                     for k, v in g.items()}, 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("total,warmup", [(12, 0), (12, 3), (100, 10)])
def test_warmup_cosine_matches_reference_and_ends_at_zero(total, warmup):
    js = JS.warmup_cosine_schedule(0.1, total, warmup)
    ts = TS.warmup_cosine_schedule(0.1, total, warmup)
    for step in range(total + 2):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6,
                                   atol=1e-9)
    assert ts(total) == 0.0
