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
    an update must never write into its inputs."""
    opt = TO.sgd_momentum(TS.constant_schedule(0.1))
    p = {"w": torch.ones(3)}
    state = opt.init(p)
    new, _ = opt.update({"w": torch.ones(3)}, state, p, 0)
    assert torch.equal(p["w"], torch.ones(3)) and not torch.equal(
        new["w"], p["w"])


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
