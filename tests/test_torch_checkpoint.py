"""Checkpoints in the port (`repro_torch.checkpoint.io`): the step-indexed
`CheckpointManager` (tests/test_checkpoint.py's cases), per-client
``(params, opt_state)`` directories that cross between the packages in
both directions with equal values, and a resume: after the port trains 3
steps and saves, a fresh trainer of each package restores step 3 and both
take 3 more steps that agree (MHD on the top-k prediction wire, and
separate supervised), within tests/test_torch_exp.py's tolerances.
"""
import numpy as np
import pytest
import torch

import test_torch_threads

test_torch_threads.share_cores()

import test_torch_exp as TX  # noqa: E402
from test_torch_exp import PX, RX  # noqa: E402

from repro_torch.checkpoint.io import (CheckpointManager,  # noqa: E402
                                       params_from_jax, params_to_jax,
                                       restore_client_states,
                                       save_client_states)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(3, 4, generator=g),
            "nested": {"b": torch.arange(5, dtype=torch.int32) + seed}}


def _zeros_like(tree):
    return {k: (_zeros_like(v) if isinstance(v, dict)
                else torch.zeros_like(v)) for k, v in tree.items()}


def test_manager_roundtrip(tmp_path):
    t = dict(_tree(), c=torch.randn(2, 3).bfloat16())  # bf16 state_dtype
    mgr = CheckpointManager(str(tmp_path / "run"))
    mgr.save(1, t)
    restored = mgr.restore(_zeros_like(t))
    assert torch.equal(restored["a"], t["a"])
    assert torch.equal(restored["nested"]["b"], t["nested"]["b"])
    assert restored["nested"]["b"].dtype == torch.int32
    assert restored["c"].dtype == torch.bfloat16
    assert torch.equal(restored["c"], t["c"])


def test_structure_and_shape_mismatch_raise(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "run"))
    mgr.save(1, _tree())
    with pytest.raises(ValueError, match="structure"):
        mgr.restore({"a": torch.zeros(3, 4)})
    bad = _zeros_like(_tree())
    bad["a"] = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(bad)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(_tree())


def test_manager_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "run"), max_to_keep=2)
    for s in (10, 20, 30):
        mgr.save(s, _tree(s))
    assert mgr.steps() == [20, 30]
    restored = mgr.restore(_zeros_like(_tree()))
    assert torch.equal(restored["a"], _tree(30)["a"])
    assert torch.equal(mgr.restore(_zeros_like(_tree()), 20)["a"],
                       _tree(20)["a"])


def _reference_states(opt_name):
    """Two clients' (params, opt_state) of resnet_tiny with one aux head,
    as the reference holds them (nested dicts of jax arrays, conv kernels
    HWIO), every optimizer leaf distinct from its param."""
    import jax.numpy as jnp

    from repro_torch.models import build_bundle, resnet_tiny

    b = build_bundle(resnet_tiny(6, num_aux_heads=1))
    slots = ("momentum",) if opt_name == "sgd" else ("m", "v")
    out = []
    for i in range(2):
        p = params_to_jax(b.init(torch.Generator().manual_seed(i)))
        out.append((TX.nested({k: jnp.asarray(v) for k, v in p.items()}),
                    {s: TX.nested({k: jnp.asarray(v * (j + 2.0) + i)
                                   for k, v in p.items()})
                     for j, s in enumerate(slots)}))
    return out


def _flat_np(tree):
    from repro.common.pytree import flatten_with_paths

    return {k: np.asarray(v) for k, v in flatten_with_paths(tree).items()}


def _port(params_np):
    return params_from_jax(params_np, device="cpu")


@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
def test_client_states_cross_from_reference_to_port(tmp_path, opt_name):
    from repro.checkpoint.io import save_client_states as ref_save

    states = _reference_states(opt_name)
    ref_save(str(tmp_path), 3, states)
    targets = [({k: torch.zeros_like(v) for k, v in _port(
                    _flat_np(p)).items()},
                {s: {k: torch.zeros_like(v) for k, v in _port(
                    _flat_np(o)).items()} for s, o in opt.items()})
               for p, opt in states]
    step, got = restore_client_states(str(tmp_path), targets)
    assert step == 3
    for (p, opt), (gp, gopt) in zip(states, got):
        for k, v in _port(_flat_np(p)).items():
            assert torch.equal(gp[k], v), k
        for s, o in opt.items():
            for k, v in _port(_flat_np(o)).items():
                assert torch.equal(gopt[s][k], v), (s, k)


@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
def test_client_states_cross_from_port_to_reference(tmp_path, opt_name):
    import jax
    import jax.numpy as jnp

    from repro.checkpoint.io import restore_client_states as ref_restore

    ref = _reference_states(opt_name)
    port = [(_port(_flat_np(p)), {s: _port(_flat_np(o))
                                  for s, o in opt.items()})
            for p, opt in ref]
    save_client_states(str(tmp_path), 5, port, ids=[0, 1])
    zeros = [jax.tree.map(jnp.zeros_like, st) for st in ref]
    step, got = ref_restore(str(tmp_path), zeros)
    assert step == 5
    for (p, opt), (gp, gopt) in zip(port, got):
        for k, v in params_to_jax(p).items():
            np.testing.assert_array_equal(_flat_np(gp)[k], v, err_msg=k)
        for s, o in opt.items():
            for k, v in params_to_jax(o).items():
                np.testing.assert_array_equal(_flat_np(gopt[s])[k], v)


RESUMES = {
    "mhd_topk": ("mhd", {"pool_size": 2, "pool_update_every": 2,
                         "delta": 1, "nu_emb": 1.0, "nu_aux": 1.0}, True),
    "separate": ("supervised", {"scope": "separate"}, False),
}


@pytest.mark.parametrize("case", sorted(RESUMES))
def test_resume_from_port_checkpoint_matches_reference(monkeypatch, tmp_path,
                                                      case):
    """The port trains 3 steps and saves; a fresh trainer of each package
    restores step 3 (params and optimizer state onto its device; pools
    reseeded at step 3; data streams from their start, as the reference
    does) and takes steps 3-5."""
    algo, params, aux = RESUMES[case]
    wire = (RX.WireSpec(exchange="prediction_topk", topk=4, horizon=2)
            if algo == "mhd" else None)
    clients = RX.ExperimentSpec.uniform_fleet(2, aux_heads=1) if aux \
        else None
    spec = TX.tiny_spec(RX, algo, params, clients, steps=6, wire=wire)
    TX.same_initial_params(monkeypatch, spec)
    d = str(tmp_path / "ckpt")

    def fresh(X, **kw):
        a = X.make_algorithm(spec if X is RX else
                             PX.ExperimentSpec.from_json(spec.to_json()))
        a.setup(X.Experiment(a.spec, **kw).build_bindings())
        return a

    def params_of(a):
        return ([c.params for c in a.trainer.clients] if algo == "mhd"
                else a.trainer.params)

    first = fresh(PX, device="cpu")
    for t in range(3):
        first.step(t)
    first.save(d, 3)
    saved = [{k: v.clone() for k, v in p.items()} for p in params_of(first)]
    runs = []
    for X, kw in ((RX, {}), (PX, {"device": "cpu"})):
        a = fresh(X, **kw)
        assert a.restore(d, 3) == 3
        if X is PX:  # the restore is bitwise
            for want, got in zip(saved, params_of(a)):
                for k in want:
                    assert torch.equal(got[k], want[k]), k
        runs.append((a, [a.step(t) for t in range(3, 6)]))
    (ra, ref_steps), (pa, port_steps) = runs
    TX.assert_step_metrics_close(ref_steps, port_steps)
    if algo == "mhd":
        for rc, pc in zip(ra.trainer.clients, pa.trainer.clients):
            assert [e.step for e in pc.pool.entries] == \
                [e.step for e in rc.pool.entries]
