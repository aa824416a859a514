"""The slice as a whole: the port's DecentralizedTrainer against the JAX
package's on the setup of tests/test_comm.py (K=3 resnet_tiny clients on a
complete graph), with the reference's init params carried across.

Both packages draw the same numpy streams in the same order (pulls, pool
samples, public and private batches), so the teacher schedule is the same
draw for draw; the float32 trajectories then agree step by step. Stated
tolerances: per-client loss and every loss metric within 2e-4 relative /
2e-5 absolute over 10 steps (CPU float32, two frameworks' convolutions;
the top-k wire rounds teacher values to f16, so one rounding flip moves a
teacher logit by 1e-3 relative); teacher fractions as equal counts; final
β metrics equal (argmax accuracies on 40 test images).
"""
import dataclasses

import numpy as np
import pytest

import test_torch_threads

test_torch_threads.share_cores()

STEPS, K, LABELS, M = 10, 3, 8, 2


def _setup(pkg):
    if pkg == "jax":
        from repro import data as D
    else:
        from repro_torch import data as D
    ds = D.make_synthetic_vision(num_labels=LABELS, samples_per_label=30,
                                 image_size=8, noise=0.5, seed=0)
    test = D.make_synthetic_vision(num_labels=LABELS, samples_per_label=5,
                                   image_size=8, noise=0.5, seed=1,
                                   prototype_seed=0)
    part = D.partition_dataset(ds.labels, D.PartitionConfig(
        num_clients=K, num_labels=LABELS, labels_per_client=2, skew=100.0,
        gamma_pub=0.2, seed=0))
    return ds, test, part


def _trainer(pkg, exchange, bundles=None, comm=None):
    if pkg == "jax":
        from repro.comm import CommConfig
        from repro.core import DecentralizedTrainer, MHDConfig, RunConfig
        from repro.core.graph import complete_graph
        from repro.models.resnet import resnet_tiny
        from repro.models.zoo import build_bundle
        from repro.optim.optimizers import OptimizerConfig, make_optimizer
        extra = {}
    else:
        from repro_torch.comm import CommConfig
        from repro_torch.core import (DecentralizedTrainer, MHDConfig,
                                      RunConfig, complete_graph)
        from repro_torch.models import build_bundle, resnet_tiny
        from repro_torch.optim import OptimizerConfig, make_optimizer
        extra = {"device": "cpu"}
    ds, test, part = _setup(pkg)
    if bundles is None:
        bundles = [build_bundle(resnet_tiny(LABELS, num_aux_heads=M))
                   for _ in range(K)]
    if comm is None and exchange != "params":
        comm = CommConfig(topk=4, horizon=2)
    return DecentralizedTrainer(
        bundles,
        make_optimizer(OptimizerConfig(init_lr=0.05, total_steps=STEPS,
                                       grad_clip_norm=1.0)),
        MHDConfig(nu_emb=1.0, nu_aux=1.0, num_aux_heads=M, delta=1,
                  pool_size=2, pool_update_every=2),
        RunConfig(steps=STEPS, batch_size=8, public_batch_size=16,
                  eval_every=0, seed=0),
        {"images": ds.images, "labels": ds.labels}, part.client_indices,
        part.public_indices, complete_graph(K), LABELS, exchange=exchange,
        comm=comm, **extra), test


def _port_bundles(jax_trainer):
    from repro.common.pytree import flatten_with_paths
    from repro_torch.checkpoint.io import params_from_jax
    from repro_torch.models import build_bundle, resnet_tiny

    out = []
    for c in jax_trainer.clients:
        flat = {k: np.asarray(v)
                for k, v in flatten_with_paths(c.params).items()}
        b = build_bundle(resnet_tiny(LABELS, num_aux_heads=M))
        out.append(dataclasses.replace(
            b, init=lambda gen, flat=flat: params_from_jax(flat,
                                                           device="cpu")))
    return out


@pytest.mark.parametrize("exchange", ["prediction_topk", "params"])
def test_trajectory_matches_reference(exchange):
    tj, test = _trainer("jax", exchange)
    tp, _ = _trainer("torch", exchange, _port_bundles(tj))
    for t in range(STEPS):
        mj, mp = tj.step(t), tp.step(t)
        assert mj.keys() == mp.keys(), t
        for k in mj:
            if k.endswith("_frac"):
                assert round(mp[k] * 16) == round(mj[k] * 16), (t, k)
            elif k.endswith(("distill_active", "stale_skipped",
                             "mail_staleness")):
                assert mp[k] == mj[k], (t, k)
            else:
                np.testing.assert_allclose(mp[k], mj[k], rtol=2e-4,
                                           atol=2e-5, err_msg=f"{k} @ {t}")
    arrays = {"images": test.images, "labels": test.labels}
    ej, ep = tj.evaluate(arrays), tp.evaluate(arrays)
    assert ej.keys() == ep.keys()
    for k in ej:
        assert ep[k] == pytest.approx(ej[k], abs=1e-9), k
    if exchange != "params":
        assert tp.meter.total_bytes == tj.meter.total_bytes
        assert dict(tp.meter.by_edge) == dict(tp.meter.by_edge_delivered)


def test_port_trainer_defaults_to_cuda_and_refuses_unported_layers():
    import torch
    from repro_torch import resolve_device
    from repro_torch.models import init_resnet, resnet_tiny

    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        assert init_resnet(torch.Generator(), resnet_tiny(4))[
            "stem"].is_cuda
    else:
        with pytest.raises(RuntimeError):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            init_resnet(torch.Generator(), resnet_tiny(4))
    assert resolve_device("cpu").type == "cpu"
    # the fleet layers are ported (tests/test_torch_fleet.py); what the
    # trainer still refuses is what the reference refuses: another
    # process's clients under the params exchange
    from repro_torch.core import DecentralizedTrainer
    with pytest.raises(ValueError, match="prediction exchange"):
        DecentralizedTrainer([], None, None, None, {}, [], None, [], 0,
                             exchange="params", local_clients=[0])


def test_prediction_exchange_reproduces_params_exchange():
    """Within the port: a lossless full-k f32 prediction exchange whose
    horizon covers the pool's staleness range replays the params run —
    same init (one CPU generator chained from the run seed), same rng
    streams, same teacher outputs — so every shared metric agrees to 1e-5
    (the JAX package's own equivalence, tests/test_comm.py)."""
    from repro_torch.comm import CommConfig

    tp, _ = _trainer("torch", "params")
    pred, _ = _trainer("torch", "prediction_topk", comm=CommConfig(
        topk=LABELS, val_dtype="float32", emb_encoding="float32",
        horizon=STEPS + 2))
    for t in range(STEPS):
        m1, m2 = tp.step(t), pred.step(t)
        for k in m1:
            if k in m2:
                assert abs(m1[k] - m2[k]) < 1e-5, (t, k, m1[k], m2[k])
    assert pred.meter.total_bytes > 0
