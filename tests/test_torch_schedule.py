"""The teacher schedule of chip_smoke.py's main path, on the CPU.

chip_smoke.py drives K=3 ResNet-18 clients (N_P=3, S_P=4, W=S_P, Δ=1,
prediction_topk) for 12 steps on the card and checks which client steps
distilled against `chip_smoke.REFERENCE_DISTILLED`. That schedule is a
function of the numpy draws alone (pulls, pool inserts and samples, window
expiry), not of the model or the pixels: so the same run with resnet_tiny
in place of ResNet-18, on the smoke's images subsampled to 8x8, gives it
on the CPU, through the JAX package and through the port. Both must equal the constant, step for step and client for client.
"""
import numpy as np

import chip_smoke as CS


def _run(pkg):
    if pkg == "jax":
        from repro.comm import CommConfig
        from repro.core import DecentralizedTrainer, MHDConfig, RunConfig
        from repro.core.graph import complete_graph
        from repro import data
        from repro.models.resnet import resnet_tiny
        from repro.models.zoo import build_bundle
        from repro.optim.optimizers import OptimizerConfig, make_optimizer
        extra = {}
    else:
        from repro_torch.comm import CommConfig
        from repro_torch.core import (DecentralizedTrainer, MHDConfig,
                                      RunConfig, complete_graph)
        from repro_torch import data
        from repro_torch.models import build_bundle, resnet_tiny
        from repro_torch.optim import OptimizerConfig, make_optimizer
        extra = {"device": "cpu"}
    ds, part = CS.path_data(data)
    images = np.ascontiguousarray(ds.images[:, ::4, ::4])  # 8x8
    m = CS.H - 1
    trainer = DecentralizedTrainer(
        [build_bundle(resnet_tiny(CS.NUM_LABELS, num_aux_heads=m))
         for _ in range(CS.K)],
        make_optimizer(OptimizerConfig(**CS.OPTIMIZER)),
        MHDConfig(num_aux_heads=m, **CS.MHD),
        RunConfig(**CS.RUN),
        {"images": images, "labels": ds.labels}, part.client_indices,
        part.public_indices, complete_graph(CS.K), CS.NUM_LABELS,
        exchange="prediction_topk", comm=CommConfig(**CS.COMM), **extra)
    history = [trainer.step(t) for t in range(CS.STEPS)]
    return [[int(mt[f"c{i}/distill_active"]) for mt in history]
            for i in range(CS.K)]


def test_smoke_teacher_schedule_is_the_references():
    jax_sched = _run("jax")
    assert _run("torch") == jax_sched
    assert jax_sched == CS.REFERENCE_DISTILLED
    # every client distills in round 0, from its freshly seeded pool
    assert np.all(np.asarray(jax_sched)[:, :CS.S_P] == 1)
