"""The teacher schedule of chip_smoke.py's main path, on the CPU.

chip_smoke.py drives K=3 ResNet-18 clients (N_P=3, S_P=4, W=S_P, Δ=1,
prediction_topk) for 12 steps on the card and checks which client steps
distilled against `chip_smoke.REFERENCE_DISTILLED`. That schedule is a
function of the numpy draws alone (pulls, pool inserts and samples, window
expiry), not of the model or the pixels: so the same run with resnet_tiny
in place of ResNet-18, on the smoke's images subsampled to 8x8, gives it
on the CPU, through the JAX package and through the port. Both must equal the constant, step for step and client for client.
The LM path (mamba2-370m) and the hybrid path (zamba2-7b) share one fleet
and so one schedule, `chip_smoke.REFERENCE_DISTILLED_LM`: each is derived
here with its own architecture's reduced config, zamba2-7b's cut to one
period of its pattern (6 layers) as on the card. The MoE path (arctic-480b)
runs the same data, wire and training over K=2 clients, whose schedule is
`chip_smoke.REFERENCE_DISTILLED_MOE`, derived with reduced arctic-480b; the
DeepSeek path (deepseek-v3-671b) the same over K=2, whose schedule is
`chip_smoke.REFERENCE_DISTILLED_DEEPSEEK`, derived with reduced
deepseek-v3-671b cut as on the card to one MoE layer (MLA, sigmoid
top-8 routing over 12 experts, the shared expert) without MTP.
"""
import dataclasses

import numpy as np
import pytest

import chip_smoke as CS
import test_torch_threads

test_torch_threads.share_cores()


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


# ---------------------------------------------------------------------------
# the LM path
# ---------------------------------------------------------------------------

LM_TOKENS = 16  # columns of the smoke's sequences the stand-in model reads


def _run_lm(pkg, arch, k):
    """chip_smoke.py's LM path (K, N_P, S_P, W, Δ, batch, steps, the data,
    partition and position seeds, the adaptive delta-compressed wire) with
    the reduced config of ``arch`` (zamba2-7b's cut to the card's one
    period) on the first 16 tokens of each sequence in place of the full
    model on 512, over ``k`` clients: the schedule is a function of the
    numpy draws alone. The hybrid path (zamba2-7b) runs the same fleet;
    the MoE path (arctic-480b) and the DeepSeek path the same over two
    clients."""
    if pkg == "jax":
        from repro import data as D
        from repro import lm as LM
        from repro.comm import CommConfig
        from repro.configs import get_reduced
        from repro.core import DecentralizedTrainer, MHDConfig, RunConfig
        from repro.core.graph import complete_graph
        from repro.models.config import patterned_stages
        from repro.models.zoo import build_bundle
        from repro.optim.optimizers import OptimizerConfig, make_optimizer
        extra = {}
    else:
        from repro_torch import data as D
        from repro_torch import lm as LM
        from repro_torch.comm import CommConfig
        from repro_torch.configs import get_reduced
        from repro_torch.core import (DecentralizedTrainer, MHDConfig,
                                      RunConfig, complete_graph)
        from repro_torch.models import build_bundle
        from repro_torch.models.config import patterned_stages
        from repro_torch.optim import OptimizerConfig, make_optimizer
        extra = {"device": "cpu"}
    cfg = get_reduced(arch)
    if arch == CS.ZAMBA_ARCH:
        n = CS.ZAMBA_CFG.num_layers
        cfg = dataclasses.replace(cfg, num_layers=n, stages=patterned_stages(
            n, cfg.stages[0].block)).validate()
    if arch == CS.DS_ARCH:  # the card's cut: one MoE layer, no MTP, and
        # the card's routing (12 experts, top-8, capacity 1.25)
        cfg = dataclasses.replace(cfg, num_layers=1, stages=(
            dataclasses.replace(cfg.stages[-1], repeats=1),), mtp=False,
            moe=dataclasses.replace(cfg.moe, **{
                f: getattr(CS.DS_CFG.moe, f) for f in (
                    "num_experts", "top_k", "capacity_factor")})).validate()
    arrays, _, part = CS.lm_path_data(LM, D, k)
    arrays = {"tokens": np.ascontiguousarray(arrays["tokens"][:, :LM_TOKENS]),
              "labels": arrays["labels"]}
    bundles = [LM.lm_client_bundle(build_bundle(cfg), CS.LM_MAX_POS,
                                   CS.LM_POS_SEED)
               for _ in range(k)]
    trainer = DecentralizedTrainer(
        bundles, make_optimizer(OptimizerConfig(**CS.LM_OPTIMIZER)),
        MHDConfig(**CS.LM_MHD), RunConfig(**CS.LM_RUN), arrays,
        part.client_indices, part.public_indices, complete_graph(k),
        CS.LM_DOMAINS, exchange="prediction_adaptive",
        comm=CommConfig(**CS.LM_COMM), **extra)
    history = [trainer.step(t) for t in range(CS.LM_STEPS)]
    return [[int(mt[f"c{i}/distill_active"]) for mt in history]
            for i in range(k)]


@pytest.mark.parametrize("arch,k,name", [
    (CS.LM_ARCH, CS.LM_K, "REFERENCE_DISTILLED_LM"),
    (CS.ZAMBA_ARCH, CS.LM_K, "REFERENCE_DISTILLED_LM"),
    (CS.MOE_ARCH, CS.MOE_K, "REFERENCE_DISTILLED_MOE"),
    (CS.DS_ARCH, CS.DS_K, "REFERENCE_DISTILLED_DEEPSEEK")],
    ids=[CS.LM_ARCH, CS.ZAMBA_ARCH, CS.MOE_ARCH, CS.DS_ARCH])
def test_smoke_lm_teacher_schedule_is_the_references(arch, k, name):
    jax_sched = _run_lm("jax", arch, k)
    assert _run_lm("torch", arch, k) == jax_sched
    assert jax_sched == getattr(CS, name)
    assert np.all(np.asarray(jax_sched)[:, :CS.LM_S_P] == 1)
