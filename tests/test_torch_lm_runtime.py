"""The LM slices as a whole: a K=3 fleet of reduced mamba2-370m clients
(2 layers, d_model 128, vocab 512, 2 aux heads), and one of reduced
zamba2-7b clients cut to one period of their pattern as on the card (6
layers: five Mamba2 layers, then one with the shared attention block and
the dense FFN), distilling next-token predictions over
``prediction_adaptive`` with ``compression="delta"``, in the JAX
package's DecentralizedTrainer and in the port's, with the reference's
init params carried across.

Both draw the same numpy streams in the same order, and the seeded
position subset is the same (`core.lm_adapter.jax_permutation`), so the
teacher schedule is identical step for step. Stated tolerances: per-client
loss and every loss metric within 2e-4 relative / 2e-5 absolute over 6
steps (float32 CPU matmuls in another order, then logits cast to bf16 and
teacher values to f16, where a rounding flip moves a value by one ulp of
the narrow type); teacher fractions as equal counts; wire bytes equal;
final β metrics within one position in 8·(16−1) per domain.
"""
import dataclasses

import numpy as np
import pytest

import test_torch_threads

test_torch_threads.share_cores()

STEPS, K, DOMAINS, SEQ, VOCAB, M = 6, 3, 6, 16, 512, 2
MAX_POS, POS_SEED = 24, 17
PERIOD = 6  # zamba2-7b's 5:1 pattern


def _config(pkg, arch):
    """The reduced config of ``arch``; zamba2-7b's cut to one period."""
    if pkg == "jax":
        from repro.configs import get_reduced
        from repro.models.config import patterned_stages
    else:
        from repro_torch.configs import get_reduced
        from repro_torch.models.config import patterned_stages
    cfg = get_reduced(arch)
    if arch == "zamba2-7b":
        cfg = dataclasses.replace(cfg, num_layers=PERIOD, stages=(
            patterned_stages(PERIOD, cfg.stages[0].block))).validate()
    return cfg


def _data(D_lm):
    arrays = D_lm.make_text_arrays(DOMAINS, 12, SEQ, VOCAB, seed=0,
                                   table_seed=0)
    test = D_lm.make_text_arrays(DOMAINS, 8, SEQ, VOCAB, seed=991,
                                 table_seed=0)
    return arrays, test


def _trainer(pkg, arch, bundles=None):
    if pkg == "jax":
        from repro import data as D
        from repro import lm as LM
        from repro.comm import CommConfig
        from repro.core import DecentralizedTrainer, MHDConfig, RunConfig
        from repro.core.graph import complete_graph
        from repro.models.zoo import build_bundle
        from repro.optim.optimizers import OptimizerConfig, make_optimizer
        extra = {}
    else:
        from repro_torch import data as D
        from repro_torch import lm as LM
        from repro_torch.comm import CommConfig
        from repro_torch.core import (DecentralizedTrainer, MHDConfig,
                                      RunConfig, complete_graph)
        from repro_torch.models import build_bundle
        from repro_torch.optim import OptimizerConfig, make_optimizer
        extra = {"device": "cpu"}
    arrays, test = _data(LM)
    part = D.partition_dataset(arrays["labels"], D.PartitionConfig(
        num_clients=K, num_labels=DOMAINS, labels_per_client=2, skew=100.0,
        gamma_pub=0.2, seed=0))
    if bundles is None:
        bundles = [LM.lm_client_bundle(build_bundle(_config(pkg, arch)),
                                       MAX_POS, POS_SEED) for _ in range(K)]
    trainer = DecentralizedTrainer(
        bundles,
        make_optimizer(OptimizerConfig(name="adamw", init_lr=1e-3,
                                       warmup_steps=2, total_steps=STEPS,
                                       grad_clip_norm=1.0)),
        MHDConfig(nu_emb=0.0, nu_aux=0.5, num_aux_heads=M, delta=1,
                  pool_size=2, pool_update_every=2),
        RunConfig(steps=STEPS, batch_size=4, public_batch_size=4,
                  eval_every=0, eval_batch_size=8, seed=0),
        arrays, part.client_indices, part.public_indices, complete_graph(K),
        DOMAINS, exchange="prediction_adaptive",
        comm=CommConfig(topk=8, val_dtype="float16", emb_encoding="none",
                        budget_bytes_per_token=24, compression="delta"),
        **extra)
    return trainer, test


def _port_bundles(jax_trainer, arch):
    from repro.common.pytree import flatten_with_paths
    from repro_torch.checkpoint.io import params_from_jax
    from repro_torch.lm import lm_client_bundle
    from repro_torch.models import build_bundle

    out = []
    for c in jax_trainer.clients:
        flat = {k: np.asarray(v)
                for k, v in flatten_with_paths(c.params).items()}
        b = lm_client_bundle(build_bundle(_config("torch", arch)), MAX_POS,
                             POS_SEED)
        out.append(dataclasses.replace(
            b, init=lambda gen, flat=flat: params_from_jax(flat,
                                                           device="cpu")))
    return out


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b"])
def test_lm_fleet_tracks_reference(arch):
    tj, test = _trainer("jax", arch)
    tp, _ = _trainer("torch", arch, _port_bundles(tj, arch))
    sched_j, sched_p = [], []
    for t in range(STEPS):
        mj, mp = tj.step(t), tp.step(t)
        assert mj.keys() == mp.keys(), t
        sched_j.append([mj[f"c{i}/distill_active"] for i in range(K)])
        sched_p.append([mp[f"c{i}/distill_active"] for i in range(K)])
        for k in mj:
            if k.endswith("_frac"):
                assert round(mp[k] * MAX_POS) == round(mj[k] * MAX_POS), \
                    (t, k)
            elif k.endswith(("distill_active", "stale_skipped",
                             "mail_staleness")):
                assert mp[k] == mj[k], (t, k)
            else:
                np.testing.assert_allclose(mp[k], mj[k], rtol=2e-4,
                                           atol=2e-5, err_msg=f"{k} @ {t}")
    assert sched_p == sched_j
    assert any(any(row) for row in sched_j)  # the fleet distilled
    assert tp.meter.total_bytes == tj.meter.total_bytes
    assert dict(tp.meter.by_edge) == dict(tp.meter.by_edge_delivered)
    ej, ep = tj.evaluate(test), tp.evaluate(test)
    assert ej.keys() == ep.keys()
    per_domain = 8 * (SEQ - 1)
    for k in ej:
        assert ep[k] == pytest.approx(ej[k], abs=1.0 / per_domain + 1e-9), k
