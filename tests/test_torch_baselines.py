"""The paper's three baselines in the port (`repro_torch.core.{fedmd,
fedavg,supervised}`) against the JAX package's, each through
`Experiment.run()` for 4 steps from the same initial params: FedMD
on a heterogeneous fleet (resnet_tiny + resnet_tiny34), FedAvg averaging
every 2 steps, supervised pooled and separate. Tolerances are
tests/test_torch_exp.py's (step metrics within 2e-4 relative / 2e-5
absolute, batch accuracies as equal counts of 16, eval metrics equal).

Also: the leafwise mean FedAvg takes, and the private-batch streams every
algorithm shares (tests/test_experiment.py's unified-streams test, across
the packages).
"""
import numpy as np
import pytest
import torch

import test_torch_threads

test_torch_threads.share_cores()

import test_torch_exp as TX  # noqa: E402
from test_torch_exp import PX, RX  # noqa: E402

HET = ("resnet_tiny", "resnet_tiny34")

CASES = {
    "fedmd": ("fedmd", {"digest_weight": 0.5}, "het"),
    "fedavg": ("fedavg", {"average_every": 2}, None),
    "pooled": ("supervised", {"scope": "pooled"}, None),
    "separate": ("supervised", {"scope": "separate"}, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_baseline_matches_reference(monkeypatch, case):
    algo, params, fleet = CASES[case]
    clients = tuple(RX.ClientSpec(a) for a in HET) if fleet else None
    spec = TX.tiny_spec(RX, algo, params, clients, steps=4, eval_every=2)
    (ref_steps, ref), (port_steps, port) = TX.run_both(monkeypatch, spec)
    TX.assert_step_metrics_close(ref_steps, port_steps)
    TX.assert_history_equal(ref, port)
    assert port.metrics == pytest.approx(ref.metrics, abs=1e-9)
    if case == "fedavg":
        assert [m.get("fedavg/averaged") for m in port_steps] == \
            [None, 1.0, None, 1.0]


def test_tree_mean_is_the_references_float32_sum():
    """Summed left to right in float32, then scaled by 1/n: the same bits
    as the reference's `tree_mean` on the CPU."""
    import jax.numpy as jnp

    from repro.common.pytree import tree_mean as ref_mean
    from repro_torch.common.pytree import tree_mean

    rng = np.random.default_rng(0)
    trees = [{"a": rng.standard_normal((5, 7)).astype(np.float32),
              "b/c": rng.standard_normal(3).astype(np.float32)}
             for _ in range(3)]
    got = tree_mean([{k: torch.from_numpy(v) for k, v in t.items()}
                     for t in trees])
    want = ref_mean([{k: jnp.asarray(v) for k, v in t.items()}
                     for t in trees])
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_fedavg_averages_every_client_and_resets_momentum(monkeypatch):
    """After an averaging step every client holds the leafwise mean of the
    params the clients had just before it (in float64, at 1e-6 relative),
    and its momentum is zero."""
    import repro_torch.core.fedavg as FA

    seen, tree_mean = [], FA.tree_mean

    def recording_mean(trees):
        seen.append([dict(t) for t in trees])
        return tree_mean(trees)

    monkeypatch.setattr(FA, "tree_mean", recording_mean)
    exp = PX.Experiment(TX.tiny_spec(PX, "fedavg"), device="cpu")
    b = exp.build_bindings()
    tr = FA.FedAvgTrainer(b.bundles[0], b.optimizer, b.arrays,
                          b.partition.client_indices, b.num_labels,
                          batch_size=16, average_every=2, device="cpu")
    tr.step(0)
    assert not seen
    tr.step(1)
    (before,) = seen
    assert not torch.equal(before[0]["stem"], before[1]["stem"])
    for k in before[0]:
        want = sum(p[k].double() for p in before) / len(before)
        for p in tr.client_params:
            np.testing.assert_allclose(p[k].double().numpy(), want.numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    for s in tr.opt_states:
        assert all(not m.any() for m in s["momentum"].values())


def test_unified_private_streams_across_algorithms_and_packages():
    """MHD, FedMD, FedAvg and separate-supervised draw client i's private
    batches from the same client_stream_seed stream — in the port, and the
    same stream as the reference's."""
    from repro.data import BatchIterator as RefIterator
    from repro.data import client_stream_seed as ref_seed
    from repro_torch.core import (DecentralizedTrainer, FedAvgTrainer,
                                  FedMDTrainer, MHDConfig, RunConfig,
                                  SupervisedTrainer)
    from repro_torch.data import client_stream_seed

    assert client_stream_seed(5, 3) == 5 + 13 * 3 == ref_seed(5, 3)
    b = PX.Experiment(TX.tiny_spec(PX), device="cpu").build_bindings()
    opt, cpu = b.optimizer, "cpu"
    mhd = DecentralizedTrainer(
        b.bundles, opt, MHDConfig(num_aux_heads=0, pool_size=2,
                                  pool_update_every=2),
        RunConfig(steps=2, batch_size=16, public_batch_size=16, seed=0),
        b.arrays, b.partition.client_indices, b.partition.public_indices,
        b.graph, b.num_labels, device=cpu)
    fedmd = FedMDTrainer(b.bundles, opt, b.arrays,
                         b.partition.client_indices,
                         b.partition.public_indices, b.num_labels,
                         batch_size=16, seed=0, device=cpu)
    fedavg = FedAvgTrainer(b.bundles[0], opt, b.arrays,
                           b.partition.client_indices, b.num_labels,
                           batch_size=16, seed=0, device=cpu)
    sup = SupervisedTrainer(b.bundles, opt, b.arrays,
                            b.partition.client_indices, b.num_labels,
                            batch_size=16, scope="separate", seed=0,
                            device=cpu)
    for i in range(2):
        ref = RefIterator(b.arrays, b.partition.client_indices[i], 16,
                          seed=ref_seed(0, i)).next()
        for it in (mhd.clients[i].private_iter, fedmd.iters[i],
                   fedavg.iters[i], sup.iters[i]):
            got = it.next()
            np.testing.assert_array_equal(got["labels"], ref["labels"])
            np.testing.assert_array_equal(got["images"], ref["images"])


def test_baselines_default_to_the_card():
    from repro_torch.core import FedAvgTrainer, FedMDTrainer, \
        SupervisedTrainer

    if torch.cuda.is_available():
        return
    b = PX.Experiment(TX.tiny_spec(PX), device="cpu").build_bindings()
    idx = b.partition.client_indices
    for make in (
            lambda: FedAvgTrainer(b.bundles[0], b.optimizer, b.arrays, idx),
            lambda: FedMDTrainer(b.bundles, b.optimizer, b.arrays, idx,
                                 b.partition.public_indices),
            lambda: SupervisedTrainer(b.bundles, b.optimizer, b.arrays,
                                      idx)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
