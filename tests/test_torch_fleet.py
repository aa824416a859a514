"""The port's elastic fleet layer (`repro_torch.fleet`: snapshots, the
`ChurnDriver`, membership) and the trainer's fleet surface — the cases of
tests/test_fleet.py on the port, the `churn_ring` preset through
`Experiment.run()` against the JAX package's, and fleet snapshots
crossing between the two packages in both directions.

Within the port: save → restore → step on is bitwise the run that never
stopped (params and step metrics), for MHD under the synchronous loop,
under both schedulers' clocks (a 4× straggler cut between its pool
boundaries), in the params mode, and for FedMD, FedAvg and supervised.
Against the reference: the same tolerances as tests/test_torch_exp.py
(step metrics within 2e-4 relative / 2e-5 absolute; the gate, mail and
fleet counts and the meter's books equal), and a snapshot's state equal
leaf for leaf after the layout conversion.
"""
import dataclasses

import numpy as np
import pytest
import torch

import test_torch_threads

test_torch_threads.share_cores()

from repro_torch.comm import (CommConfig, CommMeter,  # noqa: E402
                              LoopbackTransport, PredictionBus)
from repro_torch.core import (AsyncScheduler, ScheduleConfig,  # noqa: E402
                              ScoreboardScheduler)
from repro_torch.core.graph import complete_graph, cycle_graph  # noqa: E402
from repro_torch.fleet import (ChurnDriver, Join, Kill,  # noqa: E402
                               Membership, Restart, Rewire,
                               restore_clients, restore_fleet, save_fleet,
                               snapshot_steps)
from test_torch_scheduler import (make_trainer,  # noqa: E402
                                  params_bitwise_equal)

PRED_KW = dict(K=4, steps=8, delta=1, m=1, s_p=2, graph=cycle_graph(4),
               comm=CommConfig(topk=8, val_dtype="float32",
                               emb_encoding="float32", horizon=12))


def tree_equal(a, b) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


# -- membership and the bus's tombstones --------------------------------------

def test_membership_liveness_epochs_and_graph_view():
    mem = Membership(cycle_graph(4), 4, [
        Kill(1, step=5), Restart(1, step=9), Join(3, step=3)])
    assert mem.alive(0) == frozenset({0, 1, 2})
    assert mem.alive(6) == frozenset({0, 2, 3})
    assert mem.alive(20) == frozenset({0, 1, 2, 3})
    assert [mem.epoch(t) for t in (0, 3, 5, 9)] == [0, 1, 2, 3]
    assert mem.graph_view(4) == [(1,), (2,), (3,), (0,)]
    view = mem.graph_view(5)
    assert view[0] == () and view[1] == (2,)
    two_hop = ((1, 2), (2, 3), (0, 3), (0, 1))
    mem = Membership(cycle_graph(4), 4, [Rewire(step=6, edges=two_hop)])
    assert mem.graph_view(6) == [tuple(r) for r in two_hop]


def test_bus_tombstones_mail_to_dead_clients():
    mem = Membership(complete_graph(2), 2, [Kill(1, step=3)])
    meter = CommMeter()
    bus = PredictionBus(LoopbackTransport(), complete_graph(2), 2,
                        meter=meter, membership=mem)
    bus.publish(0, b"live", 2)
    assert bus.deliver(2) == 1
    bus.publish(0, b"dead", 3)
    assert bus.deliver(3) == 0
    assert bus.mailbox(1)[0].payload == b"live"
    assert meter.tombstoned_messages == 1 and meter.tombstoned_bytes == 4


# -- snapshots: bitwise resume within the port --------------------------------

def test_snapshot_resume_bitwise_mhd_sync(tmp_path):
    T, N = 4, 8
    tr_a = make_trainer("prediction_topk", **PRED_KW)
    metrics_a = [tr_a.step(t) for t in range(N)]
    tr_b = make_trainer("prediction_topk", **PRED_KW)
    for t in range(T):
        tr_b.step(t)
    save_fleet(str(tmp_path), T, tr_b)
    tr_c = make_trainer("prediction_topk", **PRED_KW)
    assert restore_fleet(str(tmp_path), tr_c) == T
    metrics_c = [tr_c.step(t) for t in range(T, N)]
    assert params_bitwise_equal(tr_a.clients, tr_c.clients)
    assert metrics_a[T:] == metrics_c
    assert tr_a.meter.total_bytes == tr_c.meter.total_bytes
    assert tr_a.meter.delivered_bytes == tr_c.meter.delivered_bytes


def test_snapshot_resume_bitwise_mhd_params_mode(tmp_path):
    T, N = 3, 6
    kw = dict(K=3, steps=N, delta=2, m=1, s_p=2)
    tr_a = make_trainer("params", **kw)
    for t in range(N):
        tr_a.step(t)
    tr_b = make_trainer("params", **kw)
    for t in range(T):
        tr_b.step(t)
    save_fleet(str(tmp_path), T, tr_b)
    tr_c = make_trainer("params", **kw)
    assert restore_fleet(str(tmp_path), tr_c) == T
    for t in range(T, N):
        tr_c.step(t)
    assert params_bitwise_equal(tr_a.clients, tr_c.clients)


@pytest.mark.parametrize("policy,rates,cut,at_cut,at_end", [
    (AsyncScheduler, (1, 1, 2), 6, [6, 6, 3], [12, 12, 6]),
    (AsyncScheduler, (1, 1, 4), 6, [6, 6, 2], [12, 12, 3]),
    (ScoreboardScheduler, (1, 1, 4), 6, [6, 6, 2], [12, 12, 3]),
])
def test_snapshot_resume_bitwise_under_the_scheduler(tmp_path, policy, rates,
                                                     cut, at_cut, at_end):
    """The scheduler's clocks and cursors ride in the snapshot: a 2×
    straggler keeps its cadence and LR position, and a cut between a 4×
    straggler's pool boundaries (its cadence is 8 ticks) resumes bitwise
    under both policies."""
    kw = dict(K=3, steps=12, delta=1, m=1, s_p=2,
              comm=CommConfig(topk=8, val_dtype="float32",
                              emb_encoding="float32", horizon=20))
    tr_a = make_trainer("prediction_topk", **kw)
    sched_a = policy(tr_a, ScheduleConfig(rates))
    metrics_a = [sched_a.tick() for _ in range(12)]
    tr_b = make_trainer("prediction_topk", **kw)
    sched_b = policy(tr_b, ScheduleConfig(rates))
    for _ in range(cut):
        sched_b.tick()
    save_fleet(str(tmp_path), cut, tr_b, scheduler=sched_b)
    tr_c = make_trainer("prediction_topk", **kw)
    sched_c = policy(tr_c, ScheduleConfig(rates))
    assert restore_fleet(str(tmp_path), tr_c, scheduler=sched_c) == cut
    assert sched_c.wall == cut
    assert sched_c.local_steps == sched_b.local_steps == at_cut
    metrics_c = [sched_c.tick() for _ in range(cut, 12)]
    assert params_bitwise_equal(tr_a.clients, tr_c.clients)
    assert metrics_a[cut:] == metrics_c
    assert sched_c.local_steps == sched_a.local_steps == at_end


def baseline_trainer(kind: str):
    """tests/test_fleet.py's ``_baseline_trainer`` on the port."""
    from repro_torch.core.fedavg import FedAvgTrainer
    from repro_torch.core.fedmd import FedMDTrainer
    from repro_torch.core.supervised import SupervisedTrainer
    from repro_torch.data import (PartitionConfig, make_synthetic_vision,
                                  partition_dataset)
    from repro_torch.models import build_bundle, resnet_tiny
    from repro_torch.optim import OptimizerConfig, make_optimizer

    K, labels = 3, 8
    ds = make_synthetic_vision(num_labels=labels, samples_per_label=30,
                               image_size=8, noise=0.5, seed=0)
    part = partition_dataset(ds.labels, PartitionConfig(
        num_clients=K, num_labels=labels, labels_per_client=2, skew=100.0,
        gamma_pub=0.2, seed=0))
    arrays = {"images": ds.images, "labels": ds.labels}
    bundles = [build_bundle(resnet_tiny(labels)) for _ in range(K)]
    opt = make_optimizer(OptimizerConfig(init_lr=0.05, total_steps=6,
                                         grad_clip_norm=1.0))
    if kind == "fedmd":
        return FedMDTrainer(bundles, opt, arrays, part.client_indices,
                            part.public_indices, labels, batch_size=8,
                            public_batch_size=8, device="cpu")
    if kind == "fedavg":
        return FedAvgTrainer(bundles[0], opt, arrays, part.client_indices,
                             labels, batch_size=8, average_every=2,
                             device="cpu")
    return SupervisedTrainer(bundles, opt, arrays, part.client_indices,
                             labels, batch_size=8, scope="separate",
                             device="cpu")


@pytest.mark.parametrize("kind", ["fedmd", "fedavg", "supervised"])
def test_snapshot_resume_bitwise_baselines(kind, tmp_path):
    T, N = 3, 6
    tr_a = baseline_trainer(kind)
    metrics_a = [tr_a.step(t) for t in range(N)]
    tr_b = baseline_trainer(kind)
    for t in range(T):
        tr_b.step(t)
    save_fleet(str(tmp_path), T, tr_b)
    tr_c = baseline_trainer(kind)
    assert restore_fleet(str(tmp_path), tr_c) == T
    metrics_c = [tr_c.step(t) for t in range(T, N)]
    assert metrics_a[T:] == metrics_c
    params_a = tr_a.client_params if kind == "fedavg" else tr_a.params
    params_c = tr_c.client_params if kind == "fedavg" else tr_c.params
    for pa, pc in zip(params_a, params_c):
        assert tree_equal(pa, pc)


def test_snapshot_version_gate(tmp_path):
    from repro_torch.fleet import snapshot as snap

    save_fleet(str(tmp_path), 2, baseline_trainer("supervised"))
    path = str(tmp_path / "step_0000000002" / "proc_all.npz")
    state = snap._load_state(path)
    state["version"] = 999
    snap._save_state(path, state)
    with pytest.raises(ValueError, match="version"):
        restore_fleet(str(tmp_path), baseline_trainer("supervised"))


def test_snapshot_exchange_mismatch_is_rejected(tmp_path):
    save_fleet(str(tmp_path), 2, make_trainer("prediction_topk", **PRED_KW))
    tr = make_trainer("params", K=4, steps=4, delta=1, m=1, s_p=2,
                      graph=cycle_graph(4))
    with pytest.raises(ValueError, match="exchange"):
        restore_clients(str(tmp_path), tr, [0])


# -- kill, restore, tombstones and late joins ---------------------------------

def test_kill_and_restore_bitwise_in_ring(tmp_path):
    T, N, victim = 4, 8, 2
    tr_a = make_trainer("prediction_topk", **PRED_KW)
    for t in range(N):
        tr_a.step(t)
    tr_b = make_trainer("prediction_topk", **PRED_KW)
    for t in range(T):
        tr_b.step(t)
    save_fleet(str(tmp_path), T, tr_b)
    tr_b.deactivate_client(victim)
    c = tr_b.clients[victim]
    c.params = {k: torch.zeros_like(v) for k, v in c.params.items()}
    c.opt_state = {"momentum": {k: torch.zeros_like(v) for k, v
                                in c.opt_state["momentum"].items()}}
    assert victim not in tr_b.active_ids
    assert len(tr_b.bus.mailbox(victim)) == 0
    assert restore_clients(str(tmp_path), tr_b, [victim],
                           step=T) == {victim: T}
    tr_b.activate_client(victim)
    for t in range(T, N):
        tr_b.step(t)
    assert params_bitwise_equal(tr_a.clients, tr_b.clients)
    meter = tr_b.meter
    assert meter.by_edge
    for edge, offered in meter.by_edge.items():
        assert meter.by_edge_delivered.get(edge, 0) <= offered, edge
    assert meter.delivered_bytes == meter.total_bytes


def test_kill_period_tombstones_then_fresh_restart():
    K, steps = 4, 12
    events = [Kill(1, step=4), Restart(1, step=8, from_snapshot=False)]
    mem = Membership(cycle_graph(K), K, events)
    tr = make_trainer("prediction_topk", **dict(
        PRED_KW, K=K, steps=steps, graph=mem.graph_view, membership=mem))
    churn = ChurnDriver(tr, events)
    post_restart_distill = 0
    for t in range(steps):
        churn.before_step(t)
        m = tr.step(t)
        if 4 <= t < 8:
            assert "c1/loss" not in m
        if t >= 8:
            assert "c1/loss" in m
            post_restart_distill += int(m.get("c1/distill_active", 0.0))
    assert churn.applied == ["kill(c1)@4", "restart(c1)@8 fresh"]
    meter = tr.meter
    assert meter.tombstoned_messages > 0
    for edge, offered in meter.by_edge.items():
        assert meter.by_edge_delivered.get(edge, 0) <= offered, edge
    assert meter.delivered_bytes + meter.tombstoned_bytes == \
        meter.total_bytes
    assert post_restart_distill > 0
    assert tr.initialized_clients == [0, 1, 2, 3, 1]


def test_join_late_client_starts_dead():
    K, steps = 3, 6
    events = [Join(2, step=3)]
    mem = Membership(cycle_graph(K), K, events)
    tr = make_trainer("prediction_topk", K=K, steps=steps, delta=1, m=1,
                      s_p=2, comm=CommConfig(topk=8, val_dtype="float32",
                                             emb_encoding="float32",
                                             horizon=10),
                      graph=mem.graph_view, membership=mem)
    assert tr.active_ids == [0, 1]
    churn = ChurnDriver(tr, events)
    for t in range(steps):
        churn.before_step(t)
        m = tr.step(t)
        assert ("c2/loss" in m) == (t >= 3)
    assert tr.active_ids == [0, 1, 2]


def test_fleet_methods_guard_their_clients():
    tr = make_trainer("prediction_topk", K=3, steps=2,
                      comm=CommConfig(topk=4, horizon=4), local_clients=[1],
                      init_scheme="per_client")
    with pytest.raises(ValueError, match="not driven"):
        tr.deactivate_client(0)
    tr.deactivate_client(1)
    tr.deactivate_client(1)  # idempotent
    assert tr.active_ids == []
    tr.activate_client(1)
    assert tr.active_ids == [1]
    tr.clients[1].params = None
    with pytest.raises(ValueError, match="reinit_client"):
        tr.activate_client(1)


# -- init schemes -------------------------------------------------------------

def counting_bundles(K=3, labels=8, m=1):
    from repro_torch.models import build_bundle, resnet_tiny

    counts = []

    def wrap(bundle, i):
        orig = bundle.init

        def init(gen):
            counts.append(i)
            return orig(gen)

        return dataclasses.replace(bundle, init=init)

    return [wrap(build_bundle(resnet_tiny(labels, num_aux_heads=m)), i)
            for i in range(K)], counts


def test_per_client_init_draws_only_local_models():
    bundles, counts = counting_bundles()
    tr = make_trainer("prediction_topk", bundles=bundles, local_clients=[1],
                      init_scheme="per_client",
                      comm=CommConfig(topk=8, horizon=4))
    assert counts == [1] and tr.initialized_clients == [1]
    assert tr.clients[0].params is None and tr.clients[2].params is None
    assert tr.clients[0].opt_state is None
    assert tr.active_ids == [1]
    assert "c1/loss" in tr.step(0) and "c0/loss" not in tr.step(1)
    bundles, counts = counting_bundles()
    tr = make_trainer("prediction_topk", bundles=bundles, local_clients=[1],
                      init_scheme="legacy",
                      comm=CommConfig(topk=8, horizon=4))
    assert counts == [0, 1, 2] and tr.initialized_clients == [0, 1, 2]


def test_per_client_init_is_deterministic_across_processes():
    """A client's draw depends on (seed, client id) alone: the same in a
    process driving {0, 1} as in one driving {1, 2}, and what
    ``reinit_client`` draws again."""
    kw = dict(comm=CommConfig(topk=8, horizon=4), init_scheme="per_client")
    tr_a = make_trainer("prediction_topk", local_clients=[0, 1], **kw)
    tr_b = make_trainer("prediction_topk", local_clients=[1, 2], **kw)
    assert tree_equal(tr_a.clients[1].params, tr_b.clients[1].params)
    assert not tree_equal(tr_a.clients[0].params, tr_a.clients[1].params)
    first = dict(tr_b.clients[2].params)
    tr_b.step(0)
    tr_b.reinit_client(2)
    assert tree_equal(tr_b.clients[2].params, first)


def test_legacy_scheme_stream_is_unchanged():
    """The legacy draw is one generator chained through the fleet,
    whatever ``local_clients`` says."""
    from repro_torch.core.runtime import init_fleet

    tr = make_trainer("prediction_topk", local_clients=[2],
                      comm=CommConfig(topk=8, horizon=4))
    want = init_fleet([c.bundle for c in tr.clients], 0, torch.device("cpu"))
    for c, w in zip(tr.clients, want):
        assert tree_equal(c.params, w)


@pytest.mark.parametrize("kw,match", [
    (dict(init_scheme="per_client"), "per_client"),
    (dict(local_clients=[0]), "prediction exchange"),
    (dict(init_scheme="bogus"), "init_scheme"),
])
def test_params_exchange_rejects_fleet_options(kw, match):
    with pytest.raises(ValueError, match=match):
        make_trainer("params", **kw)


def test_local_clients_out_of_range():
    with pytest.raises(ValueError, match="out of range"):
        make_trainer("prediction_topk", local_clients=[3],
                     comm=CommConfig(topk=8, horizon=4))


# -- the churn_ring preset against the reference ------------------------------

def churn_ring_cut(X, restart_from_snapshot=False, **train_kw):
    """`churn_ring` cut alike for both packages: 20 steps of the preset's
    120, its timeline (join, kill, restart, rewire at 20 / 40 / 70 / 90)
    scaled by the same 1/5 (4 / 8 / 14 / 18); the data, fleet, wire, gate
    and pool cadence as the preset's."""
    from test_torch_scheduler import cut_spec

    spec = cut_spec(X.get_preset("churn_ring"), 20, **train_kw)
    events = tuple(dataclasses.replace(
        ev, step=ev.step // 5,
        from_snapshot=(restart_from_snapshot if ev.kind == "restart"
                       else ev.from_snapshot))
        for ev in spec.churn.events)
    return dataclasses.replace(spec, churn=X.ChurnSpec(events=events))


def test_churn_ring_preset_matches_reference(monkeypatch):
    import repro.exp as RX

    from test_torch_exp import run_both
    from test_torch_scheduler import assert_fleet_run_matches

    ref, port = run_both(monkeypatch, churn_ring_cut(RX))
    assert_fleet_run_matches(ref, port)
    steps = port[0]
    assert [m["fleet/alive"] for m in steps] == \
        [4.0] * 4 + [5.0] * 4 + [4.0] * 6 + [5.0] * 6
    assert [m["fleet/epoch"] for m in steps] == \
        [0.0] * 4 + [1.0] * 4 + [2.0] * 6 + [3.0] * 4 + [4.0] * 2
    assert port[1].algorithm.churn.applied == \
        ref[1].algorithm.churn.applied == [
            "join(c4)@4", "kill(c1)@8", "restart(c1)@14 fresh", "rewire@18"]
    assert port[1].metrics["comm/tombstoned_bytes"] > 0


def test_churn_restart_from_snapshot_through_the_runner(tmp_path):
    """`Experiment.run()` with ``snapshot_every`` writes restorable fleet
    snapshots, and client 1, killed at 8, restarts at 14 from the newest
    snapshot that holds it (step 8's does not: it died before)."""
    import repro_torch.exp as PX

    spec = churn_ring_cut(PX, restart_from_snapshot=True,
                          snapshot_dir=str(tmp_path), snapshot_every=4)
    res = PX.Experiment(spec, device="cpu").run()
    assert snapshot_steps(str(tmp_path)) == [4, 8, 12, 16, 20]
    assert not (tmp_path / "step_0000000012" / "client_1.npz").exists()
    assert (tmp_path / "step_0000000008" / "client_1.npz").exists()
    assert res.algorithm.churn.applied[2] == \
        "restart(c1)@14 from snapshot step 8"
    assert res.metrics["comm/tombstoned_bytes"] > 0
    assert res.metrics["comm/delivered_bytes"] <= \
        res.metrics["comm/total_bytes"]
    assert any(k.startswith("c1/") for k in res.metrics)


# -- snapshots across the two packages ----------------------------------------

CROSS_T, CROSS_N = 4, 8


def reference_ring(bundles):
    """tests/test_comm.py's ``_make_trainer`` of the reference at PRED_KW's
    settings, on the given bundles."""
    from repro.comm import CommConfig as RefComm
    from repro.core import DecentralizedTrainer, MHDConfig, RunConfig
    from repro.core.graph import cycle_graph as ref_cycle
    from repro.data import (PartitionConfig, make_synthetic_vision,
                            partition_dataset)
    from repro.optim.optimizers import OptimizerConfig, make_optimizer

    ds = make_synthetic_vision(num_labels=8, samples_per_label=30,
                               image_size=8, noise=0.5, seed=0)
    part = partition_dataset(ds.labels, PartitionConfig(
        num_clients=4, num_labels=8, labels_per_client=2, skew=100.0,
        gamma_pub=0.2, seed=0))
    return DecentralizedTrainer(
        bundles, make_optimizer(OptimizerConfig(
            init_lr=0.05, total_steps=8, grad_clip_norm=1.0)),
        MHDConfig(nu_emb=1.0, nu_aux=1.0, num_aux_heads=1, delta=1,
                  pool_size=2, pool_update_every=2),
        RunConfig(steps=8, batch_size=8, public_batch_size=16,
                  eval_every=0, seed=0),
        {"images": ds.images, "labels": ds.labels}, part.client_indices,
        part.public_indices, ref_cycle(4), 8, exchange="prediction_topk",
        comm=RefComm(topk=8, val_dtype="float32", emb_encoding="float32",
                     horizon=12))


@pytest.fixture(scope="module")
def crossed(tmp_path_factory):
    """One reference and one port trainer (4-client ring, exact f32 wire)
    from the same init — the port's draw, given to the reference's
    bundles in its layout — stepped to T with a snapshot each, then on
    to N."""
    import jax.numpy as jnp

    import repro.fleet.snapshot as RS
    from repro.models.resnet import resnet_tiny as ref_resnet_tiny
    from repro.models.zoo import build_bundle as ref_build_bundle
    from repro_torch.checkpoint.io import params_to_jax
    from test_torch_exp import nested

    d = tmp_path_factory.mktemp("crossed")
    port = make_trainer("prediction_topk", **PRED_KW)
    ref = reference_ring([dataclasses.replace(
        ref_build_bundle(ref_resnet_tiny(8, num_aux_heads=1)),
        init=lambda _, p=nested({k: jnp.asarray(v) for k, v in
                                 params_to_jax(c.params).items()}): p)
        for c in port.clients])
    for t in range(CROSS_T):
        ref.step(t)
        port.step(t)
    RS.save_fleet(str(d / "ref"), CROSS_T, ref)
    save_fleet(str(d / "port"), CROSS_T, port)
    ref_tail = [ref.step(t) for t in range(CROSS_T, CROSS_N)]
    port_tail = [port.step(t) for t in range(CROSS_T, CROSS_N)]
    return {"dir": d, "ref": ref, "ref_tail": ref_tail,
            "port_tail": port_tail}


def as_plain(x):
    """A snapshot state with tensors as numpy and tuples as lists."""
    if isinstance(x, dict):
        return {str(k): as_plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [as_plain(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if hasattr(x, "__array__") and not isinstance(x, np.ndarray):
        return np.asarray(x)
    return x


def assert_state_equal(a, b, path="state"):
    a, b = as_plain(a), as_plain(b)
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            assert_state_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_state_equal(x, y, f"{path}/{i}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype and np.array_equal(a, b), path
    else:
        assert a == b, path


def assert_restored_from(trainer_state, load, directory, clients):
    """Every client's live state (the restoring package's own snapshot
    slice of it) equals the file the other package wrote."""
    step_dir = directory / f"step_{CROSS_T:010d}"
    for cid in clients:
        assert_state_equal(trainer_state(cid),
                           load(str(step_dir / f"client_{cid}.npz")),
                           f"client {cid}")


def test_reference_snapshot_restores_into_the_port(crossed):
    import repro.fleet.snapshot as RS
    import repro_torch.fleet.snapshot as PS
    from test_torch_exp import assert_step_metrics_close

    d = crossed["dir"]
    port = make_trainer("prediction_topk", **PRED_KW)
    assert restore_fleet(str(d / "ref"), port) == CROSS_T
    assert_restored_from(lambda cid: PS._decentralized_client_state(
        port, cid), RS._load_state, d / "ref", range(4))
    proc = RS._load_state(str(d / "ref" / f"step_{CROSS_T:010d}" /
                              "proc_all.npz"))
    assert_state_equal(port.rng.bit_generator.state, proc["rng"])
    assert_state_equal(port.meter.state_dict(), proc["meter"])
    assert_state_equal(port.bus.transport.state_dict(), proc["transport"])
    tail = [port.step(t) for t in range(CROSS_T, CROSS_N)]
    assert_step_metrics_close(crossed["ref_tail"], tail)


def test_port_snapshot_restores_into_the_reference(crossed):
    import repro.fleet.snapshot as RS
    import repro_torch.fleet.snapshot as PS
    from test_torch_exp import assert_step_metrics_close

    d, ref = crossed["dir"], crossed["ref"]
    # the reference trainer that wrote its own snapshot (its compiled
    # steps reused) is restored to the port's
    assert RS.restore_fleet(str(d / "port"), ref) == CROSS_T
    assert_restored_from(lambda cid: RS._decentralized_client_state(
        ref, cid), PS._load_state, d / "port", range(4))
    tail = [ref.step(t) for t in range(CROSS_T, CROSS_N)]
    assert_step_metrics_close(tail, crossed["port_tail"])


# -- the experiment API's fleet options ---------------------------------------

def _fleet_spec(**kw):
    from test_torch_exp import PX, tiny_spec

    return tiny_spec(
        PX, "mhd", {"pool_size": 2, "pool_update_every": 2},
        PX.ExperimentSpec.uniform_fleet(3, aux_heads=1), steps=8,
        wire=PX.WireSpec(exchange="prediction_topk", topk=4, horizon=8),
        **kw)


def _setup(spec, **bind):
    from test_torch_exp import PX

    algo = PX.make_algorithm(spec)
    algo.setup(dataclasses.replace(
        PX.Experiment(spec, device="cpu").build_bindings(), **bind))
    return algo


@pytest.mark.parametrize("mode", ["lockstep", "scoreboard"])
def test_adapter_snapshot_restores_into_a_fresh_adapter(tmp_path, mode):
    """`snapshot` / `restore_snapshot` on the MHD adapter under 4× rate
    skew, cut at wall 5: the restored adapter steps on bitwise."""
    from test_torch_exp import PX

    spec = dataclasses.replace(_fleet_spec(), schedule=PX.ScheduleSpec(
        mode=mode, rates=(1, 1, 4)))
    a = _setup(spec)
    full = [a.step(t) for t in range(8)]
    b = _setup(spec)
    for t in range(5):
        b.step(t)
    b.snapshot(str(tmp_path), 5)
    c = _setup(spec)
    assert c.restore_snapshot(str(tmp_path)) == 5
    assert c.scheduler.wall == 5 and c.scheduler.local_steps == [5, 5, 2]
    assert [c.step(t) for t in range(5, 8)] == full[5:]
    assert params_bitwise_equal(a.trainer.clients, c.trainer.clients)


def test_bindings_local_clients_drive_a_subset():
    algo = _setup(_fleet_spec(), local_clients=[0])
    assert algo.trainer.local_ids == [0]
    m = algo.step(0)
    assert "c0/loss" in m and "c1/loss" not in m


def test_spec_max_staleness_gates_teachers():
    from test_torch_exp import PX

    res = PX.Experiment(_fleet_spec(max_staleness=0), device="cpu").run()
    assert res.trainer.run_cfg.max_staleness == 0
    gates = res.trainer.meter.gate_summary()
    assert sum(g["stale"] for g in gates.values()) > 0
    assert res.metrics["c0/comm/stale_teachers"] > 0


def test_spec_per_client_init():
    from test_torch_exp import PX
    from repro_torch.core.runtime import client_generator

    spec = dataclasses.replace(_fleet_spec(), init_scheme="per_client")
    algo = _setup(spec)
    for c in algo.trainer.clients:
        assert tree_equal(c.params, c.bundle.init(
            client_generator(0, c.client_id)))
    assert PX.Experiment(spec, device="cpu").run().metrics
