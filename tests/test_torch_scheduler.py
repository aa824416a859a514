"""The port's fleet scheduler (`repro_torch.core.scheduler`) and staleness
gate: the cases of tests/test_scheduler.py on the port's trainer, and the
`gossip` preset through `Experiment.run()` against the JAX package's.

Within the port the anchors are bitwise: under equal rates, a lossless
zero-latency transport and unbounded staleness and run-ahead, lockstep
and scoreboard replay ``DecentralizedTrainer.step()`` exactly (metrics and
every param leaf); under rate skew the two policies equal each other.
Against the reference, both packages start from one seeded draw
(`test_torch_exp.same_initial_params`) and draw the same numpy streams:
step metrics within 2e-4 relative / 2e-5 absolute (CPU float32, two
frameworks' convolutions, f16 teacher values on the wire), the gate, mail
and schedule counts and the meter's books equal exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

import test_torch_threads

test_torch_threads.share_cores()

from repro_torch.comm import (CommConfig, LoopbackTransport,  # noqa: E402
                              PredictionBus, SimulatedNetwork)
from repro_torch.core import (AsyncScheduler, ScheduleConfig,  # noqa: E402
                              ScoreboardScheduler, run_async)
from repro_torch.core.graph import (chain_graph, cycle_graph,  # noqa: E402
                                    isolated_graph)


def make_trainer(exchange, K=3, labels=8, steps=10, delta=1, m=1,
                 pool_size=2, s_p=2, nu_emb=1.0, graph=None, bundles=None,
                 **kw):
    """tests/test_comm.py's ``_make_trainer`` on the port, on the CPU."""
    from repro_torch.core import DecentralizedTrainer, MHDConfig, RunConfig
    from repro_torch.core.graph import complete_graph
    from repro_torch.data import (PartitionConfig, make_synthetic_vision,
                                  partition_dataset)
    from repro_torch.models import build_bundle, resnet_tiny
    from repro_torch.optim import OptimizerConfig, make_optimizer

    ds = make_synthetic_vision(num_labels=labels, samples_per_label=30,
                               image_size=8, noise=0.5, seed=0)
    part = partition_dataset(ds.labels, PartitionConfig(
        num_clients=K, num_labels=labels, labels_per_client=2, skew=100.0,
        gamma_pub=0.2, seed=0))
    if bundles is None:
        bundles = [build_bundle(resnet_tiny(labels, num_aux_heads=m))
                   for _ in range(K)]
    opt = make_optimizer(OptimizerConfig(init_lr=0.05, total_steps=steps,
                                         grad_clip_norm=1.0))
    mhd = MHDConfig(nu_emb=nu_emb, nu_aux=1.0, num_aux_heads=m, delta=delta,
                    pool_size=pool_size, pool_update_every=s_p)
    return DecentralizedTrainer(
        bundles, opt, mhd,
        RunConfig(steps=steps, batch_size=8, public_batch_size=16,
                  eval_every=0, seed=0),
        {"images": ds.images, "labels": ds.labels},
        part.client_indices, part.public_indices,
        graph if graph is not None else complete_graph(K), labels,
        exchange=exchange, device="cpu", **kw)


def params_bitwise_equal(clients_a, clients_b) -> bool:
    for ca, cb in zip(clients_a, clients_b):
        if ca.params is None or cb.params is None:
            if ca.params is not cb.params:
                return False
            continue
        if ca.params.keys() != cb.params.keys() or not all(
                torch.equal(ca.params[k], cb.params[k]) for k in ca.params):
            return False
    return True


def _exact_kw(steps):
    return dict(steps=steps, delta=1, m=1, s_p=2,
                comm=CommConfig(topk=8, val_dtype="float32",
                                emb_encoding="float32", horizon=steps + 4))


# -- schedule config ----------------------------------------------------------

def test_schedule_config_validation():
    with pytest.raises(ValueError):
        ScheduleConfig(rates=())
    with pytest.raises(ValueError):
        ScheduleConfig(rates=(1, 0))
    with pytest.raises(ValueError):
        ScheduleConfig(rates=(1, 1.5))
    assert ScheduleConfig.uniform(3).rates == (1, 1, 1)
    assert ScheduleConfig.skewed(4, slow_rate=4).rates == (1, 1, 1, 4)
    assert ScheduleConfig.skewed(4, 4, num_slow=2).max_rate == 4


def test_scheduler_rejects_rate_count_mismatch():
    tr = make_trainer("params", K=3, steps=2)
    with pytest.raises(ValueError):
        AsyncScheduler(tr, ScheduleConfig(rates=(1, 1)))


# -- lockstep equivalence -----------------------------------------------------

def test_async_equals_sync_params_mode_bitwise():
    steps = 6
    t_sync = make_trainer("params", steps=steps, delta=2, m=1, s_p=2)
    t_async = make_trainer("params", steps=steps, delta=2, m=1, s_p=2)
    sched = AsyncScheduler(t_async)
    for t in range(steps):
        m_sync, m_async = t_sync.step(t), sched.tick()
        for key, v in m_sync.items():
            assert m_async[key] == v, (t, key)
    assert params_bitwise_equal(t_sync.clients, t_async.clients)


@pytest.mark.parametrize("policy", [AsyncScheduler, ScoreboardScheduler])
def test_scheduler_equals_sync_prediction_mode_bitwise(policy):
    """The anchor: equal rates, loopback, unbounded staleness and
    run-ahead — either policy replays the synchronous loop bitwise."""
    steps = 6
    t_sync = make_trainer("prediction_topk", **_exact_kw(steps))
    t_sched = make_trainer("prediction_topk", **_exact_kw(steps))
    sched = policy(t_sched, ScheduleConfig.uniform(3))
    for t in range(steps):
        m_sync, m_sched = t_sync.step(t), sched.tick()
        for key, v in m_sync.items():
            assert m_sched[key] == v, (t, key)
        assert m_sched[f"c0/local_step"] == t + 1
    assert params_bitwise_equal(t_sync.clients, t_sched.clients)
    assert t_sync.meter.total_bytes == t_sched.meter.total_bytes


def test_scoreboard_equals_lockstep_under_rate_skew_bitwise():
    ticks = 12
    kw = dict(K=3, steps=ticks, s_p=2, comm=CommConfig(topk=4, horizon=8))
    t_lock = make_trainer("prediction_topk", **kw)
    t_sb = make_trainer("prediction_topk", **kw)
    lock = AsyncScheduler(t_lock, ScheduleConfig(rates=(1, 1, 4)))
    sb = ScoreboardScheduler(t_sb, ScheduleConfig(rates=(1, 1, 4)))
    for _ in range(ticks):
        assert lock.tick() == sb.tick()
    assert lock.local_steps == sb.local_steps == [12, 12, 3]
    assert params_bitwise_equal(t_lock.clients, t_sb.clients)


def test_opt_step_is_the_local_step_count():
    """Under rate skew a client's optimizer and LR schedule advance with
    its own step count, its bus clock with the wall tick."""
    calls = []
    tr = make_trainer("prediction_topk", K=3, steps=8, s_p=2,
                      comm=CommConfig(topk=4, horizon=8))
    update = tr.optimizer.update

    def recording(grads, state, params, step):
        calls.append(step)
        return update(grads, state, params, step)

    tr.optimizer = tr.optimizer._replace(update=recording)
    sched = AsyncScheduler(tr, ScheduleConfig(rates=(1, 1, 4)))
    for _ in range(8):
        sched.tick()
    # per tick: c0, c1 every tick, c2 at walls 0 and 4 (its steps 0 and 1)
    assert calls[:3] == [0, 0, 0] and calls[3:5] == [1, 1]
    assert calls.count(1) == 3 and calls.count(7) == 2
    assert tr.bus.clock(2) == 4 and tr.bus.clock(0) == 7


# -- heterogeneous rates ------------------------------------------------------

def test_rate_skew_steps_clients_at_their_own_cadence():
    tr = make_trainer("params", K=3, steps=8)
    sched = AsyncScheduler(tr, ScheduleConfig(rates=(1, 1, 4)))
    seen_c2 = 0
    for w in range(8):
        m = sched.tick()
        assert ("c2/loss" in m) == (w % 4 == 0)
        seen_c2 += int("c2/loss" in m)
        assert "c0/loss" in m and "c1/loss" in m
    assert sched.local_steps == [8, 8, 2]
    assert seen_c2 == 2


def test_runahead_backpressure_gates_and_releases():
    tr = make_trainer("prediction_topk", K=3, steps=10, s_p=2,
                      comm=CommConfig(topk=4, horizon=12))
    sched = ScoreboardScheduler(tr, ScheduleConfig.uniform(3, runahead=4))
    sched.run_until_steps((100, 100, 2))
    assert sched.local_steps == [7, 7, 2]
    sched.run_until_steps((10, 10, 10))
    assert sched.local_steps == [10, 10, 10]
    assert sched.stats["backpressure_events"] > 0


def test_paced_straggler_is_overtaken_not_waited_on():
    tr = make_trainer("prediction_topk", K=3, steps=8, s_p=2,
                      comm=CommConfig(topk=4, horizon=12))
    sched = ScoreboardScheduler(
        tr, ScheduleConfig.uniform(3, pace_s=(0.0, 0.0, 0.25)))
    sched.run_until_steps((6, 6, 2))
    assert sched.local_steps == [6, 6, 2]
    assert sched.stats["overtakes"] > 0
    assert all(ts > 0.0 for ts in sched.resolved_at)


def test_scheduler_state_dict_roundtrip_and_legacy():
    rates = (1, 1, 4)
    kw = dict(K=3, steps=8, s_p=2, comm=CommConfig(topk=4, horizon=12))
    tr = make_trainer("prediction_topk", **kw)
    sched = AsyncScheduler(tr, ScheduleConfig(rates))
    for _ in range(6):
        sched.tick()
    state = sched.state_dict()
    assert state["mode"] == "lockstep" and state["wall"] == 6
    sched2 = AsyncScheduler(make_trainer("prediction_topk", **kw),
                            ScheduleConfig(rates))
    sched2.load_state_dict(state)
    assert sched2.state_dict() == state
    sched3 = AsyncScheduler(make_trainer("prediction_topk", **kw),
                            ScheduleConfig(rates))
    sched3.load_state_dict({"wall": 6, "local_steps": [6, 6, 2]})
    assert sched3.state_dict() == state


def test_rate_skewed_lossy_run_completes_with_metrics():
    net = SimulatedNetwork(latency=1, bandwidth=32 * 1024, drop_prob=0.25,
                           seed=3, client_rates={2: 4})
    tr = make_trainer("prediction_topk", K=3, steps=16, s_p=2,
                      graph=cycle_graph(3),
                      comm=CommConfig(topk=4, horizon=4), transport=net)
    tr.run_cfg.max_staleness = 5
    with pytest.warns(UserWarning, match="publish gap"):
        sched = AsyncScheduler(tr, ScheduleConfig(rates=(1, 1, 4)))
    for _ in range(16):
        m = sched.tick()
        for key in ("loss", "stale_skipped", "mail_staleness"):
            assert f"c0/{key}" in m
        assert np.isfinite(m["c0/loss"])
    assert sum(tr.meter.gate_stale.values()) > 0
    report = sched.freshness_report()
    assert report[2]["clock"] == 12.0
    assert report[0]["clock"] == 15.0
    assert all(r["fresh"] <= r["mailbox"] for r in report.values())


# -- bounded staleness --------------------------------------------------------

@pytest.mark.parametrize("graph_fn", [chain_graph, cycle_graph,
                                      isolated_graph])
def test_stale_mail_falls_back_to_supervised(graph_fn):
    tr = make_trainer("prediction_topk", K=3, steps=6, s_p=2,
                      graph=graph_fn(3), comm=CommConfig(topk=4, horizon=8),
                      transport=SimulatedNetwork(latency=2, seed=0))
    tr.run_cfg.max_staleness = 0
    sched = AsyncScheduler(tr)
    for _ in range(6):
        m = sched.tick()
        for cid in range(3):
            assert m[f"c{cid}/distill_active"] == 0.0
            assert np.isfinite(m[f"c{cid}/loss"])


@pytest.mark.parametrize("graph_fn", [chain_graph, cycle_graph,
                                      isolated_graph])
def test_unbounded_staleness_never_crashes(graph_fn):
    tr = make_trainer("prediction_topk", K=3, steps=6, s_p=2,
                      graph=graph_fn(3), comm=CommConfig(topk=4, horizon=8),
                      transport=SimulatedNetwork(drop_prob=0.5, seed=1))
    sched = run_async(tr, 6)
    assert sched.wall == 6


def test_params_mode_staleness_gate():
    tr = make_trainer("params", K=3, steps=8, s_p=100)
    tr.run_cfg.max_staleness = 2
    sched = AsyncScheduler(tr)
    m = None
    for _ in range(6):
        m = sched.tick()
    assert all(m[f"c{cid}/distill_active"] == 0.0 for cid in range(3))
    assert sum(m[f"c{cid}/stale_skipped"] for cid in range(3)) > 0


def test_freshness_report_explicit_none_requests_unbounded_view():
    tr = make_trainer("prediction_topk", K=2, steps=4, s_p=2,
                      comm=CommConfig(topk=4, horizon=8),
                      transport=SimulatedNetwork(latency=1, seed=0))
    tr.run_cfg.max_staleness = 0
    sched = AsyncScheduler(tr)
    for _ in range(4):
        sched.tick()
    bounded = sched.freshness_report()
    unbounded = sched.freshness_report(None)
    for cid in range(2):
        assert bounded[cid]["mailbox"] > 0
        assert bounded[cid]["fresh"] == 0.0
        assert unbounded[cid]["fresh"] == unbounded[cid]["mailbox"]


# -- bus clocks and the staleness sentinel ------------------------------------

def test_bus_clocks_poll_fresh_and_sentinel():
    bus = PredictionBus(LoopbackTransport(), [(1,), (0,)], 2)
    assert bus.clock(0) == 0
    assert bus.staleness(0, 0) == bus.EMPTY_STALENESS == -1.0
    bus.advance(0, 5)
    bus.advance(0, 3)  # a stale advance is a no-op
    assert bus.clock(0) == 5
    bus.publish(1, b"m", step=2)
    bus.deliver(2)
    bus.advance(0, 10)
    assert set(bus.poll_fresh(0, None)) == {1}
    assert set(bus.poll_fresh(0, 8)) == {1}
    assert bus.poll_fresh(0, 7) == {}
    assert bus.poll_fresh(1, 0) == {}
    assert bus.staleness(0, 13) == 11.0
    assert bus.staleness(1, 3) == -1.0


def test_runtime_reports_sentinel_for_mailless_client():
    tr = make_trainer("prediction_topk", K=3, steps=2, s_p=2,
                      graph=chain_graph(3), comm=CommConfig(topk=4, horizon=4))
    m = tr.step(0)
    assert m["c2/mail_staleness"] == -1.0
    assert m["c0/mail_staleness"] >= 0.0


# -- the gossip preset against the reference ----------------------------------

GOSSIP_TICKS = 24


def cut_spec(spec, steps, **train_kw):
    """A preset cut alike for both packages: fewer steps; its data,
    widths, fleet, wire, transport and schedule as they are."""
    return dataclasses.replace(
        spec, train=dataclasses.replace(spec.train, steps=steps, **train_kw))


EXACT_KEYS = ("stale_skipped", "distill_active", "mail_staleness",
              "local_step", "fleet/alive", "fleet/epoch")


def assert_fleet_run_matches(ref, port):
    """Step metrics within the stated tolerances, the gate, mail, clock
    and fleet counts and the meter's books equal."""
    from test_torch_exp import assert_step_metrics_close

    (ref_steps, ref_res), (port_steps, port_res) = ref, port
    assert_step_metrics_close(ref_steps, port_steps,
                              batch=ref_res.spec.train.batch_size)
    for t, (mj, mp) in enumerate(zip(ref_steps, port_steps)):
        for k in mj:
            if k.endswith(EXACT_KEYS):
                assert mp[k] == mj[k], (t, k)
    for k in ref_res.metrics:
        if k.startswith("comm/") or k.endswith("_teachers"):
            assert port_res.metrics[k] == ref_res.metrics[k], k
    mj, mp = ref_res.trainer.meter, port_res.trainer.meter
    assert dict(mp.by_edge) == dict(mj.by_edge)
    assert dict(mp.by_edge_delivered) == dict(mj.by_edge_delivered)
    assert mp.gate_summary() == mj.gate_summary()


def test_gossip_preset_matches_reference(monkeypatch):
    """`gossip` (4 clients on a lossy ring, client 3 a 4× straggler with a
    4× slower uplink, the staleness gate at 30) for 24 wall ticks under
    its lockstep schedule, against the reference; then the same spec
    under the scoreboard, bitwise equal to the port's lockstep run (no
    pace or run-ahead gate: the scoreboard issues in key order)."""
    import repro.exp as RX

    from test_torch_exp import PX, run_both

    spec = cut_spec(RX.get_preset("gossip"), GOSSIP_TICKS)
    ref, port = run_both(monkeypatch, spec)
    assert_fleet_run_matches(ref, port)
    sched_j, sched_p = ref[1].scheduler, port[1].scheduler
    assert sched_p.mode == sched_j.mode == "lockstep"
    assert sched_p.local_steps == sched_j.local_steps == [24, 24, 24, 6]
    assert sched_p.freshness_report() == sched_j.freshness_report()
    meter = port[1].trainer.meter
    assert meter.delivered_bytes < meter.total_bytes  # the ring drops mail
    assert sum(m.get("c0/distill_active", 0.0) for m in port[0]) > 0

    board = PX.ExperimentSpec.from_json(spec.to_json())
    board = dataclasses.replace(board, schedule=dataclasses.replace(
        board.schedule, mode="scoreboard"))
    steps = []
    res = PX.Experiment(board, device="cpu").run(
        on_step=lambda t, m: steps.append(m))
    assert res.scheduler.mode == "scoreboard"
    assert steps == port[0]
    assert res.metrics == port[1].metrics
    assert params_bitwise_equal(res.trainer.clients, port[1].trainer.clients)


@pytest.mark.parametrize("mode", ["lockstep", "async", "scoreboard"])
def test_experiment_schedules_equal_sync(mode):
    """Through `Experiment.run()`, every non-sync schedule at equal rates
    on the loopback and an exact wire is the sync run, bitwise (plus each
    client's ``local_step``)."""
    from test_torch_exp import PX, tiny_spec

    def run(schedule):
        spec = tiny_spec(
            PX, "mhd", {"pool_size": 2, "pool_update_every": 2},
            PX.ExperimentSpec.uniform_fleet(2, aux_heads=1), steps=5,
            schedule=schedule, wire=PX.WireSpec(
                exchange="prediction_topk", topk=6, val_dtype="float32",
                emb_encoding="float32", horizon=8))
        steps = []
        res = PX.Experiment(spec, device="cpu").run(
            on_step=lambda t, m: steps.append(m))
        return steps, res

    sync_steps, sync = run(PX.ScheduleSpec())
    steps, res = run(PX.ScheduleSpec(mode=mode))
    assert sync.scheduler is None
    assert res.scheduler.mode == ("scoreboard" if mode == "scoreboard"
                                  else "lockstep")
    for t, (a, b) in enumerate(zip(sync_steps, steps)):
        assert {k: v for k, v in b.items()
                if not k.endswith("local_step")} == a, t
        assert b["c1/local_step"] == t + 1
    assert res.metrics == sync.metrics
    assert params_bitwise_equal(res.trainer.clients, sync.trainer.clients)
