"""The port's experiment API (`repro_torch.exp`) against the JAX package's
(`repro.exp`): the same specs to the byte, the same rejections, and the
same MHD runs through `Experiment.run()` (the `lm_hetero` fleet of an SSM,
a dense transformer and an MoE transformer among them, run for its own 30
steps and held step by step over the first 10).

The MHD runs start both packages from the same initial params (one seeded
draw, carried into the reference's layout by `params_to_jax` through a
wrapped `build_bundles`); both then draw the same numpy streams in the
same order. Stated tolerances, as tests/test_torch_runtime.py's:
every step metric within 2e-4 relative / 2e-5 absolute over 6 steps (CPU
float32, two frameworks' convolutions; the top-k wire rounds teacher
values to f16), teacher fractions as equal counts; every eval metric
(argmax accuracies on 90 test images) equal.
"""
import dataclasses
import json

import numpy as np
import pytest

import test_torch_threads

test_torch_threads.share_cores()

import repro.exp as RX  # noqa: E402
import repro_torch.exp as PX  # noqa: E402

STEPS, K = 6, 2
RTOL, ATOL = 2e-4, 2e-5


def tiny_spec(X, algo="mhd", params=None, clients=None, *, steps=4,
              eval_every=0, schedule=None, wire=None, **train_kw):
    """tests/test_experiment.py's ``tiny_spec``, built from the classes of
    the package ``X`` (``repro.exp`` or ``repro_torch.exp``)."""
    return X.ExperimentSpec(
        name="tiny",
        algorithm=X.AlgorithmSpec(algo, params or {}),
        data=X.DataSpec(num_labels=6, samples_per_label=30),
        partition=X.PartitionSpec(labels_per_client=3, gamma_pub=0.15),
        clients=clients or X.ExperimentSpec.uniform_fleet(2),
        schedule=schedule or X.ScheduleSpec(),
        wire=wire or X.WireSpec(),
        optimizer=X.OptimizerSpec(init_lr=0.05, total_steps=steps),
        train=X.TrainSpec(steps=steps, batch_size=16, public_batch_size=16,
                          eval_every=eval_every, **train_kw))


def nested(flat):
    """A flat ``{"a/b": array}`` dict as the nested dicts of a JAX tree."""
    out = {}
    for k, v in flat.items():
        *parents, leaf = k.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def same_initial_params(monkeypatch, spec):
    """Both packages' runners build bundles whose init returns one seeded
    draw (client i: the port's init from generator seed 100 + i), carried
    into the reference's layout by `params_to_jax`: bundle i → params i,
    whatever key or generator the trainer hands it. The reference's own
    `jax.random` draws are not replayed (torch cannot), and skipping them
    skips their per-shape compiles."""
    import jax.numpy as jnp
    import torch

    import repro.exp.runner as ref_runner
    import repro_torch.exp.runner as port_runner
    from repro_torch.checkpoint.io import params_to_jax

    port_spec = PX.ExperimentSpec.from_json(spec.to_json())
    draws = [b.init(torch.Generator().manual_seed(100 + i))
             for i, b in enumerate(port_runner.build_bundles(port_spec))]

    def patch(runner, as_init):
        build = runner.build_bundles
        monkeypatch.setattr(runner, "build_bundles", lambda sp: [
            dataclasses.replace(b, init=lambda _, p=as_init(p): p())
            for b, p in zip(build(sp), draws)])

    patch(ref_runner, lambda p: lambda: nested(
        {k: jnp.asarray(v) for k, v in params_to_jax(p).items()}))
    patch(port_runner, lambda p: lambda: {k: v.clone()
                                          for k, v in p.items()})


def run_both(monkeypatch, spec):
    """The reference's and the port's `Experiment.run()` on one spec, from
    the same initial params: ((step metrics, result) reference, (step
    metrics, result) port)."""
    same_initial_params(monkeypatch, spec)
    out = []
    for X, kw in ((RX, {}), (PX, {"device": "cpu"})):
        steps = []
        res = X.Experiment(X.ExperimentSpec.from_json(spec.to_json()),
                           **kw).run(on_step=lambda t, m: steps.append(m))
        out.append((steps, res))
    return out


def assert_step_metrics_close(ref_steps, port_steps, batch=16):
    assert len(ref_steps) == len(port_steps)
    for t, (mj, mp) in enumerate(zip(ref_steps, port_steps)):
        assert mj.keys() == mp.keys(), t
        for k in mj:
            if k.endswith(("_frac", "/acc")):
                assert round(mp[k] * batch) == round(mj[k] * batch), (t, k)
            elif k.endswith(("distill_active", "stale_skipped",
                             "mail_staleness", "fedavg/averaged")):
                assert mp[k] == mj[k], (t, k)
            else:
                np.testing.assert_allclose(mp[k], mj[k], rtol=RTOL,
                                           atol=ATOL, err_msg=f"{k} @ {t}")


def assert_history_equal(ref_res, port_res):
    assert [t for t, _ in ref_res.history] == [t for t, _ in port_res.history]
    for (_, ej), (_, ep) in zip(ref_res.history, port_res.history):
        assert ej.keys() == ep.keys()
        for k in ej:
            assert ep[k] == pytest.approx(ej[k], abs=1e-9), k


# -- specs -------------------------------------------------------------------


@pytest.mark.parametrize("name", RX.preset_names())
def test_preset_json_is_the_references(name):
    spec = PX.get_preset(name)
    assert spec.to_json() == RX.get_preset(name).to_json()
    assert PX.ExperimentSpec.from_json(spec.to_json()) == spec


def test_public_names_and_registries_are_the_references():
    assert sorted(PX.__all__) == sorted(RX.__all__)
    assert PX.preset_names() == RX.preset_names()
    assert PX.CLIENT_ARCHS.names() == RX.CLIENT_ARCHS.names()
    assert PX.TRANSPORTS.names() == RX.TRANSPORTS.names()
    assert PX.ALGORITHMS.names() == RX.ALGORITHMS.names()


def test_spec_json_roundtrip_heterogeneous():
    def spec(X):
        return X.ExperimentSpec(
            name="rt",
            algorithm=X.AlgorithmSpec("mhd", {"nu_aux": 2.0,
                                              "pool_size": 3}),
            data=X.DataSpec(num_labels=10, samples_per_label=50, noise=1.5),
            partition=X.PartitionSpec(labels_per_client=2,
                                      assignment="even", skew=10.0, seed=7),
            clients=(X.ClientSpec("resnet_tiny", aux_heads=2),
                     X.ClientSpec("resnet_tiny34", aux_heads=2, width=16),
                     X.ClientSpec("resnet_tiny", aux_heads=2)),
            topology=X.TopologySpec("cycle", hops=2),
            schedule=X.ScheduleSpec(mode="async", rates=(1, 4, 2)),
            transport=X.TransportSpec(kind="simulated", latency=2,
                                      bandwidth=4096, drop_prob=0.25, seed=3,
                                      client_rates={1: 4, 2: 2}),
            wire=X.WireSpec(exchange="prediction_topk", topk=5, horizon=20),
            optimizer=X.OptimizerSpec(init_lr=0.1, grad_clip_norm=1.0),
            train=X.TrainSpec(steps=40, eval_every=10, max_staleness=30,
                              seed=5))

    text = spec(PX).to_json()
    assert text == spec(RX).to_json()
    restored = PX.ExperimentSpec.from_json(text)
    assert restored == spec(PX)
    assert isinstance(restored.clients, tuple)
    assert isinstance(restored.schedule.rates, tuple)
    assert all(isinstance(k, int) for k in restored.transport.client_rates)


def _no_public_pool(X):
    d = json.loads(tiny_spec(X).to_json())
    d["partition"]["gamma_pub"] = 0.0
    return X.ExperimentSpec.from_dict(d)


def _unknown_field(X):
    d = json.loads(tiny_spec(X).to_json())
    d["train"]["warp_factor"] = 9
    return X.ExperimentSpec.from_dict(d)


def _short_horizon(X, horizon):
    base = tiny_spec(X, "mhd", {"pool_update_every": 4},
                     schedule=X.ScheduleSpec(mode="async", rates=(1, 4)))
    return dataclasses.replace(
        base, transport=X.TransportSpec(kind="simulated"),
        wire=X.WireSpec(exchange="prediction_topk", topk=4,
                        horizon=horizon)).validate()


HET = ("resnet_tiny", "resnet_tiny34")

# tests/test_experiment.py's rejection cases: (X, run) -> raises, where run
# is the package's `Experiment(spec).run()`
REJECTIONS = {
    "unknown_field": (lambda X, run: _unknown_field(X), "warp_factor"),
    "unknown_arch": (lambda X, run: tiny_spec(
        X, clients=(X.ClientSpec("resnet_huge"),)).validate(),
        "unknown client arch"),
    "rates_count": (lambda X, run: tiny_spec(X, schedule=X.ScheduleSpec(
        mode="async", rates=(1, 1, 1))).validate(), "rates"),
    "short_horizon": (lambda X, run: _short_horizon(X, 8), "publish gap"),
    "auto_horizon": (lambda X, run: _short_horizon(X, 0), "publish gap"),
    "pace_count": (lambda X, run: tiny_spec(X, schedule=X.ScheduleSpec(
        mode="scoreboard", pace_ms=(1.0,))).validate(), "pace_ms"),
    "runahead": (lambda X, run: tiny_spec(X, schedule=X.ScheduleSpec(
        mode="scoreboard", runahead=0)).validate(), "runahead"),
    "sync_knob": (lambda X, run: tiny_spec(X, schedule=X.ScheduleSpec(
        mode="sync", runahead=4)).validate(), "sync"),
    "schedule_mode": (lambda X, run: tiny_spec(X, schedule=X.ScheduleSpec(
        mode="warp")).validate(), "unknown schedule mode"),
    "sync_rates": (lambda X, run: tiny_spec(X, schedule=X.ScheduleSpec(
        mode="sync", rates=(1, 1))).validate(), "rates"),
    "param_typo_run": (lambda X, run: run(tiny_spec(
        X, params={"nu_typo": 1.0})), "nu_typo"),
    "param_typo_make": (lambda X, run: X.make_algorithm(tiny_spec(
        X, params={"nu_typo": 1.0})), "nu_typo"),
    "scope_typo": (lambda X, run: X.make_algorithm(tiny_spec(
        X, "supervised", params={"scoop": "pooled"})), "scoop"),
    "fedavg_async": (lambda X, run: run(tiny_spec(
        X, "fedavg", schedule=X.ScheduleSpec(mode="async"))), "async"),
    "fedavg_het": (lambda X, run: run(tiny_spec(
        X, "fedavg", clients=tuple(X.ClientSpec(a) for a in HET))),
        "identical"),
    "pooled_het": (lambda X, run: run(tiny_spec(
        X, "supervised", {"scope": "pooled"},
        clients=tuple(X.ClientSpec(a) for a in HET))), "pooled"),
    "no_public_pool": (lambda X, run: run(_no_public_pool(X)), "gamma_pub"),
    "mixed_heads": (lambda X, run: run(tiny_spec(
        X, "mhd", {"pool_size": 2, "pool_update_every": 2},
        clients=(X.ClientSpec("resnet_tiny", aux_heads=2),
                 X.ClientSpec("resnet_tiny", aux_heads=1)))), "aux heads"),
    "fedmd_transport": (lambda X, run: run(dataclasses.replace(
        tiny_spec(X, "fedmd"),
        transport=X.TransportSpec(kind="simulated", drop_prob=0.9))),
        "transport"),
    "supervised_staleness": (lambda X, run: run(tiny_spec(
        X, "supervised", max_staleness=10)), "max_staleness"),
}


@pytest.mark.parametrize("case", sorted(REJECTIONS))
def test_rejections_match_reference(case):
    act, match = REJECTIONS[case]
    raised = []
    for X, kw in ((RX, {}), (PX, {"device": "cpu"})):
        with pytest.raises(Exception, match=match) as info:
            act(X, lambda spec: X.Experiment(spec, **kw).run())
        raised.append(type(info.value))
    assert raised[0] is raised[1] is ValueError, raised


def test_registry_capabilities():
    for name in ("mhd", "fedmd", "fedavg", "supervised"):
        assert name in PX.ALGORITHMS
        ref = RX.ALGORITHMS.get(name)(tiny_spec(RX, name)).capabilities
        port = PX.ALGORITHMS.get(name)(tiny_spec(PX, name)).capabilities
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), name


# -- runs --------------------------------------------------------------------


@pytest.mark.parametrize("exchange", ["params", "prediction_topk"])
def test_mhd_experiment_matches_reference(monkeypatch, exchange):
    """Experiment.run() on an MHD spec (K=2 resnet_tiny, 6 steps, eval
    every 3) in both packages: the same step metrics and eval history."""
    wire = (RX.WireSpec(exchange=exchange, topk=4, horizon=2)
            if exchange != "params" else None)
    spec = tiny_spec(
        RX, "mhd", {"pool_size": K, "pool_update_every": 2, "delta": 1,
                    "nu_emb": 1.0, "nu_aux": 1.0},
        clients=RX.ExperimentSpec.uniform_fleet(K, aux_heads=1),
        steps=STEPS, eval_every=3, wire=wire)
    (ref_steps, ref), (port_steps, port) = run_both(monkeypatch, spec)
    assert_step_metrics_close(ref_steps, port_steps)
    assert_history_equal(ref, port)
    assert port.metrics.keys() == ref.metrics.keys()
    for k in ref.metrics:
        if k.startswith("comm/") or k.endswith("_teachers"):
            assert port.metrics[k] == ref.metrics[k], k
    json.dumps(port.to_payload())
    assert port.trainer is not None and port.us_per_step > 0


def test_experiment_defaults_to_the_card():
    import torch

    spec = tiny_spec(PX)
    if torch.cuda.is_available():
        assert PX.Experiment(spec).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PX.Experiment(spec)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PX.run_spec(spec)
    assert PX.Experiment(spec, device="cpu").device.type == "cpu"


def _run_cpu(spec):
    return PX.Experiment(spec, device="cpu").run()


def _roofline():
    """The distill update's roofline, ported since: after a short CPU run,
    each bundle's update counted on meta copies of its arguments."""
    from repro_torch.obs import collect_obs

    res = _run_cpu(tiny_spec(PX, "mhd", {"pool_size": 1,
                                         "pool_update_every": 2},
                             PX.ExperimentSpec.uniform_fleet(2, aux_heads=1),
                             steps=2))
    rows = collect_obs(trainer=res.algorithm.trainer,
                       with_roofline=True).roofline
    assert rows
    for row in rows.values():
        assert row["flops"] > 0 and row["bytes"] > 0
        assert row["attainable_flops_per_s"] > 0


def _gemma_cut():
    from repro_torch.configs import get_config

    cfg = get_config("gemma3-12b")
    stages = tuple(dataclasses.replace(st, repeats=1) for st in cfg.stages)
    return {"stages": stages, "num_layers": sum(len(st.block)
                                                for st in stages)}


def _dryrun_mhd():
    """The reference's MHD dry run partitions each pod's layers on its
    2×16×16 mesh; so does the port's (it counted one pod rank's step with
    its leaves whole and raised on ``--multi-pod`` before the sharding
    within a pod, item 15c): gemma3-12b cut in depth, rank 0 of the
    2×16×16 mesh, its leaves cut by the rules, the exchange booked."""
    from repro_torch.launch.dryrun import dryrun_mhd

    rec = dryrun_mhd("gemma3-12b", overrides=_gemma_cut(), exchange="topk",
                     verbose=False)
    assert (rec["status"], rec["mesh"], rec["chips"]) == (
        "ok", "2x16x16-mhd", 512)
    assert rec["collective_bytes_raw"]["collective-permute"] > 0
    assert rec["collective_bytes_raw"]["all-gather"] > 0


def _dryrun_multi_pod():
    """``--multi-pod`` counts rank 0 of the 2×16×16 mesh (it raised naming
    item 15c before): mamba2-370m at full width and depth."""
    import json
    import tempfile

    from repro_torch.launch.dryrun import main

    with tempfile.TemporaryDirectory() as out:
        assert main(["--multi-pod", "--arch", "mamba2-370m", "--shape",
                     "train_4k", "--out", out]) == 0
        with open(f"{out}/mamba2-370m__train_4k__2x16x16.json") as f:
            rec = json.load(f)
    assert (rec["status"], rec["mesh"], rec["chips"]) == (
        "ok", "2x16x16", 512)


def _mla():
    """MLA, ported since: reduced arctic-480b with MLA attention builds
    and its bundle's loss runs (the full deepseek-v3 widths of
    ``MLAConfig()``, 128 heads, on its 2 layers)."""
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.models import build_bundle
    from repro_torch.models.config import MLAConfig

    cfg = dataclasses.replace(get_reduced("arctic-480b"), num_heads=128,
                              mla=MLAConfig())
    bundle = build_bundle(cfg)
    params = bundle.init(torch.Generator().manual_seed(0))
    assert params["stage0/layer0/attn/w_uk"].shape == (2, 512, 128, 128)
    tokens = torch.randint(0, cfg.vocab_size, (1, 8),
                           generator=torch.Generator().manual_seed(1))
    loss, metrics = bundle.loss(params, {"tokens": tokens})
    assert torch.isfinite(loss) and set(metrics) == {"ce", "aux_loss"}


def _cross():
    """Cross attention, ported since: reduced arctic-480b with two gated
    cross-attention layers builds and its bundle's loss runs (no vision
    front end: K and V from the layer's input)."""
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.models import build_bundle
    from repro_torch.models.config import LayerSpec, uniform_stages

    cfg = dataclasses.replace(get_reduced("arctic-480b"),
                              stages=uniform_stages(2, LayerSpec(
                                  attn="cross", ffn="none")))
    bundle = build_bundle(cfg)
    params = bundle.init(torch.Generator().manual_seed(0))
    assert params["stage0/layer0/cross_gate"].shape == (2,)
    params = {k: torch.full_like(v, 0.5) if k.endswith("cross_gate") else v
              for k, v in params.items()}
    tokens = torch.randint(0, cfg.vocab_size, (1, 8),
                           generator=torch.Generator().manual_seed(1))
    loss, metrics = bundle.loss(params, {"tokens": tokens})
    assert torch.isfinite(loss) and set(metrics) == {"ce", "aux_loss"}


# features deferred once and ported since: each builds and runs (the port
# defers none of the reference's features now)
PORTED_SINCE = {
    "mla": _mla,
    "cross_attention": _cross,
    "roofline": _roofline,
    "dryrun_mhd": _dryrun_mhd,
    "--multi-pod": _dryrun_multi_pod,
}


@pytest.mark.parametrize("case", sorted(PORTED_SINCE))
def test_features_ported_since_run(case):
    PORTED_SINCE[case]()


def test_gossip_socket_runs_and_closes_its_listeners():
    """`gossip_socket` over one in-process socket transport hosting the
    whole fleet: every client distills, delivered == offered, and the
    runner closes the listeners when the loop is over."""
    spec = PX.get_preset("gossip_socket")
    spec = dataclasses.replace(spec, train=dataclasses.replace(
        spec.train, steps=4))
    res = _run_cpu(spec)
    sock = res.transport
    assert type(sock).__name__ == "SocketTransport"
    assert sock._closed and all(srv.fileno() == -1
                                for srv in sock._listeners.values())
    m = res.metrics
    assert m["comm/delivered_bytes"] == m["comm/total_bytes"] > 0
    assert m["comm/drain_stalls"] == 0.0
    assert all(m[f"c{i}/comm/fresh_teachers"] > 0 for i in range(4))


# lm_hetero's step metrics are held over its first two publish rounds
# (S_P = 5): past them the two frameworks' float32 sums drift beyond 2e-4
# (c0/ce at step 11, 2.8e-4), while the teacher schedule and the wire's
# books stay exact over all 30 steps
LM_HETERO_PARITY_STEPS = 10

# the shapes each kernel wrapper is called at: the call's args -> a key
_KERNEL_KEYS = {
    "ssd_scan": lambda x, dt, A, B, C, D, chunk: (
        (*x.shape, B.shape[-1]), chunk),
    "flash_attention": lambda q, k, v, causal, window, softcap=0.0: (
        (*q.shape[:2], k.shape[1], q.shape[2], k.shape[2], q.shape[3]),
        window),
    "topk_wire": lambda x, k: (*x.shape, k),
    "dist_ce": lambda s, t: tuple(s.shape),
}


@pytest.fixture(scope="module")
def lm_hetero_runs():
    """`lm_hetero` (an SSM, a dense transformer and a MoE on the adaptive
    delta wire over a socket transport) through both packages'
    `Experiment.run()` from the same initial params, at its own 30 steps,
    once for the module; the port's socket transport is recorded as it
    is built, and the shapes each of its kernel wrappers is called at."""
    import repro_torch.comm as comm
    from repro_torch.kernels import ops

    made, shapes = [], {name: set() for name in _KERNEL_KEYS}

    class Recording(comm.SocketTransport):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    def recording(name, fn):
        def call(*a, **kw):
            shapes[name].add(_KERNEL_KEYS[name](*a, **kw))
            return fn(*a, **kw)
        return call

    spec = RX.get_preset("lm_hetero")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(comm, "SocketTransport", Recording)
        for name in _KERNEL_KEYS:
            mp.setattr(ops, name, recording(name, getattr(ops, name)))
        runs = run_both(mp, spec)
    return runs, made, shapes


def test_lm_hetero_matches_reference(lm_hetero_runs):
    """Every step metric of the three clients over the first two publish
    rounds within 2e-4 / 2e-5 of the reference's (the MoE client's
    ``loss`` carries its routers' load-balance loss, about 0.02 at 0.01 a
    layer), the teacher schedule and the wire's books after 30 steps
    equal; every client distills."""
    ((ref_steps, ref), (port_steps, port)), _, _ = lm_hetero_runs
    assert len(ref_steps) == len(port_steps) == 30
    n = LM_HETERO_PARITY_STEPS
    assert_step_metrics_close(ref_steps[:n], port_steps[:n])
    assert port.metrics.keys() == ref.metrics.keys()
    for k in ref.metrics:
        if k.startswith("comm/") or k.endswith("_teachers"):
            assert port.metrics[k] == ref.metrics[k], k
    for i in range(3):
        assert sum(m[f"c{i}/distill_active"] for m in port_steps) > 0, i


def test_lm_hetero_runs_and_closes_its_listeners(lm_hetero_runs):
    """The port's `lm_hetero` run hosts the fleet on one in-process socket
    transport, delivers everything it offered, and closes its listeners
    when the loop is over."""
    ((_, _), (_, port)), made, _ = lm_hetero_runs
    assert PX.get_preset("lm_hetero").transport.kind == "socket"
    assert made == [port.transport]
    sock = port.transport
    assert sock._closed and all(srv.fileno() == -1
                                for srv in sock._listeners.values())
    m = port.metrics
    assert m["comm/delivered_bytes"] == m["comm/total_bytes"] > 0
    assert m["comm/drain_stalls"] == 0.0


def test_lm_hetero_schedule_is_chip_smokes(lm_hetero_runs):
    """chip_smoke.py holds the teacher schedule of the port's `lm_hetero`
    run on the card against `REFERENCE_DISTILLED_HETERO`: both packages
    give it on the CPU."""
    import chip_smoke as CS

    ((ref_steps, _), (port_steps, _)), _, _ = lm_hetero_runs
    for steps in (ref_steps, port_steps):
        assert [[int(m[f"c{i}/distill_active"]) for m in steps]
                for i in range(3)] == CS.REFERENCE_DISTILLED_HETERO


def test_lm_hetero_kernel_shapes_are_chip_smokes(lm_hetero_runs):
    """chip_smoke.py holds each kernel against its plain version at
    `hetero_shapes()`, derived from the spec: those are the shapes the
    port's `lm_hetero` run calls each kernel wrapper at."""
    import chip_smoke as CS

    _, _, shapes = lm_hetero_runs
    want = CS.hetero_shapes()
    assert shapes == {"ssd_scan": set(want["ssd"]),
                      "flash_attention": set(want["flash"]),
                      "topk_wire": {want["topk"]},
                      "dist_ce": {want["dist_ce"]}}


def test_port_quickstart_runs_the_reference_quickstarts_spec():
    """examples/port_quickstart.py's `build_spec()` is the spec that
    examples/quickstart.py hands to `repro.exp.Experiment` (caught here
    in place of running it), to the byte."""
    import importlib.util
    import os

    root = os.path.join(os.path.dirname(__file__), "..", "examples")
    mods = {}
    for name in ("quickstart", "port_quickstart"):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(root, f"{name}.py"))
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    caught = []

    class Caught:
        def __init__(self, spec):
            caught.append(spec)

        def run(self, on_step=None):
            return type("R", (), {"metrics": dict.fromkeys(
                [f"mean/{h}/{b}" for h in mods["port_quickstart"].HEADS
                 for b in ("beta_sh", "beta_priv")], 0.0)})()

    mods["quickstart"].Experiment = Caught
    mods["quickstart"].main()
    port = mods["port_quickstart"].build_spec()
    assert port.to_json() == caught[0].to_json()
    assert isinstance(port, PX.ExperimentSpec) and port.validate() is port
