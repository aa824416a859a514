"""`repro_torch.serve` — the port's continuous-batching inference front —
held to the reference's serving tests (tests/test_serve.py, the same 21
cases against the port) and against `repro.serve` itself, on the CPU.

The engine cases run reduced minitron-4b with the reference's params
(its own init, carried over by `params_from_jax`):

  * the prefill is *bitwise* the token-by-token ``decode_step`` loop,
    logits and caches;
  * a request's greedy tokens through the continuous engine equal its
    solo B = 1 decode, whatever shares the engine, under admit and evict
    and under static admission;
  * a teacher-cache hit is byte-identical to the recompute it replaced.

Then one train→snapshot→serve→feed-back scenario at the reference test's
reduced sizes (serve_loop cut to 8 steps, 9 requests, 2 slots), run by
both packages from one initial draw (`test_torch_exp.same_initial_params`)
and with the reference engine's params in the port's engine. Held equal:
the classify labels, the cache ledger's counts, the router's summary, the
generate stream's greedy tokens, the feedback's counts and wire bytes.
Held within 2e-4 of the largest magnitude (tests/test_torch_exp.py's
step-metric tolerance; 8 SGD steps of float32 arithmetic summed in
another order): the teacher-window ensemble logits and the classify
logits. The snapshot front serves exactly the trainer's params, and a
snapshot the reference wrote serves the reference's.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import io as JIO
from repro.configs import get_reduced as jax_reduced
from repro.models import transformer as JTF
import repro.serve as RS
from repro_torch.checkpoint import io as TIO
from repro_torch.configs import get_reduced
from repro_torch.exp import ExperimentSpec, ServeSpec, get_preset
from repro_torch.models.zoo import build_bundle
from repro_torch.serve import (
    CacheLedger,
    ContinuousBatchingEngine,
    Prefill,
    Router,
    ServeRequest,
    TeacherPredictionCache,
    TrafficLog,
    run_serve_scenario,
    solo_generate,
)
import test_torch_exp
import test_torch_threads

test_torch_threads.share_cores()

for _op in (torch.exp, torch.log, torch.sqrt):
    _op(torch.ones(1))

_ARCH = "minitron-4b"
TOL = 2e-4


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _flat_jax(tree) -> dict:
    return {k: np.asarray(v) for k, v in JIO.flatten_with_paths(tree).items()}


def _tree_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.fixture(scope="module")
def lm():
    cfg = get_reduced(_ARCH)
    bundle = build_bundle(cfg)
    jcfg = jax_reduced(_ARCH)
    ref = jax.jit(lambda k: JTF.init_lm(k, jcfg))(jax.random.PRNGKey(0))
    params = TIO.params_from_jax(_flat_jax(ref), device="cpu")
    return cfg, bundle, params


def _gen_request(rid, vocab, rng, max_new):
    return ServeRequest(
        request_id=rid, kind="generate",
        prompt=rng.integers(0, vocab, size=int(rng.integers(3, 8)),
                            dtype=np.int32),
        max_new_tokens=max_new)


def _engine(bundle, params, **kw):
    return ContinuousBatchingEngine(bundle, params, device="cpu", **kw)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def test_prefill_bitwise_matches_stepwise_loop(lm):
    """The prefill is the token-by-token loop, bitwise: logits AND
    caches."""
    cfg, bundle, params = lm
    B, T, cache_len = 2, 7, 16
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, T), dtype=np.int32))

    loop_caches = bundle.init_cache(B, cache_len, torch.float32,
                                    device="cpu")
    loop_logits = []
    with torch.no_grad():
        for t in range(T):
            lg, loop_caches = bundle.decode_step(params, tokens[:, t:t + 1],
                                                 loop_caches)
            loop_logits.append(lg.numpy())

    fused_caches = bundle.init_cache(B, cache_len, torch.float32,
                                     device="cpu")
    fused_caches, fused_logits = Prefill(bundle)(params, tokens,
                                                 fused_caches)
    fused_np = fused_logits.numpy()  # (T, B, 1, V)
    assert fused_np.shape == (T, B, 1, cfg.vocab_size)
    for t in range(T):
        assert fused_np[t].tobytes() == loop_logits[t].tobytes(), \
            f"prefill logits diverge at position {t}"
    assert _tree_equal(fused_caches, loop_caches), \
        "prefill caches diverge from the step-wise loop"


def test_prefill_rejects_non_lm():
    class NotLM:
        name = "resnet"
        is_lm = False

    with pytest.raises(ValueError, match="decode path"):
        Prefill(NotLM())


# ---------------------------------------------------------------------------
# continuous batching determinism
# ---------------------------------------------------------------------------

def test_continuous_equals_solo_under_admit_evict(lm):
    """Mixed-length requests through a 3-slot engine: slots retire and
    re-admit constantly, and every request's greedy tokens must equal its
    solo B = 1 decode."""
    cfg, bundle, params = lm
    rng = np.random.default_rng(0)
    cache_len = 8 + 10
    engine = _engine(bundle, params, num_slots=3, cache_len=cache_len)
    requests = [_gen_request(rid, cfg.vocab_size, rng,
                             max_new=int(rng.integers(1, 11)))
                for rid in range(6)]
    for r in requests:
        engine.submit(r)
    responses = {r.request_id: r for r in engine.run()}

    assert len(responses) == len(requests)
    assert engine.completed == len(requests)
    for req in requests:
        solo = solo_generate(bundle, params, req.prompt,
                             req.max_new_tokens, cache_len)
        got = responses[req.request_id].tokens
        assert got == solo, \
            f"request {req.request_id}: batched {got} != solo {solo}"
        assert len(got) == req.max_new_tokens


def test_cobatch_does_not_change_tokens(lm):
    """The same request decodes to the same tokens whatever shares the
    engine — here: alone vs alongside longer neighbours."""
    cfg, bundle, params = lm
    rng = np.random.default_rng(1)
    probe = _gen_request(0, cfg.vocab_size, rng, max_new=6)

    alone = _engine(bundle, params, num_slots=2, cache_len=18)
    alone.submit(probe)
    tokens_alone = alone.run()[0].tokens

    crowded = _engine(bundle, params, num_slots=2, cache_len=18)
    crowded.submit(probe)
    for rid in range(1, 4):
        crowded.submit(_gen_request(rid, cfg.vocab_size, rng, max_new=9))
    tokens_crowded = {r.request_id: r.tokens for r in crowded.run()}[0]

    assert tokens_alone == tokens_crowded


def test_static_admission_drains_before_admitting(lm):
    """Static batching is the same engine with a gate: no admission into
    a partly free batch. Tokens still match solo; a later batch admits
    only after the earlier one fully finished."""
    cfg, bundle, params = lm
    rng = np.random.default_rng(2)
    engine = _engine(bundle, params, num_slots=2, cache_len=18,
                     admission="static")
    requests = [_gen_request(rid, cfg.vocab_size, rng,
                             max_new=(8 if rid % 2 == 0 else 2))
                for rid in range(4)]
    for r in requests:
        engine.submit(r)
    responses = sorted(engine.run(), key=lambda r: r.admit_tick)

    first_batch, second_batch = responses[:2], responses[2:]
    assert first_batch[0].admit_tick == first_batch[1].admit_tick
    assert second_batch[0].admit_tick == second_batch[1].admit_tick
    assert second_batch[0].admit_tick >= max(r.finish_tick
                                             for r in first_batch)
    for req in requests:
        got = {r.request_id: r.tokens for r in responses}[req.request_id]
        assert got == solo_generate(bundle, params, req.prompt,
                                    req.max_new_tokens, 18)


def test_continuous_occupancy_beats_static_on_mixed_lengths(lm):
    """On mixed lengths the continuous engine needs fewer decode ticks and
    keeps slots fuller than the static gate."""
    cfg, bundle, params = lm

    def run(admission):
        rng = np.random.default_rng(3)
        engine = _engine(bundle, params, num_slots=2, cache_len=18,
                         admission=admission)
        for rid in range(6):
            engine.submit(_gen_request(rid, cfg.vocab_size, rng,
                                       max_new=(10 if rid % 2 else 2)))
        engine.run()
        return engine

    cont, static = run("continuous"), run("static")
    assert cont.decode_ticks < static.decode_ticks
    assert cont.occupancy() > static.occupancy()


def test_engine_input_validation(lm):
    cfg, bundle, params = lm
    with pytest.raises(ValueError, match="admission"):
        _engine(bundle, params, admission="greedy")
    with pytest.raises(ValueError, match="at least one slot"):
        _engine(bundle, params, num_slots=0)
    engine = _engine(bundle, params, num_slots=2, cache_len=12)
    with pytest.raises(ValueError, match="only decodes"):
        engine.submit(ServeRequest(request_id=0, kind="classify",
                                   image=np.zeros((8, 8, 3))))
    with pytest.raises(ValueError, match="cache"):
        engine.submit(ServeRequest(
            request_id=1, kind="generate",
            prompt=np.zeros(8, dtype=np.int32), max_new_tokens=8))


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is visible")
def test_serving_defaults_to_the_card_and_raises_without_one(lm):
    """The engine, the front's builders and the launcher resolve their
    device to CUDA by default; without a card they raise, never falling
    back to the CPU."""
    from repro_torch.launch.serve import main
    from repro_torch.serve import build_engine

    cfg, bundle, params = lm
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatchingEngine(bundle, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_engine(get_preset("serve_loop"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--arch", _ARCH, "--batch", "2", "--prompt-len", "4",
              "--gen", "2"])


# ---------------------------------------------------------------------------
# teacher-prediction cache
# ---------------------------------------------------------------------------

def test_cache_hit_is_byte_identical_to_recompute():
    rng = np.random.default_rng(0)
    value = {"logits": rng.standard_normal((4, 8)).astype(np.float32),
             "sample_ids": np.arange(4, dtype=np.uint64)}
    calls = []

    def compute():
        calls.append(1)
        return {k: v.copy() for k, v in value.items()}

    cache = TeacherPredictionCache(capacity=2)
    miss, hit1 = cache.get_or_compute(3, (0, 1), compute)
    got, hit2 = cache.get_or_compute(3, (1, 0), compute)  # order-insensitive
    assert (hit1, hit2) == (False, True)
    assert len(calls) == 1, "hit must not recompute"
    for k in value:
        assert got[k].tobytes() == miss[k].tobytes()
    ledger = cache.ledger
    assert isinstance(ledger, CacheLedger)
    assert (ledger.hits, ledger.misses) == (1, 1)
    assert ledger.hit_bytes == ledger.miss_bytes > 0
    assert ledger.hit_rate() == 0.5


def test_cache_lru_eviction_and_ledger():
    cache = TeacherPredictionCache(capacity=2)
    mk = lambda w: (lambda: {"logits": np.full((2, 2), w, np.float32)})
    cache.get_or_compute(0, (0,), mk(0))
    cache.get_or_compute(1, (0,), mk(1))
    cache.get_or_compute(0, (0,), mk(0))  # touch 0: now 1 is LRU
    cache.get_or_compute(2, (0,), mk(2))  # evicts window 1
    assert cache.key(0, (0,)) in cache
    assert cache.key(1, (0,)) not in cache
    assert cache.key(2, (0,)) in cache
    assert cache.ledger.evictions == 1
    assert len(cache) == 2
    table = cache.ledger.format_table()
    assert "1 hits" in table and "evicted" in table
    with pytest.raises(ValueError, match="capacity"):
        TeacherPredictionCache(capacity=0)


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------

def _affinity_router(policy="label_affinity"):
    # client 0 owns labels {0,1}, client 1 owns {2}, client 2 owns {1,2}
    affinity = np.array([[4.0, 2.0, 0.0],
                         [0.0, 0.0, 5.0],
                         [0.0, 3.0, 5.0]])
    return Router(3, affinity=affinity, policy=policy)


def test_router_label_affinity_and_pinning():
    r = _affinity_router()
    img = np.zeros((8, 8, 3))
    assert r.route(ServeRequest(0, image=img, label_hint=0)) == 0
    assert r.route(ServeRequest(1, image=img, label_hint=1)) == 2
    # argmax tie on label 2 (clients 1 and 2) resolves to the lowest id
    assert r.route(ServeRequest(2, image=img, label_hint=2)) == 1
    # an explicit pin beats the affinity map
    assert r.route(ServeRequest(3, image=img, label_hint=0,
                                client_id=2)) == 2
    # hintless requests fall back to round-robin
    assert [r.route(ServeRequest(4 + i, image=img)) for i in range(4)] \
        == [0, 1, 2, 0]
    s = r.summary()
    assert s["routed"] == 8.0 and s["c2"] == 3.0


def test_router_validation():
    with pytest.raises(ValueError, match="unknown routing policy"):
        Router(2, policy="sticky")
    with pytest.raises(ValueError, match="affinity map"):
        Router(2, policy="label_affinity")
    with pytest.raises(ValueError, match="does not cover"):
        Router(4, affinity=np.ones((2, 3)), policy="label_affinity")
    r = _affinity_router()
    with pytest.raises(ValueError, match="pins client"):
        r.route(ServeRequest(0, image=np.zeros((8, 8, 3)), client_id=7))


def test_router_round_robin_spreads_evenly():
    r = Router(3, policy="round_robin")
    img = np.zeros((8, 8, 3))
    got = [r.route(ServeRequest(i, image=img, label_hint=0))
           for i in range(6)]
    assert got == [0, 1, 2, 0, 1, 2]


@pytest.mark.parametrize("policy", ["label_affinity", "round_robin",
                                    "client_id"])
def test_router_matches_reference_on_the_same_partition(policy):
    """`Router.from_partition` on serve_loop's own partition: the affinity
    map and every decision over a stream of hinted, pinned and hintless
    requests equal the reference's."""
    import repro.exp as RX
    from repro_torch.exp.runner import materialize_data

    spec = get_preset("serve_loop")
    arrays, test, part = materialize_data(spec.data, spec.partition,
                                          spec.num_clients)
    ref_spec = RX.ExperimentSpec.from_json(spec.to_json())
    r_arrays, _, r_part = RX.materialize_data(
        ref_spec.data, ref_spec.partition, ref_spec.num_clients)
    port = Router.from_partition(part, arrays["labels"],
                                 spec.data.num_labels, policy=policy)
    ref = RS.Router.from_partition(r_part, r_arrays["labels"],
                                   spec.data.num_labels, policy=policy)
    if policy == "label_affinity":
        np.testing.assert_array_equal(port.affinity, ref.affinity)
    rng = np.random.default_rng(5)
    for rid in range(40):
        hint = int(rng.integers(0, spec.data.num_labels))
        pin = int(rng.integers(0, spec.num_clients)) if rid % 5 == 0 \
            else None
        kw = dict(image=test["images"][rid], client_id=pin,
                  label_hint=None if rid % 7 == 3 else hint)
        assert port.route(ServeRequest(rid, **kw)) == \
            ref.route(RS.ServeRequest(rid, **kw)), rid
    assert port.summary() == ref.summary()


# ---------------------------------------------------------------------------
# request validation + traffic log
# ---------------------------------------------------------------------------

def test_request_validation():
    with pytest.raises(ValueError, match="unknown request kind"):
        ServeRequest(0, kind="embed").validate()
    with pytest.raises(ValueError, match="no image"):
        ServeRequest(0, kind="classify").validate()
    with pytest.raises(ValueError, match="no window_id"):
        ServeRequest(0, kind="teacher").validate()
    with pytest.raises(ValueError, match="1-D token prompt"):
        ServeRequest(0, kind="generate",
                     prompt=np.zeros((2, 3), np.int32)).validate()
    with pytest.raises(ValueError, match="< 1 new token"):
        ServeRequest(0, kind="generate", prompt=np.zeros(3, np.int32),
                     max_new_tokens=0).validate()


def test_traffic_log():
    log = TrafficLog()
    with pytest.raises(ValueError, match="empty"):
        log.arrays()
    for _ in range(3):
        log.log(np.zeros((4, 4, 3), np.float32))
    assert len(log) == 3
    assert log.arrays()["images"].shape == (3, 4, 4, 3)


# ---------------------------------------------------------------------------
# ServeSpec
# ---------------------------------------------------------------------------

def test_serve_spec_json_round_trip():
    spec = get_preset("serve_loop")
    clone = ExperimentSpec.from_json(spec.to_json())
    assert clone == spec
    assert isinstance(clone.serve, ServeSpec)
    assert clone.serve.engine_arch == "minitron-4b"
    assert json.loads(spec.to_json())["serve"]["requests"] == \
        spec.serve.requests


@pytest.mark.parametrize("patch, match", [
    (dict(requests=-1), "requests"),
    (dict(router="sticky"), "router"),
    (dict(num_slots=0), "num_slots"),
    (dict(max_new_tokens=0), "max_new_tokens"),
    (dict(cache_windows=0), "cache_windows"),
    (dict(teachers=(0, 9)), "teacher"),
    (dict(requests=0, feedback_steps=2), "feedback"),
])
def test_serve_spec_validation(patch, match):
    spec = get_preset("serve_loop")
    spec = dataclasses.replace(spec,
                               serve=dataclasses.replace(spec.serve,
                                                         **patch))
    with pytest.raises(ValueError, match=match):
        spec.validate()


def test_serve_feedback_needs_prediction_wire():
    spec = get_preset("serve_loop")
    spec = dataclasses.replace(
        spec, wire=dataclasses.replace(spec.wire, exchange="params"))
    with pytest.raises(ValueError, match="prediction"):
        spec.validate()


# ---------------------------------------------------------------------------
# end-to-end: snapshot serving + cache + feedback, against the reference
# ---------------------------------------------------------------------------

def _scenario_spec():
    spec = get_preset("serve_loop")
    return dataclasses.replace(
        spec,
        train=dataclasses.replace(spec.train, steps=8),
        serve=dataclasses.replace(spec.serve, requests=9, num_slots=2,
                                  max_new_tokens=4, cache_windows=2,
                                  feedback_steps=1))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """One tiny train→snapshot→serve→feedback run in each package, from
    one initial draw of the fleet; the port's engine holds the reference
    engine's params. Returns (reference result, port result)."""
    import repro.exp as RX
    import repro_torch.models.zoo as zoo

    spec = _scenario_spec()
    with pytest.MonkeyPatch.context() as mp:
        test_torch_exp.same_initial_params(mp, spec)
        ref = RS.run_serve_scenario(
            RX.ExperimentSpec.from_json(spec.to_json()),
            str(tmp_path_factory.mktemp("ref_scenario")))
        engine_params = TIO.params_from_jax(
            _flat_jax(ref.front.engine.params), device="cpu")
        build = zoo.build_bundle
        mp.setattr(zoo, "build_bundle", lambda cfg, *a, **kw: (
            dataclasses.replace(build(cfg, *a, **kw),
                                init=lambda _: dict(engine_params))))
        port = run_serve_scenario(
            spec, str(tmp_path_factory.mktemp("port_scenario")),
            device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def scenario(both):
    return both[1]


def test_scenario_serves_every_request(scenario):
    m = scenario.metrics
    expected = 9 + max(2 * 2, 4)  # stream + generate burst
    assert len(scenario.responses) == expected
    assert sum(m[f"served/{k}"]
               for k in ("classify", "teacher", "generate")) == expected
    assert m["route/routed"] == m["served/classify"]
    assert m["engine/completed"] == m["served/generate"]
    assert m["serve/snapshot_step"] == 8.0
    assert all(r.tokens for r in scenario.responses
               if r.kind == "generate")


def test_scenario_cache_hits_on_hot_windows(scenario):
    m = scenario.metrics
    assert m["cache/hit_rate"] > 0
    assert m["cache/hits"] + m["cache/misses"] == m["served/teacher"]
    hits = [r for r in scenario.responses
            if r.kind == "teacher" and r.cache_hit]
    misses = {r.request_id: r for r in scenario.responses
              if r.kind == "teacher" and not r.cache_hit}
    assert hits and misses
    # a hit's predictions are byte-identical to the miss that filled the
    # entry (same window, whole-fleet teacher set)
    first_miss = min(misses.values(), key=lambda r: r.request_id)
    h = min(hits, key=lambda r: r.request_id)
    for k in ("logits", "sample_ids"):
        assert h.predictions[k].tobytes() == \
            first_miss.predictions[k].tobytes()


def test_snapshot_front_serves_trainer_params(scenario):
    """The front's params are exactly what the trained fleet snapshotted
    — reloaded from the same directory — and the trainer has moved on
    since (the feedback step trained it on the served traffic)."""
    from repro_torch.fleet import load_client_params

    front = scenario.front
    snap_dir = scenario.spec.train.snapshot_dir
    for cid, bundle in enumerate(front.bundles):
        like = bundle.init(torch.Generator().manual_seed(99))
        loaded, step = load_client_params(snap_dir, cid, like)
        assert step == 8
        assert _tree_equal(loaded, front.params[cid])
        trained = scenario.experiment.trainer.clients[cid].params
        assert not _tree_equal(trained, front.params[cid])


def test_scenario_feedback_distills_from_served_traffic(scenario):
    m = scenario.metrics
    assert m["feedback/steps"] == 1.0
    assert m["feedback/distill_steps"] >= 1.0
    assert m["feedback/wire_bytes"] > 0
    assert len(scenario.front.traffic) > 0


def test_scenario_matches_reference(both):
    """Every response and every count of the port's scenario against the
    reference's run of the same spec from the same draw."""
    ref, port = both
    assert [(r.request_id, r.kind) for r in port.responses] == \
        [(r.request_id, r.kind) for r in ref.responses]
    for p, r in zip(port.responses, ref.responses):
        if r.kind == "classify":
            assert (p.client_id, p.label) == (r.client_id, r.label)
            assert _rel(p.logits, r.logits) < TOL, r.request_id
        elif r.kind == "teacher":
            assert p.cache_hit == r.cache_hit
            assert p.predictions["sample_ids"].tobytes() == \
                r.predictions["sample_ids"].tobytes()
            assert _rel(p.predictions["logits"],
                        r.predictions["logits"]) < TOL, r.request_id
        else:
            assert p.tokens == r.tokens, r.request_id
            assert (p.admit_tick, p.finish_tick) == (r.admit_tick,
                                                     r.finish_tick)
    exact = [k for k in ref.metrics
             if k.startswith(("served/", "cache/", "route/", "engine/",
                              "feedback/"))
             or k == "serve/snapshot_step"]
    assert sorted(port.metrics) == sorted(ref.metrics)
    for k in exact:
        assert port.metrics[k] == ref.metrics[k], k
    assert port.front.cache.ledger.format_table() == \
        ref.front.cache.ledger.format_table()
    assert len(port.front.traffic) == len(ref.front.traffic)


def test_generate_stream_equals_solo(scenario):
    """Each request of the scenario's generate stream decodes, under the
    engine's continuous admission, to its solo B = 1 tokens."""
    engine = scenario.front.engine
    gens = [r for r in scenario.responses if r.kind == "generate"]
    assert len(gens) == 4
    rng = np.random.default_rng(scenario.spec.serve.seed)
    # replay the stream's draws: the request stream's, then the prompts
    from repro_torch.serve.front import _generate_stream, _request_stream
    from repro_torch.exp.runner import materialize_data

    sp = scenario.spec
    _request_stream(sp, materialize_data(sp.data, sp.partition,
                                         sp.num_clients)[1], rng)
    by_id = {r.request_id: r for r in gens}
    stream = _generate_stream(sp, engine.bundle.config.vocab_size, rng)
    assert sorted(by_id) == [req.request_id for req in stream]
    for req in stream:
        assert by_id[req.request_id].tokens == solo_generate(
            engine.bundle, engine.params, req.prompt, req.max_new_tokens,
            engine.cache_len)


def test_front_serves_a_snapshot_the_reference_wrote(both):
    """`ServeFront.from_snapshot` reads the reference's fleet snapshot
    into exactly the reference front's params."""
    from repro_torch.serve import ServeFront

    ref, port = both
    front = ServeFront.from_snapshot(port.spec, ref.spec.train.snapshot_dir,
                                     device="cpu")
    assert front.snapshot_step == 8
    for cid, params in enumerate(front.params):
        want = TIO.params_from_jax(_flat_jax(ref.front.params[cid]),
                                   device="cpu")
        assert _tree_equal(params, want), cid


def test_serve_launcher_demo_on_the_cpu(capsys):
    """`launch/serve.main` in demo mode: a reduced LM through the engine
    on the CPU, every request answered."""
    from repro_torch.launch.serve import main

    assert main(["--arch", _ARCH, "--batch", "2", "--prompt-len", "5",
                 "--gen", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "4 requests" in out and "device=cpu" in out
