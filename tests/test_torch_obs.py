"""The port's observability layer (`repro_torch.obs`): the tracer, the
Chrome-trace export and cross-process merge, the phase attribution, and
the runner's ``trace_dir`` — the cases of tests/test_obs.py on the port,
and the port's export and metrics against the JAX package's on the same
events (the outputs must be equal: both are pure Python over the same
numbers). The roofline half of ``collect_obs`` is not ported (ROADMAP
Queue 1 item 15) and raises.
"""
import dataclasses
import json
import math

import pytest

import test_torch_threads

test_torch_threads.share_cores()

import repro.obs as RO  # noqa: E402
import repro.obs.metrics as RM  # noqa: E402
from repro_torch.obs import (load_trace, merge_traces,  # noqa: E402
                             to_chrome_events, write_trace)
from repro_torch.obs import tracer as trace  # noqa: E402
from repro_torch.obs.metrics import (collect_obs, flow_coverage,  # noqa: E402
                                     phase_attribution, self_times,
                                     stall_attribution, stall_spans)
from repro_torch.obs.tracer import Tracer, flow_id  # noqa: E402


@pytest.fixture(autouse=True)
def _no_global_tracer():
    trace.disable()
    RO.trace.disable()
    yield
    trace.disable()
    RO.trace.disable()


# -- tracer -------------------------------------------------------------------

def test_disabled_mode_is_inert():
    assert trace.get() is None and trace.active() is False
    assert trace.now() == 0.0
    with trace.span("x", a=1):
        pass
    trace.complete("x", 0.0)
    trace.instant("x")
    trace.counter("x", 1)
    trace.flow_start(1)
    trace.flow_end(1)
    trace.set_anchor("x")
    assert trace.span("a") is trace.span("b")


def test_enable_records_spans_and_disable_stops():
    tracer = trace.enable(rank=3, process_name="r3")
    with trace.span("outer", k=1):
        with trace.span("inner"):
            pass
    trace.instant("tick", step=2)
    trace.complete("retro", trace.now(), n=5)
    trace.disable()
    with trace.span("after_disable"):
        pass
    evs = tracer.events()
    assert [e["name"] for e in evs] == ["inner", "outer", "tick", "retro"]
    spans = {e["name"]: e for e in evs}
    assert spans["outer"]["ph"] == "X" and spans["outer"]["args"] == {"k": 1}
    assert spans["tick"]["ph"] == "i"
    assert tracer.rank == 3 and tracer.process_name == "r3"


def test_ring_buffer_drops_oldest_and_counts():
    tracer = trace.enable(capacity=4)
    for i in range(10):
        trace.instant("e", i=i)
    stats = tracer.stats()
    assert stats["emitted"] == 10 and stats["kept"] == 4
    assert stats["dropped"] == 6
    assert [e["args"]["i"] for e in tracer.events()] == [6, 7, 8, 9]


def test_flow_id_is_the_references():
    from repro.obs.tracer import flow_id as ref_flow_id

    ids = {flow_id(s, d, t)
           for s in range(4) for d in range(4) for t in (0, 1, 2, 1 << 31)}
    assert len(ids) == 4 * 4 * 4
    assert all(flow_id(s, d, t) == ref_flow_id(s, d, t)
               for s in range(3) for d in range(3) for t in (0, 7, 1 << 31))


# -- export -------------------------------------------------------------------

def _events():
    """A fixed mixed event list: nested and overlapping spans on two
    tracks, stalls, flows and instants."""
    def x(name, ts, dur, tid=0, **args):
        return {"ph": "X", "name": name, "ts": ts, "dur": dur, "tid": tid,
                "args": args}

    return [x("gossip/setup", 0.0, 3.0),
            x("runtime/step", 4.0, 10.0, client=0),
            x("runtime/distill", 5.0, 8.0, bundle="b"),
            x("publish/encode", 14.5, 1.0),
            x("wire/decode", 14.6, 0.2),
            x("sched/backpressure", 16.0, 0.7, op="step"),
            x("sched/wait", 17.0, 0.4, reason="pace"),
            x("socket/drain_wait", 18.0, 2.0, tid=1),
            x("unknown/thing", 20.5, 0.5),
            x("retro/a", 21.0, 5.000001), x("retro/b", 26.0, 3.0),
            {"ph": "i", "name": "mark", "ts": 1.0, "tid": 0, "args": {}},
            {"ph": "s", "name": "flow", "ts": 2.0, "tid": 0, "id": 7,
             "args": {}},
            {"ph": "f", "name": "flow", "ts": 3.0, "tid": 1, "id": 7,
             "args": {}},
            {"ph": "s", "name": "flow", "ts": 4.0, "tid": 0, "id": 9,
             "args": {}}]


def test_export_and_metrics_equal_the_references():
    evs = _events()
    for kw in ({}, {"offset_s": 2.5, "base_s": 1.0}):
        ch = to_chrome_events(evs, pid=2, **kw)
        assert ch == RO.to_chrome_events(evs, pid=2, **kw)
    ch = to_chrome_events(evs, pid=0) + to_chrome_events(evs, pid=1)
    assert self_times(ch) == RM.self_times(ch)
    assert phase_attribution(ch) == RM.phase_attribution(ch)
    assert stall_spans(ch, top=4) == RM.stall_spans(ch, top=4)
    assert stall_attribution(ch) == RM.stall_attribution(ch)
    assert flow_coverage(ch) == RM.flow_coverage(ch)
    row = phase_attribution(ch)[0]
    assert row["wall"] == pytest.approx(sum(
        v for k, v in row.items() if k != "wall"))
    from repro_torch.obs.metrics import PHASE_OF, PHASE_ORDER, STALL_NAMES

    assert (PHASE_OF, PHASE_ORDER, STALL_NAMES) == \
        (RM.PHASE_OF, RM.PHASE_ORDER, RM.STALL_NAMES)


def test_write_load_and_merge_cross_the_packages(tmp_path):
    """A port trace file loads in the reference, and both packages merge
    the same files into the same timeline (clocks aligned by the
    rendezvous anchors)."""
    paths, skew = {}, {0: 0.0, 1: 10.0}
    for r in (0, 1):
        tr = Tracer(rank=r, process_name=f"rank {r}")
        tr.set_anchor("rendezvous_send", 1.0 - skew[r])
        tr.set_anchor("rendezvous_recv", 1.0 - skew[r])
        tr._emit({"ph": "X", "name": "work", "ts": 2.0 - skew[r],
                  "dur": 0.5, "tid": 0, "args": {}})
        paths[r] = write_trace(str(tmp_path / f"r{r}.json"), tr,
                               meta={"k": r})
    assert RO.load_trace(paths[1]) == load_trace(paths[1])
    anchors = {0: (1.0, 1.0), 1: (1.0, 1.0)}
    ours = load_trace(merge_traces(paths, str(tmp_path / "m.json"),
                                   parent_anchors=anchors))
    theirs = RO.load_trace(RO.merge_traces(paths, str(tmp_path / "mr.json"),
                                           parent_anchors=anchors))
    assert ours == theirs
    work = [e for e in ours["traceEvents"] if e["ph"] == "X"]
    assert work[0]["ts"] == pytest.approx(work[1]["ts"], abs=1.0)
    assert ours["otherData"]["offsets_s"]["1"] == pytest.approx(10.0)


# -- collect_obs and the runner -----------------------------------------------

def test_collect_obs_folds_meter_and_tracer():
    from repro_torch.comm import CommMeter

    class FakeTrainer:
        meter = CommMeter()

    FakeTrainer.meter.record(0, 0, 1, 100)
    FakeTrainer.meter.record_delivery(0, 0, 1, 100)
    FakeTrainer.meter.record_gate(0, fresh=2, stale=1)
    tracer = trace.enable(rank=0)
    with trace.span("runtime/distill", bundle="b"):
        pass
    trace.disable()
    snap = collect_obs(trainer=FakeTrainer(), tracer=tracer)
    m = snap.to_metrics()
    assert m["obs/comm/total_bytes"] == 100.0
    assert m["obs/gate/c0/fresh"] == 2.0
    assert m["obs/trace/kept"] == 1.0
    assert m["obs/phase/r0/distill"] > 0.0
    # a trainer that never distilled has no update to price: the
    # roofline section stays empty, as the reference's
    snap = collect_obs(trainer=FakeTrainer(), tracer=tracer,
                       with_roofline=True)
    assert snap.roofline == {}
    assert not any(k.startswith("obs/roofline/") for k in snap.to_metrics())


def test_experiment_trace_dir_writes_a_trace_the_reference_reads(tmp_path):
    """``trace_dir`` on a lockstep run: a Chrome trace the reference's
    `load_trace` reads, the ``obs/`` metrics (every one of the
    reference's, the roofline rows among them), the tracer off again
    after."""
    from test_torch_exp import PX, tiny_spec

    spec = tiny_spec(PX, "mhd", {"pool_size": 1, "pool_update_every": 2},
                     PX.ExperimentSpec.uniform_fleet(2, aux_heads=1),
                     steps=4, trace_dir=str(tmp_path / "tr"),
                     schedule=PX.ScheduleSpec(mode="lockstep", rates=(1, 2)),
                     wire=PX.WireSpec(exchange="prediction_topk", topk=4,
                                      horizon=4))
    res = PX.Experiment(spec, device="cpu").run()
    assert trace.get() is None
    data = RO.load_trace(str(tmp_path / "tr" / "trace.json"))
    names = {e["name"] for e in data["traceEvents"]}
    assert {"runtime/distill", "runtime/step", "sched/tick",
            "publish/encode", "wire/decode"} <= names
    assert data["otherData"]["meta"] == {"spec_name": "tiny", "steps": 4}
    m = res.metrics
    assert m["obs/trace/dropped"] == 0.0
    assert m["obs/phase/r0/distill"] > 0.0
    assert m["obs/fresh/c1/local_steps"] == 2.0
    roofline = {k: v for k, v in m.items() if k.startswith("obs/roofline/")}
    assert any(k.endswith("/flops") for k in roofline)
    assert any(k.endswith("/achieved_flops_per_s") for k in roofline)
    bundles = {k.split("/")[2] for k in roofline}
    assert bundles
    for name in bundles:
        for key in ("flops", "bytes", "collective_total", "intensity",
                    "attainable_flops_per_s", "achieved_flops_per_s",
                    "roofline_fraction", "distill_span_mean_s"):
            v = m[f"obs/roofline/{name}/{key}"]
            assert math.isfinite(v) and v >= 0.0, (name, key)
        assert m[f"obs/roofline/{name}/flops"] > 0.0
    json.dumps(res.to_payload())
    plain = dataclasses.replace(spec, train=dataclasses.replace(
        spec.train, trace_dir=None, steps=2))
    res2 = PX.Experiment(plain, device="cpu").run()
    assert not any(k.startswith("obs/") for k in res2.metrics)
