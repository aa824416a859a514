"""Unified observability snapshot: comm books + freshness + trace +
roofline (port of ``repro/obs/metrics.py``).

`collect_obs` folds four telemetry sources into one typed `ObsSnapshot`:

  * the `CommMeter` books (offered / delivered / tombstoned bytes, gate
    counters) — what the fleet *sent*;
  * the scheduler's freshness report (per-client mailbox vs its own
    clock) — what the fleet *sees*;
  * the tracer's phase attribution (self-time per span name, idle as the
    remainder) — where the wall-clock *went*;
  * with ``with_roofline=True``, each bundle's distill update priced on
    the card (`distill_step_cost`: counted on meta copies of its
    arguments, `roofline.op_cost`) and its achieved rate from the traced
    ``runtime/distill`` spans (`_achieved_flops`) — how far each update is
    from what the card could do.

``ObsSnapshot.to_metrics()`` flattens everything under the ``obs/``
namespace, which `Experiment.run()` merges into the result metrics when
``TrainSpec.trace_dir`` is set.

Phase attribution
  Span self-time: a span's duration minus its children's durations, so
  nested instrumentation never double-counts (a ``runtime/step`` span
  containing a ``runtime/distill`` span contributes only its own
  overhead). Ranks are single-threaded, so spans nest cleanly; the sweep
  is a per-(pid, tid) stack over time-sorted complete events. ``idle`` is
  defined as the rank's timeline extent minus the sum of all self-times —
  by construction the phase table sums exactly to the observed wall.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Any, Dict, List

import torch

from repro_torch.roofline.analysis import H100, HardwareSpec

# span name -> report phase; names not listed fall back to their first
# path segment ("sched/tick" -> "sched"). The report's headline phases:
PHASE_OF = {
    "runtime/distill": "distill",
    "runtime/supervised": "distill",
    "publish/forward": "encode",
    "publish/encode": "encode",
    "wire/serialize": "encode",
    "socket/send": "wire",
    "socket/connect": "wire",
    "socket/drain": "wire",
    "wire/deserialize": "wire",
    "wire/decode": "wire",
    "bus/deliver": "wire",
    "socket/drain_wait": "drain_wait",
    "gossip/rendezvous": "barrier",
    "gossip/finish_barrier": "barrier",
    "gossip/setup": "setup",
    "runtime/step": "step_other",
    "runtime/resolve": "step_other",
    "sched/tick": "step_other",
    # scoreboard stalls: pace/idle waits and run-ahead backpressure
    "sched/wait": "sched_stall",
    "sched/backpressure": "sched_stall",
    # serving phases (the reference's repro.serve): routing decision,
    # fused prompt prefill, decode tick, teacher-cache lookup+compute;
    # the classify forward is the decode-equivalent serving compute
    "serve/route": "route",
    "serve/prefill": "prefill",
    "serve/decode": "decode",
    "serve/classify": "decode",
    "serve/cache": "cache",
}

PHASE_ORDER = ["distill", "encode", "wire", "drain_wait", "sched_stall",
               "barrier", "setup", "step_other", "route", "prefill",
               "decode", "cache", "other", "idle"]

# spans that are *waits*, not work — what the stall report ranks
STALL_NAMES = frozenset({
    "socket/drain_wait", "socket/connect",
    "gossip/rendezvous", "gossip/finish_barrier",
    "sched/wait", "sched/backpressure",
})


def self_times(chrome_events: List[Dict[str, Any]]
               ) -> Dict[int, Dict[str, float]]:
    """Per-pid self-time (seconds) per span name from Chrome "X" events
    (ts/dur in µs). Also returns the rank's timeline extent as ``#wall``
    and the idle remainder as ``#idle`` (reserved names: real spans use
    path-like names, never ``#``)."""
    spans: Dict[tuple, List[Dict[str, Any]]] = defaultdict(list)
    for ev in chrome_events:
        if ev.get("ph") == "X":
            spans[(ev.get("pid", 0), ev.get("tid", 0))].append(ev)

    out: Dict[int, Dict[str, float]] = defaultdict(lambda: defaultdict(float))
    extent: Dict[int, List[float]] = {}
    for (pid, _tid), evs in spans.items():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        lo = min(e["ts"] for e in evs)
        hi = max(e["ts"] + e["dur"] for e in evs)
        if pid in extent:
            extent[pid][0] = min(extent[pid][0], lo)
            extent[pid][1] = max(extent[pid][1], hi)
        else:
            extent[pid] = [lo, hi]
        # stack sweep: [name, end_ts, child_dur_acc]
        stack: List[List[Any]] = []

        def pop(frame):
            name, _end, child = frame[0], frame[1], frame[2]
            out[pid][name] += (frame[3] - child) / 1e6

        for ev in evs:
            end = ev["ts"] + ev["dur"]
            while stack and stack[-1][1] <= ev["ts"] + 1e-9:
                pop(stack.pop())
            # retro-emitted spans can end a hair *after* their successor
            # starts (the emit call itself takes time): if the open span
            # ends mid-way through the new one they overlap rather than
            # nest — close the earlier span instead of adopting the whole
            # successor as its child (which would drive its self-time
            # negative by the successor's full duration)
            while stack and stack[-1][1] < end - 1e-9:
                pop(stack.pop())
            if stack:
                stack[-1][2] += ev["dur"]
            stack.append([ev["name"], end, 0.0, ev["dur"]])
        while stack:
            pop(stack.pop())
    for pid, (lo, hi) in extent.items():
        wall = (hi - lo) / 1e6
        out[pid]["#wall"] = wall
        out[pid]["#idle"] = max(0.0, wall - sum(
            v for k, v in out[pid].items() if not k.startswith("#")))
    return {pid: dict(d) for pid, d in out.items()}


def phase_attribution(chrome_events: List[Dict[str, Any]]
                      ) -> Dict[int, Dict[str, float]]:
    """Per-pid seconds per report phase (see ``PHASE_ORDER``) + ``wall``.
    Phases + idle sum to wall by construction."""
    out: Dict[int, Dict[str, float]] = {}
    for pid, names in self_times(chrome_events).items():
        row = {p: 0.0 for p in PHASE_ORDER}
        row["wall"] = names.pop("#wall", 0.0)
        row["idle"] = names.pop("#idle", 0.0)
        for name, secs in names.items():
            phase = PHASE_OF.get(name)
            if phase is None:
                head = name.split("/", 1)[0]
                phase = head if head in row else "other"
            row[phase] += secs
        out[pid] = row
    return out


def stall_spans(chrome_events: List[Dict[str, Any]],
                top: int = 10) -> List[Dict[str, Any]]:
    """The ``top`` longest wait spans (see ``STALL_NAMES``), longest
    first — the "where did the 49 seconds go" list."""
    stalls = [ev for ev in chrome_events
              if ev.get("ph") == "X" and ev["name"] in STALL_NAMES]
    stalls.sort(key=lambda e: -e["dur"])
    return [{"rank": ev.get("pid", 0), "name": ev["name"],
             "start_s": ev["ts"] / 1e6, "dur_s": ev["dur"] / 1e6,
             "args": ev.get("args", {})}
            for ev in stalls[:top]]


def stall_attribution(chrome_events: List[Dict[str, Any]],
                      prefix: str = "sched/") -> List[Dict[str, Any]]:
    """Aggregate *scheduler* stall spans by (span name, gated op):
    count, total and max seconds per group, largest total first. The
    ``op`` key is the span's ``op`` arg (``sched/backpressure`` records
    which op class the run-ahead credit held back) falling back to
    ``reason`` (``sched/wait`` records why the issue loop slept) — the
    per-op answer to "what did the scoreboard's waiting pay for"."""
    groups: Dict[tuple, Dict[str, float]] = {}
    for ev in chrome_events:
        if ev.get("ph") != "X" or not ev["name"].startswith(prefix) \
                or ev["name"] not in STALL_NAMES:
            continue
        args = ev.get("args", {})
        op = str(args.get("op") or args.get("reason") or "?")
        g = groups.setdefault((ev["name"], op),
                              {"count": 0.0, "total_s": 0.0, "max_s": 0.0})
        dur = ev["dur"] / 1e6
        g["count"] += 1
        g["total_s"] += dur
        g["max_s"] = max(g["max_s"], dur)
    return [{"name": name, "op": op, **g}
            for (name, op), g in sorted(groups.items(),
                                        key=lambda kv: -kv[1]["total_s"])]


def flow_coverage(chrome_events: List[Dict[str, Any]]) -> Dict[str, float]:
    """How many send→delivery flow pairs actually matched up across
    tracks: a merged multi-process trace should pair nearly every ``s``
    with an ``f`` (the acceptance bar is ≥ 90% of delivered frames)."""
    starts = {ev["id"] for ev in chrome_events if ev.get("ph") == "s"}
    ends = {ev["id"] for ev in chrome_events if ev.get("ph") == "f"}
    return {"flow_starts": float(len(starts)),
            "flow_ends": float(len(ends)),
            "flow_pairs": float(len(starts & ends))}


# -- roofline of the distill step --------------------------------------------


def distill_step_cost(trainer, hw: HardwareSpec = H100
                      ) -> Dict[str, Dict[str, float]]:
    """The counted cost of each architecture's distill update
    (`core.runtime.distill_update`: Eq. (1), its gradients and the
    optimizer's update) on the card.

    The runtime records the update's arguments on the meta device the
    first time each bundle takes a distillation step
    (``trainer._distill_arg_shapes``); counting the update again on fresh
    meta copies (`roofline.op_cost`) gives its FLOPs by type, bytes,
    peak memory and argument bytes, and leaves the trainer untouched. Attainable FLOP/s is
    the roofline ``min(typed peak, bw · intensity)`` on ``hw``. Returns {}
    for trainers that never distilled (or baselines without the
    record)."""
    from repro_torch.core.runtime import distill_update, meta_like
    from repro_torch.roofline.op_cost import OpCounter, tree_bytes

    shapes = getattr(trainer, "_distill_arg_shapes", None) or {}
    bundles = {c.bundle.name: c.bundle for c in getattr(trainer, "clients",
                                                        ())}
    out: Dict[str, Dict[str, float]] = {}
    for name, (*args, step, has_rng) in shapes.items():
        args = meta_like(tuple(args))
        # the confidence draws on meta take a CPU generator
        rng = torch.Generator().manual_seed(0) if has_rng else None
        with OpCounter(args=args) as counter:
            distill_update(bundles[name], trainer.optimizer,
                           trainer.mhd_cfg, *args, step, rng)
        cost = counter.to_dict()
        flops, nbytes = cost["flops"], cost["bytes"]
        out[name] = dict(cost)
        out[name]["intensity"] = flops / nbytes if nbytes else 0.0
        out[name]["attainable_flops_per_s"] = hw.attainable_flops_per_s(
            cost)
        # the update's memory: what it made and held at its peak, and what
        # it was given (the client's params and optimizer state among it)
        out[name]["peak_bytes"] = float(counter.peak_bytes)
        out[name]["argument_bytes"] = float(tree_bytes(args))
        out[name]["state_bytes"] = float(tree_bytes(args[:2]))
    return out


def _achieved_flops(roofline: Dict[str, Dict[str, float]],
                    tracer) -> None:
    """Annotate each bundle's roofline row with the achieved FLOP/s from
    its traced ``runtime/distill`` span durations (in place)."""
    if tracer is None:
        return
    durs: Dict[str, List[float]] = defaultdict(list)
    for ev in tracer.events():
        if ev["ph"] == "X" and ev["name"] == "runtime/distill":
            b = ev.get("args", {}).get("bundle")
            if b is not None:
                durs[b].append(ev["dur"])
    for name, row in roofline.items():
        if durs.get(name):
            mean_s = sum(durs[name]) / len(durs[name])
            row["distill_span_mean_s"] = mean_s
            row["achieved_flops_per_s"] = (
                row["flops"] / mean_s if mean_s > 0 else 0.0)
            att = row.get("attainable_flops_per_s", 0.0)
            row["roofline_fraction"] = (
                row["achieved_flops_per_s"] / att if att else 0.0)


# -- the snapshot ------------------------------------------------------------


@dataclasses.dataclass
class ObsSnapshot:
    """One run's observability state, all-float leaves (JSON-safe)."""

    comm: Dict[str, float]
    gates: Dict[int, Dict[str, float]]
    freshness: Dict[int, Dict[str, float]]
    tracer_stats: Dict[str, float]
    phases: Dict[int, Dict[str, float]]
    roofline: Dict[str, Dict[str, float]]

    def to_metrics(self) -> Dict[str, float]:
        """Flatten under the ``obs/`` namespace for the unified metric
        dict (`Experiment.run()`)."""
        out: Dict[str, float] = {}
        for k, v in self.comm.items():
            out[f"obs/comm/{k}"] = float(v)
        for cid, g in self.gates.items():
            for k, v in g.items():
                out[f"obs/gate/c{cid}/{k}"] = float(v)
        for cid, f in self.freshness.items():
            for k, v in f.items():
                out[f"obs/fresh/c{cid}/{k}"] = float(v)
        for k, v in self.tracer_stats.items():
            out[f"obs/trace/{k}"] = float(v)
        for pid, row in self.phases.items():
            for k, v in row.items():
                out[f"obs/phase/r{pid}/{k}"] = float(v)
        for name, row in self.roofline.items():
            for k, v in row.items():
                out[f"obs/roofline/{name}/{k}"] = float(v)
        return out


def collect_obs(trainer=None, scheduler=None, tracer=None,
                hw: HardwareSpec = H100,
                with_roofline: bool = False) -> ObsSnapshot:
    """Assemble the snapshot from whatever sources exist; every argument
    is optional and a missing source contributes an empty section.
    ``with_roofline`` gates the count of each distill update (one more
    run of it on meta — cheap but not free, so opt-in)."""
    comm: Dict[str, float] = {}
    gates: Dict[int, Dict[str, float]] = {}
    meter = getattr(trainer, "meter", None)
    if meter is not None:
        comm = meter.summary()
        gates = meter.gate_summary()

    freshness: Dict[int, Dict[str, float]] = {}
    if scheduler is not None:
        freshness = scheduler.freshness_report()

    tracer_stats: Dict[str, float] = {}
    phases: Dict[int, Dict[str, float]] = {}
    if tracer is not None:
        from repro_torch.obs.export import to_chrome_events

        tracer_stats = tracer.stats()
        phases = phase_attribution(
            to_chrome_events(tracer.events(), pid=tracer.rank))

    roofline: Dict[str, Dict[str, float]] = {}
    if with_roofline and trainer is not None:
        roofline = distill_step_cost(trainer, hw=hw)
        _achieved_flops(roofline, tracer)

    return ObsSnapshot(comm=comm, gates=gates, freshness=freshness,
                       tracer_stats=tracer_stats, phases=phases,
                       roofline=roofline)
