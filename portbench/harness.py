"""One run of one cell: set-up, the measured window, the traced round,
the reference, the result line.

Set-up is everything from process start to the window: the data and
each client's weights from ``--seed``, the trainer's construction and
seed publish, and one whole round of steps (S_P steps, the last of them
publishing), which warms up every shape the window runs and is the
stretch the reference follows. The window then runs whole rounds from
the same step on every run, each step ended by
``torch.cuda.synchronize()``, until ``--seconds`` have passed at the end
of a round: every window holds the same mix of plain and publishing
steps. With ``--trace 1`` the program's tracer is on during the window
and one more round runs under torch.profiler after it.
"""
from __future__ import annotations

import gc
import math
import resource
import subprocess
import sys
import time
import types
from typing import Dict, List, Optional

import torch

from portbench import check, spec, timeline
from portbench import weights as W


def _power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


class Cell:
    """A cell's configuration and traffic, loaded by name or given."""

    def __init__(self, name: str, config: dict, traffic: dict,
                 limits: Dict[str, float]):
        self.name, self.config, self.traffic = name, config, traffic
        self.limits = limits

    @classmethod
    def named(cls, name: str) -> "Cell":
        w = spec.cell(name)
        return cls(name, spec.config(w["config"]), spec.traffic(w["traffic"]),
                   spec.limits(name))


class Prepared(types.SimpleNamespace):
    """What set-up hands the window: the trainer, the benchmark's data, the
    program's readings over the checked steps (its feed with them), and
    the next step."""


def prepare(cell: Cell, seed: int, device: torch.device,
            whole_round: bool = True) -> Prepared:
    """Set-up: the data and weights from ``seed``, the trainer, and one
    whole round of steps whose first ``checked_steps`` the reference
    follows (only those, without ``whole_round``: the calibration). Each
    phase's seconds go to ``phases``."""
    from portbench import fleet

    config, traffic = cell.config, cell.traffic
    tf32 = bool(config.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    K = traffic["clients"]
    round_len = traffic["mhd"]["pool_update_every"]
    S = traffic["checked_steps"]
    if S > round_len:
        raise ValueError("the checked steps must lie in the warm-up round")
    ref = check.reference_module(config["reference"])
    parts = spec.parts(traffic)
    cfg = fleet.model_config(config)
    leaves = ref.leaves(config)
    if fleet.param_shapes(cfg) != leaves:
        raise ValueError("the program's parameters are not the reference's")

    phases, t_phase = {}, time.perf_counter()

    def phase(name):
        nonlocal t_phase
        _sync(device)
        now = time.perf_counter()
        phases[name] = now - t_phase
        t_phase = now

    phase("program_import")
    data = spec.part("data", traffic["data"]["kind"]).make(traffic, seed)
    phase("data")
    weights = [W.make_weights(leaves, ref.init_kind, seed, i, device)
               for i in range(K)]
    phase("weights")
    trainer = fleet.build_trainer(cfg, traffic, data, weights, device)
    phase("trainer_init_and_seed_publish")
    rec = fleet.Recorder(trainer, parts["wire"], traffic)
    program = check.Readings(K)
    program.windows, program.feed = rec.windows, rec
    for t in range(round_len if whole_round else S):
        m = trainer.step(t)
        _sync(device)
        if t < S:
            for i in range(K):
                program.loss[i].append(m[f"c{i}/loss"])
        if t == 0:
            for i in range(K):
                program.grad[i] = parts["optim"].first_gradient(
                    trainer.clients[i].opt_state)
        if t == S - 1:
            rec.close()
            for i in range(K):
                now = trainer.clients[i].params
                program.change[i] = {k: float(torch.linalg.vector_norm(
                    now[k].double() - weights[i][k].double()))
                    for k in now}
            del weights
    phase("warmup_round")
    return Prepared(trainer=trainer, data=data, program=program,
                    leaves=leaves, next_step=round_len, phases=phases)


def free(prep: Prepared, device: torch.device) -> None:
    """Drop the program's state before the reference runs."""
    prep.trainer = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(cell: Cell, seed: int, seconds: float, traced: bool,
        device: torch.device, started: float, metric_names: List[str]
        ) -> dict:
    """One run; returns the result line's object."""
    from repro_torch.kernels import ops
    from repro_torch.obs import tracer

    traffic = cell.traffic
    K = traffic["clients"]
    round_len = traffic["mhd"]["pool_update_every"]
    before = time.perf_counter() - started
    prep = prepare(cell, seed, device)
    prep.phases["start_and_imports"] = before
    trainer, leaves = prep.trainer, prep.leaves
    setup_s = time.perf_counter() - started

    # -- the window -----------------------------------------------------
    if traced:
        spans_tr = tracer.enable()

    def one_step(t: int) -> dict:
        m = trainer.step(t)
        _sync(device)
        return {"publish": (t + 1) % round_len == 0,
                "distill": [bool(m[f"c{i}/distill_active"])
                            for i in range(K)],
                "finite": all(math.isfinite(m[f"c{i}/loss"])
                              for i in range(K))}

    steps, window_s = run_window(one_step, prep.next_step, round_len,
                                 seconds)
    t = prep.next_step + len(steps)
    metrics: Dict[str, dict] = {}
    prof = None
    if traced:
        spans = timeline.host_spans(spans_tr.events())
        tracer.disable()
        costs = {k: spec.kernel_costs(k) for k in spec.kernels_with_costs()}
        first = t

        def one_round():
            for u in range(first, first + round_len):
                trainer.step(u)

        prof = timeline.profile_round(one_round, ops, costs, tracer)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    batch = traffic["batch"]
    if traced:
        n_params = sum(math.prod(s) for s in leaves.values())
        r = types.SimpleNamespace(
            steps=steps, window_s=window_s, spans=spans,
            rounds=sum(st["publish"] for st in steps), profile=prof,
            peaks=spec.load_json(spec.HERE / "peaks.json"), costs=costs,
            params=n_params, traffic=traffic)
        for name, unit in metric_names:
            value = spec.metric_reader(name)(r)
            if value is not None:
                metrics[name] = {"value": value, "unit": unit}
    else:
        metrics["fleet_samples_per_s"] = {
            "value": fleet_rate(len(steps), K, batch, window_s),
            "unit": "samples/s"}
        metrics["peak_mem_gib"] = {"value": peak / 2 ** 30, "unit": "GiB"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}

    # -- the reference, once the program's state is freed -----------------
    del trainer
    free(prep, device)
    t_ref = time.perf_counter()
    reference = check.run_reference(cell.config, traffic, seed, prep.data,
                                    device)
    prep.phases["reference"] = time.perf_counter() - t_ref
    numbers = check.gaps(prep.program, reference)
    checks = {k: {"value": numbers[k], "limit": cell.limits[k]}
              for k in check.NUMBERS}
    result = {
        "correct": all(v["value"] <= v["limit"] for v in checks.values()),
        "attempted": K * len(steps),
        "failed": sum(0 if st["finite"] else K for st in steps),
        "metrics": metrics,
        "device": _device(device, peak),
        "setup_s": setup_s, "window_s": window_s,
        "step_seconds": [st["seconds"] for st in steps],
        "phases": prep.phases,
        "host_rss_peak_bytes": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss * 1024,
        "worst_leaves": {k: numbers[k] for k in ("grad_leaf",
                                                 "change_leaf")},
    }
    if traced:
        result["device"]["busy_s"] = timeline.device_busy(prof)
        result["device"]["window_s"] = prof["t1"] - prof["t0"]
        result["breakdown"] = timeline.breakdown(prof)
    result["checks"] = checks
    return result


def run_window(one_step, first: int, round_len: int, seconds: float,
               clock=time.perf_counter):
    """Whole rounds of ``round_len`` steps from step ``first`` until
    ``seconds`` have passed at the end of a round. Returns each step's
    record (``one_step(t)``'s, with its ``t`` and ``seconds``) and the
    window's length, from the first step's start to the last step's end:
    a fleet rate over it counts every step and every stall."""
    steps: List[dict] = []
    t = first
    t0 = clock()
    while True:
        for _ in range(round_len):
            a = clock()
            rec = one_step(t)
            rec.update(t=t, seconds=clock() - a)
            steps.append(rec)
            t += 1
        elapsed = clock() - t0
        if elapsed >= seconds:
            return steps, elapsed


def fleet_rate(steps: int, clients: int, batch: dict,
               window_s: float) -> float:
    """Sequences given to every client's steps over the window's time:
    K × (private + public) a step."""
    return clients * (batch["private"] + batch["public"]) * steps / window_s


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device(device: torch.device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(peak),
            "power_limit_w": _power_limit_w()}


def report(result: dict, out=sys.stdout, err=sys.stderr) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output, with the checks last."""
    import json

    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
