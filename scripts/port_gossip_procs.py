#!/usr/bin/env python
"""Run a socket-transport gossip experiment on the PyTorch port as one OS
process per client (the port's twin of ``scripts/run_gossip_procs.py``).

    python scripts/port_gossip_procs.py                   # 4-proc ring, card
    python scripts/port_gossip_procs.py --preset gossip_socket \
        --steps 20 --throttle 3:50 --out gossip.json
    python scripts/port_gossip_procs.py --smoke           # 2 procs, 8 steps
    python scripts/port_gossip_procs.py --smoke --device cpu
    python scripts/port_gossip_procs.py --lm-smoke --device cpu

Each client is a real OS process with its own `SocketTransport` listener,
gossiping top-k prediction windows over localhost TCP
(`repro_torch.launch.gossip`), each on the card (one CUDA context a
process) unless ``--device cpu`` is given. ``--throttle RANK:MS`` sleeps
MS milliseconds after each of that rank's local steps — a genuine
wall-clock straggler, not a simulated one.

``--smoke``: 2 clients, 8 steps, a 120-second cap. Exits non-zero if any
client finishes without ever distilling from a neighbor, or if delivered
!= offered on an edge of the lossless localhost wire.

``--scoreboard-smoke``: a 3-process ring with ``schedule.mode=
"scoreboard"`` and one heavily paced wall-clock straggler. Lock-step would
drag every rank down to the straggler's wall clock; the smoke exits
non-zero unless the fast ranks finish in under 0.5x the straggler's
step-loop wall and delivery is lossless on every edge.

``--churn-smoke``: a 3-process ring with per-rank fleet snapshots and
``init_scheme="per_client"`` where rank 1 is crashed at local step 5
(``os._exit``). The launch must fail promptly naming rank 1 (fleet
reaping, not the hard-timeout backstop); the relaunch with
``resume=True`` restores every rank from its own snapshot slice, and the
restored rank must start from step 3 or later and distill again.

``--lm-smoke``: the heterogeneous-LM fleet (``lm_hetero``: a Mamba2 SSM,
a dense transformer and a MoE transformer) as 3 processes for 12 steps on
the entropy-adaptive, delta-compressed wire, a 150-second cap. Exits
non-zero unless every client distills, delivery is lossless edge by edge
and the mean frame stays under the budget's shape-computed ceiling
(`repro_torch.lm.adaptive_frame_max_nbytes`).

The smoke functions take a base spec, a device and a child hook, so
chip_smoke.py drives the same smokes at full ResNet-18 width.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def parse_throttle(items):
    out = {}
    for item in items or ():
        rank, _, ms = item.partition(":")
        out[int(rank)] = float(ms)
    return out


def resize(spec, clients: int, **train):
    """``spec`` with a uniform fleet of ``clients`` (its first client's
    arch, aux heads and width) and ``train`` fields replaced."""
    from repro_torch.exp import ExperimentSpec

    c = spec.clients[0]
    return dataclasses.replace(
        spec, clients=ExperimentSpec.uniform_fleet(
            clients, arch=c.arch, aux_heads=c.aux_heads, width=c.width),
        train=dataclasses.replace(spec.train, **train))


def lossless_failures(results) -> list:
    """The lossless-localhost check: delivered == offered on every edge,
    unless the transport metered a real loss (failed sends, tombstoned
    mail) — then delivered < offered is the truth, not a bug."""
    from repro_torch.launch import delivery_gaps, fleet_summary

    fleet = fleet_summary(results)
    out = []
    if fleet["delivered_bytes"] > fleet["offered_bytes"]:
        out.append("delivered bytes exceed offered bytes")
    if fleet["failed_sends"] == 0 and \
            not any(r.get("tombstoned_bytes", 0) for r in results.values()):
        gaps = delivery_gaps(results)
        if gaps:
            out.append("delivered != offered on lossless localhost: "
                       + "; ".join(f"edge {e}: {d}/{o} B"
                                   for e, (o, d) in sorted(gaps.items())))
    if fleet["distill_steps_min"] < 1:
        out.append("a client never distilled from a neighbor")
    return out


def print_ranks(results) -> None:
    for rank in sorted(results):
        r = results[rank]
        print(f"  client {rank} on {r['device']}: "
              f"{r['steps'] - r['start_step']} steps in "
              f"{r['wall_seconds']:.2f}s (spawn {r['spawn_s']:.2f}s, setup "
              f"{r['setup_s']:.2f}s, "
              f"rendezvous {r['rendezvous_s']:.2f}s, finish barrier "
              f"{r['barrier_wait_s']:.2f}s), loss {r['final_loss']:.3f}, "
              f"distilled on {r['distill_steps']} steps, rx "
              f"{r['delivered_bytes']:,.0f} B / tx "
              f"{r['offered_bytes']:,.0f} B", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="gossip_socket")
    p.add_argument("--spec", help="ExperimentSpec JSON file (overrides "
                   "--preset; must use transport kind 'socket')")
    p.add_argument("--steps", type=int, help="override train.steps")
    p.add_argument("--clients", type=int,
                   help="override fleet size (uniform fleet)")
    p.add_argument("--throttle", action="append", metavar="RANK:MS",
                   help="sleep MS ms after each local step of RANK "
                        "(repeatable) — a real wall-clock straggler")
    p.add_argument("--timeout", type=float, default=300.0,
                   help="hard cap on the whole run (seconds)")
    p.add_argument("--device", default=None,
                   help="where every client runs: the card unless 'cpu'")
    p.add_argument("--smoke", action="store_true",
                   help="bounded config: 2 clients, 8 steps, 120 s cap")
    p.add_argument("--churn-smoke", action="store_true",
                   help="bounded config: 3-process kill-and-restore "
                        "(crash rank 1, resume the fleet from snapshots)")
    p.add_argument("--scoreboard-smoke", action="store_true",
                   help="bounded config: 3-process scoreboard run with a "
                        "paced straggler; fast ranks must beat the "
                        "lock-step bound")
    p.add_argument("--lm-smoke", action="store_true",
                   help="bounded config: the mixed-arch LM fleet "
                        "(lm_hetero) as 3 processes, 12 steps; every client "
                        "distills, lossless delivery, frames within the "
                        "budget's ceiling")
    p.add_argument("--out", metavar="PATH",
                   help="write per-rank results + fleet summary JSON")
    p.add_argument("--trace-dir", metavar="DIR",
                   help="enable repro_torch.obs tracing: per-rank Chrome "
                        "traces + a merged fleet timeline under DIR, "
                        "validated after the run")
    args = p.parse_args(argv)

    from repro_torch.exp import ExperimentSpec, get_preset
    from repro_torch.launch import fleet_summary, launch_gossip

    if args.lm_smoke:
        return report(lm_smoke(device=args.device))
    if args.churn_smoke:
        return report(churn_smoke(device=args.device))
    if args.scoreboard_smoke:
        return report(scoreboard_smoke(device=args.device))

    if args.spec:
        with open(args.spec) as f:
            spec = ExperimentSpec.from_json(f.read())
    else:
        spec = get_preset(args.preset)
    timeout = args.timeout
    if args.smoke:
        args.clients, args.steps, timeout = 2, 8, 120.0
    if args.clients:
        spec = resize(spec, args.clients)
    if args.steps:
        spec = resize(spec, spec.num_clients, steps=args.steps)
    if args.trace_dir:
        spec = resize(spec, spec.num_clients, trace_dir=args.trace_dir)

    K = spec.num_clients
    if args.smoke:
        warm_kernels(spec, args.device)
    print(f"{spec.name}: {K} clients as {K} OS processes over TCP, "
          f"{spec.train.steps} local steps each (timeout {timeout:.0f}s)",
          flush=True)
    results = launch_gossip(spec, timeout=timeout, device=args.device,
                            throttle_ms=parse_throttle(args.throttle))
    fleet = fleet_summary(results)
    print_ranks(results)
    print(f"fleet: offered {fleet['offered_bytes']:,.0f} B, delivered "
          f"{fleet['delivered_bytes']:,.0f} B, "
          f"{fleet['distill_steps_total']:.0f} distillation steps, "
          f"{fleet['failed_sends']:.0f} failed sends")

    if args.out:
        with open(args.out, "w") as f:
            json.dump({"spec": spec.to_dict(),
                       "results": {str(k): v for k, v in results.items()},
                       "fleet": fleet}, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"wrote {args.out}")

    failures = lossless_failures(results)
    if args.trace_dir:
        failures += check_trace(args.trace_dir, K, fleet)
    return report({"failures": failures,
                   "summary": "every client distilled, delivered == "
                              "offered on every edge"})


def report(rep) -> int:
    for msg in rep["failures"]:
        print(f"FAIL: {msg}", file=sys.stderr)
    if not rep["failures"]:
        print("ok" + (f": {rep['summary']}" if rep.get("summary") else ""))
    return 1 if rep["failures"] else 0


def check_trace(trace_dir: str, num_ranks: int, fleet) -> list:
    """The merged fleet trace a traced gossip run must produce: it parses
    as Chrome trace JSON, every rank's track carries at least one distill
    span, the cross-process flow events pair up for the bulk of delivered
    frames, and waiting stays a small slice of the traced wall."""
    from repro_torch.obs import load_trace
    from repro_torch.obs.metrics import flow_coverage, phase_attribution

    merged = os.path.join(trace_dir, "trace_merged.json")
    if not os.path.exists(merged):
        return [f"traced run produced no {merged}"]
    try:
        events = load_trace(merged)["traceEvents"]
    except (ValueError, KeyError) as e:
        return [f"merged trace unreadable: {e}"]
    out = []
    distill_ranks = {ev["pid"] for ev in events
                     if ev["ph"] == "X" and ev["name"] == "runtime/distill"}
    missing = sorted(set(range(num_ranks)) - distill_ranks)
    if missing:
        out.append(f"ranks {missing} contributed no distill span to the "
                   "merged trace")
    cov = flow_coverage(events)
    delivered = fleet["delivered_messages"]
    if delivered and cov["flow_pairs"] < 0.9 * delivered:
        out.append(f"only {cov['flow_pairs']:.0f} send→delivery flow pairs "
                   f"for {delivered:.0f} delivered frames (<90%)")
    phases = phase_attribution(events)
    wall = sum(r["wall"] for r in phases.values())
    waiting = sum(r["drain_wait"] + r["barrier"] for r in phases.values())
    if wall and waiting > 0.25 * wall:
        out.append(f"drain_wait + barrier = {waiting:.1f}s of {wall:.1f}s "
                   f"traced wall (> 25%)")
    if not out:
        print(f"trace ok: {merged} — {len(events)} events, "
              f"{len(distill_ranks)} ranks with distill spans, "
              f"{cov['flow_pairs']:.0f}/{delivered:.0f} flow pairs, "
              f"drain_wait+barrier {waiting:.1f}s/{wall:.1f}s")
    return out


def warm_kernels(spec, device=None, child_init=None) -> None:
    """On the card: run two steps of ``spec`` in this process over
    loopback, so Triton's cache under build/ holds the kernels at this
    fleet's shapes and no child compiles them. Nothing to do on the CPU."""
    import torch

    from repro_torch.exp import Experiment, ScheduleSpec, TransportSpec

    if torch.device("cuda" if device is None else device).type == "cpu":
        return
    if child_init is not None:
        child_init()
    warm = dataclasses.replace(
        spec, name=f"{spec.name}_warm",
        transport=TransportSpec(kind="loopback"),
        schedule=ScheduleSpec(),
        train=dataclasses.replace(spec.train, steps=2, snapshot_dir=None,
                                  snapshot_every=0, trace_dir=None))
    t0 = time.monotonic()
    Experiment(warm, device=device).run()
    torch.cuda.empty_cache()
    print(f"kernels warmed in {time.monotonic() - t0:.1f}s", flush=True)


def scoreboard_smoke(base=None, device=None, child_init=None,
                     slow_pace_ms: float = 2000.0, straggler: int = 2,
                     timeout: float = 120.0, warm: bool = True) -> dict:
    """The out-of-order scheduling win over real processes: a 3-process
    ring (``base``: the gossip_socket preset) where one rank is paced at
    ``slow_pace_ms`` a step, gated by per-child `GossipPacer`s. The fast
    ranks must finish their step loops in < 0.5x the straggler's wall,
    and delivery must stay lossless edge by edge. ``warm=False`` skips
    the in-process warm-up (the caller compiled the kernels already).
    Returns the report (``failures`` empty when it passed)."""
    from repro_torch.exp import ScheduleSpec, get_preset
    from repro_torch.launch import fleet_summary, launch_gossip

    spec = resize(base or get_preset("gossip_socket"), 3, steps=16)
    # runahead > the straggler's publish gap (pool_update_every=5) so the
    # gate releases on its first publish rather than deadlocking, but <
    # steps so it can engage mid-run
    pace = [0.0] * 3
    pace[straggler] = slow_pace_ms
    spec = dataclasses.replace(
        spec, name="scoreboard_smoke",
        schedule=ScheduleSpec(mode="scoreboard", runahead=12,
                              pace_ms=tuple(pace))).validate()
    if warm:
        warm_kernels(spec, device, child_init)
    print(f"scoreboard smoke: 3 processes, rank {straggler} paced at "
          f"{slow_pace_ms:.0f} ms/step, runahead {spec.schedule.runahead}",
          flush=True)
    results = launch_gossip(spec, timeout=timeout, device=device,
                            child_init=child_init)
    fleet = fleet_summary(results)
    print_ranks(results)
    fast_wall = max(r["wall_seconds"] for rank, r in results.items()
                    if rank != straggler)
    slow_wall = results[straggler]["wall_seconds"]
    failures = lossless_failures(results)
    if fast_wall >= 0.5 * slow_wall:
        failures.append(f"fast ranks took {fast_wall:.2f}s against the "
                        f"straggler's {slow_wall:.2f}s — no better than the "
                        "lock-step bound")
    # the run-ahead credit is timing-dependent on a loaded host (the
    # straggler's publish can land just before the fast ranks hit the
    # gate), so backpressure is reported, not asserted
    print(f"fleet backpressure: {fleet['backpressure_seconds']:.2f}s over "
          f"{fleet['backpressure_events']:.0f} waits")
    return {"results": results, "fleet": fleet, "fast_wall_s": fast_wall,
            "slow_wall_s": slow_wall, "slow_pace_ms": slow_pace_ms,
            "failures": failures,
            "summary": f"fast wall {fast_wall:.2f}s vs straggler "
                       f"{slow_wall:.2f}s"}


def churn_smoke(base=None, device=None, child_init=None,
                crash_rank: int = 1, crash_step: int = 5,
                timeout: float = 50.0, snap_dir=None,
                warm: bool = True) -> dict:
    """Kill-and-restore over real processes: crash one rank mid-run, then
    resume the whole fleet from its per-rank snapshots (under
    ``snap_dir``, or a temporary directory). Returns the report
    (``failures`` empty when it passed)."""
    from repro_torch.exp import get_preset
    from repro_torch.launch import fleet_summary, launch_gossip

    own_dir = snap_dir is None
    snap_dir = tempfile.mkdtemp(prefix="fleet_churn_smoke_") if own_dir \
        else str(snap_dir)
    spec = resize(base or get_preset("gossip_socket"), 3, steps=8,
                  batch_size=16, snapshot_dir=snap_dir, snapshot_every=3)
    spec = dataclasses.replace(
        spec, name="churn_smoke",
        init_scheme="per_client",  # each child inits only its own model
        # a short horizon keeps the per-publish encode cheap; the
        # restored mailbox's window still covers the resumed steps
        wire=dataclasses.replace(spec.wire, horizon=10)).validate()
    failures = []
    rep = {"failures": failures}
    try:
        if warm:
            warm_kernels(spec, device, child_init)
        print(f"churn smoke: 3 processes, crash rank {crash_rank} at local "
              f"step {crash_step}, snapshots every "
              f"{spec.train.snapshot_every} steps", flush=True)
        t0 = time.monotonic()
        try:
            launch_gossip(spec, timeout=timeout, device=device,
                          die_at={crash_rank: crash_step},
                          child_init=child_init)
        except RuntimeError as e:
            rep["crash_detect_s"] = elapsed = time.monotonic() - t0
            rep["crash_error"] = str(e).splitlines()[0]
            print(f"crash detected in {elapsed:.1f}s: {e}", flush=True)
            if f"client {crash_rank}" not in str(e):
                failures.append("the error does not name the crashed rank")
            if elapsed > 0.8 * timeout:
                failures.append("crash detection leaned on the hard timeout")
        else:
            failures.append("the injected crash was not detected")
            return rep

        t0 = time.monotonic()
        results = launch_gossip(spec, timeout=timeout, device=device,
                                resume=True, child_init=child_init)
        rep["resume_s"] = time.monotonic() - t0
        fleet = fleet_summary(results)
        print_ranks(results)
        r = results[crash_rank]
        # fleet-wide delivered <= offered does NOT hold here — the crashed
        # rank's restored offered book rolled back to its last snapshot
        # while survivors' delivered books kept mail it sent after that
        # point (per-rank snapshots are uncoordinated cuts); the
        # invariant the smoke owns is "the restored client trains and
        # distills again"
        print(f"resumed: rank {crash_rank} restored at step "
              f"{r['start_step']}, distilled on {r['distill_steps']} "
              f"post-restore steps; fleet delivered "
              f"{fleet['delivered_bytes']:,.0f} / offered "
              f"{fleet['offered_bytes']:,.0f} B")
        rep.update(results=results, fleet=fleet,
                   summary=f"rank {crash_rank} resumed at step "
                           f"{r['start_step']}")
        if r["start_step"] < 3:
            failures.append("the crashed rank did not restore from its "
                            "snapshot at step 3 or later")
        if r["distill_steps"] < 1:
            failures.append("the restored client never distilled "
                            "post-restore")
        return rep
    finally:
        if own_dir:
            shutil.rmtree(snap_dir, ignore_errors=True)


def lm_frame_ceiling(spec) -> tuple:
    """The budget ledger of an LM spec's wire: (the largest frame in
    bytes, the tokens a frame covers). Every published frame covers
    horizon windows x `lm_wire_tokens` tokens, and its size is bounded by
    the shape-computed ceiling (header + ids + k-map + lse lanes plus
    budget_bytes_per_token for the value/index streams); the delta
    compression only ever shrinks frames, so the raw ceiling still bounds
    the compressed wire."""
    from repro_torch.lm import adaptive_frame_max_nbytes, lm_wire_tokens

    tokens = lm_wire_tokens(spec.train.public_batch_size,
                            spec.data.seq_len, spec.data.max_positions)
    ceiling = adaptive_frame_max_nbytes(
        window=spec.wire.horizon, seq_batch=spec.train.public_batch_size,
        tokens=tokens, num_heads=spec.clients[0].aux_heads + 1,
        budget_bytes_per_token=spec.wire.budget_bytes_per_token,
        emb_dim=0)
    return ceiling, spec.wire.horizon * tokens


def lm_smoke(base=None, device=None, child_init=None, steps: int = 12,
             timeout: float = 150.0, warm: bool = True) -> dict:
    """The heterogeneous-LM fleet over real processes: the ``lm_hetero``
    preset (``base``) — an SSM, a dense transformer and a small MoE
    distilling each other's next-token predictions — as 3 OS processes
    over TCP on the entropy-adaptive, delta-compressed wire, ``steps``
    local steps each. Three checks: every client distills from a
    neighbor, localhost delivery is lossless edge by edge, and the
    measured mean frame stays inside the budget's shape-computed ceiling.
    Returns the report (``failures`` empty when it passed)."""
    from repro_torch.exp import get_preset
    from repro_torch.launch import fleet_summary, launch_gossip

    spec = base or get_preset("lm_hetero")
    spec = dataclasses.replace(
        spec, name="lm_smoke",
        train=dataclasses.replace(spec.train, steps=steps)).validate()
    if warm:
        warm_kernels(spec, device, child_init)
    print(f"lm smoke: 3 processes "
          f"({'/'.join(c.arch for c in spec.clients)}), "
          f"{spec.train.steps} steps, budget "
          f"{spec.wire.budget_bytes_per_token} B/token, "
          f"compression {spec.wire.compression}", flush=True)
    t0 = time.monotonic()
    results = launch_gossip(spec, timeout=timeout, device=device,
                            child_init=child_init)
    launch_s = time.monotonic() - t0
    fleet = fleet_summary(results)
    for rank in sorted(results):
        r = results[rank]
        print(f"  client {rank} ({spec.clients[rank].arch}): "
              f"{r['steps']} steps in {r['wall_seconds']:.1f}s, "
              f"loss {r['final_loss']:.3f}, distilled on "
              f"{r['distill_steps']}/{r['steps']} steps, rx "
              f"{r['delivered_bytes']:,.0f} B / tx "
              f"{r['offered_bytes']:,.0f} B", flush=True)
    failures = lossless_failures(results)
    ceiling, tokens_per_msg = lm_frame_ceiling(spec)
    n_msgs = fleet["offered_messages"]
    mean_frame = fleet["offered_bytes"] / max(n_msgs, 1)
    print(f"wire: {n_msgs:.0f} frames, mean {mean_frame:,.0f} B "
          f"({mean_frame / tokens_per_msg:.1f} B/token) vs ceiling "
          f"{ceiling:,d} B ({ceiling / tokens_per_msg:.1f} B/token)",
          flush=True)
    if not n_msgs:
        failures.append("no frame was published")
    if mean_frame > ceiling:
        failures.append(f"mean frame {mean_frame:,.0f} B exceeds the "
                        f"budget ceiling {ceiling:,d} B")
    return {"results": results, "fleet": fleet, "launch_s": launch_s,
            "mean_frame": mean_frame, "ceiling": ceiling,
            "failures": failures,
            "summary": "all 3 archs distilled, delivery lossless, "
                       "bytes/token within budget"}


if __name__ == "__main__":
    sys.exit(main())
