"""Multi-process gossip launcher: one OS process per client over TCP (port
of ``repro/launch/gossip.py``).

The paper's agents are independent learners exchanging predictions over
a network; this launcher makes that literal on one host. Given an
`ExperimentSpec` with ``transport.kind == "socket"`` and a decentralized
algorithm, ``launch_gossip(spec)`` spawns one OS process per client.
Each child:

  1. resolves its device (the card unless the caller passes
     ``device="cpu"``; a child that finds no card raises, and the
     launcher reports its rank as failed — nothing falls back to the
     CPU);
  2. builds a `SocketTransport` hosting only its own client (binding an
     OS-assigned port) and reports the port to the launcher, which
     gathers the full port map and broadcasts it back — a race-free
     rendezvous, no pre-allocated ports needed;
  3. opens its outgoing per-edge connections from the communication
     graph (with retries, so processes may start in any order);
  4. constructs the trainer restricted to its client
     (``Bindings.local_clients``) on the data the launcher built once
     for the whole fleet (written once to a file that every child
     reads, so starting a child never waits on another one's imports),
     and drives its own local loop: its local step
     count is its own clock, public batches are sampled from the shared
     deterministic `PublicPool` indices, publishes happen every S_P
     *local* steps, and the socket is drained every step.
     Heterogeneous step rates are real wall-clock speed differences
     between processes (``throttle_ms`` makes a deliberate straggler),
     not simulation ticks.

Children are started with ``spawn`` (CUDA does not survive a fork). Each
gets one CUDA context of its own, so K ranks time-slice one card. Before
it spawns, the launcher builds every CUDA library into ``build/``, so the
children load them instead of running K ``nvcc`` at once. The children take the caller's TF32 and cuDNN
settings; on the CPU each takes its share of the caller's torch threads,
so K children do not oversubscribe the cores the caller was given.

With ``schedule.mode == "scoreboard"`` each child additionally gates
every local step through a `core.scheduler.GossipPacer` — the
per-process reduction of the scoreboard runtime: ``schedule.pace_ms``
replaces the post-step throttle sleep (a paced client sleeps *before*
issuing, so transport drains overlap the wait), and ``schedule.runahead``
is the backpressure credit — a child more than that many local steps
ahead of its slowest in-neighbor's freshest mail waits, pumping the
socket, instead of racing ahead against ever-staler teachers.

Every child reports its metrics (loss, distillation activity, offered /
delivered meter books, and the launch count of each of the port's
kernels) through a pipe; the launcher aggregates them. A *finish*
barrier keeps every child draining its socket through the bus (metered)
until all peers have sent their last frame — so a fast client's exit
never truncates a slow one's run, and on a lossless localhost wire the
fleet's delivered book equals its offered book — and an *exit* barrier
holds sockets open until every result is collected. A hard ``timeout``
tears the fleet down rather than hanging.

Elastic fleets (`repro_torch.fleet`): when the spec sets
``train.snapshot_dir``/``snapshot_every``, each child saves *its own*
fleet snapshot slice every N local steps (``proc_r{rank}`` files, no
cross-process coordination), and ``launch_gossip(..., resume=True)``
restarts every rank from its latest snapshot. ``die_at={rank: step}``
injects a hard crash (``os._exit``, no cleanup) for testing that path.

Failure detection: the launcher watches the whole fleet while waiting on
any one child. A child that dies without reporting — before port
rendezvous or mid-run — reaps the fleet *immediately* with the failed
rank and exit signal in the error, instead of stalling every peer until
the hard timeout.
"""
from __future__ import annotations

import contextlib
import dataclasses
import multiprocessing as mp
import os
import pickle
import shutil
import tempfile
import time
import traceback
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

_DRAIN_ALL = 1 << 60  # poll step high enough to release every held frame


@dataclasses.dataclass(frozen=True)
class _ChildConfig:
    """What one child needs besides the spec: where it runs and how."""

    throttle_ms: float = 0.0
    die_at: Optional[int] = None
    resume: bool = False
    hard_timeout: float = 300.0
    device: Optional[str] = None  # None = the card
    threads: Optional[int] = None  # torch threads on the CPU
    backend: Optional[Dict[str, bool]] = None  # TF32 and cuDNN flags
    child_init: Optional[Callable[[], None]] = None
    started_at: float = 0.0  # the launcher's time.time() at the spawn


def _backend_flags() -> Dict[str, bool]:
    import torch

    return {"matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_tf32": torch.backends.cudnn.allow_tf32,
            "cudnn_deterministic": torch.backends.cudnn.deterministic,
            "cudnn_benchmark": torch.backends.cudnn.benchmark}


def _set_backend_flags(flags: Dict[str, bool]) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = flags["matmul_tf32"]
    torch.backends.cudnn.allow_tf32 = flags["cudnn_tf32"]
    torch.backends.cudnn.deterministic = flags["cudnn_deterministic"]
    torch.backends.cudnn.benchmark = flags["cudnn_benchmark"]


def _prebuild() -> None:
    """Build every CUDA library in the launcher (one nvcc per source, all
    together), so the children load what is already built."""
    from repro_torch.kernels import build

    build.build_cuda(p.stem for p in build.CSRC.glob("*.cu"))


def _child_run(spec_json: str, rank: int, conn, data_path: str,
               cfg: _ChildConfig) -> None:
    t_start = time.perf_counter()
    # the spawn itself: interpreter start and the imports its arguments
    # need, before this function runs (one host, one wall clock)
    spawn_s = time.time() - cfg.started_at
    if cfg.child_init is not None:
        cfg.child_init()
    import torch

    from repro_torch import resolve_device
    from repro_torch.comm import SocketTransport
    from repro_torch.exp import ExperimentSpec, make_algorithm
    from repro_torch.exp.algorithm import Bindings
    from repro_torch.exp.runner import (build_bundles, build_graph,
                                        build_optimizer)
    from repro_torch.kernels import ops
    from repro_torch.obs import trace

    dev = resolve_device(cfg.device)  # no card: raises, reported as failed
    if cfg.backend is not None:
        _set_backend_flags(cfg.backend)
    if dev.type == "cpu" and cfg.threads:
        torch.set_num_threads(cfg.threads)
    with open(data_path, "rb") as f:
        arrays, test_arrays, part = pickle.load(f)

    spec = ExperimentSpec.from_json(spec_json).validate()
    sched = spec.schedule
    if sched.mode == "scoreboard":
        # the child's trainer hosts a single client, so the fleet-wide
        # scoreboard reduces to a per-process GossipPacer (built below);
        # neutralize the schedule block so the adapter does not wrap the
        # trainer in an in-process scheduler on top of it
        from repro_torch.exp.spec import ScheduleSpec

        spec = dataclasses.replace(spec, schedule=ScheduleSpec())
    trace_dir = spec.train.trace_dir
    tracer = None
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        tracer = trace.enable(rank=rank, process_name=f"rank {rank}")
    t_spec = spec.transport
    ports = ({rank: t_spec.base_port + rank}
             if t_spec.base_port is not None else None)
    transport = SocketTransport(spec.num_clients, clients=[rank],
                                ports=ports, host=t_spec.host,
                                send_hard_timeout=cfg.hard_timeout,
                                wait_inflight=False)
    # rendezvous anchors: the timestamps of this two-way handshake are
    # what the parent's trace merge uses to map this process's
    # perf_counter clock onto its own (repro_torch.obs.export)
    rv0 = time.perf_counter()
    trace.set_anchor("rendezvous_send")
    conn.send(("port", rank, transport.ports[rank]))
    ports = conn.recv()
    trace.set_anchor("rendezvous_recv")
    rendezvous_s = time.perf_counter() - rv0
    trace.complete("gossip/rendezvous", rv0, rank=rank)
    transport.set_ports(ports)
    graph = build_graph(spec)
    transport.connect_edges(graph)

    algo = make_algorithm(spec)
    bindings = Bindings(
        spec=spec, arrays=arrays, test_arrays=test_arrays, partition=part,
        bundles=build_bundles(spec), optimizer=build_optimizer(spec),
        graph=graph, transport=transport, num_labels=spec.data.num_labels,
        device=dev, local_clients=(rank,))
    algo.setup(bindings)
    trainer = algo.trainer

    pacer = None
    if sched.mode == "scoreboard":
        from repro_torch.core import GossipPacer

        pace_ms = sched.pace_ms[rank] if sched.pace_ms else 0.0
        pacer = GossipPacer(trainer, rank, runahead=sched.runahead,
                            pace_s=pace_ms / 1000.0)

    snap_dir = spec.train.snapshot_dir
    snap_every = spec.train.snapshot_every
    start_step = 0
    if cfg.resume and snap_dir:
        from repro_torch.fleet.snapshot import restore_fleet

        try:
            # this rank's own slice: proc_r{rank} + client_{rank} files
            start_step = restore_fleet(snap_dir, trainer, scheduler=pacer)
        except FileNotFoundError:
            start_step = 0  # never snapshotted: a fresh start

    distill_steps = 0
    last: Dict[str, float] = {}
    # close the setup span *before* stamping the training start so the
    # two spans nest instead of overlapping by the emit call's own cost
    trace.complete("gossip/setup", t_start, rank=rank)
    t0 = time.perf_counter()
    setup_s = t0 - t_start  # imports, device, data, transport, model
    for t in range(start_step, spec.train.steps):
        if cfg.die_at is not None and t == cfg.die_at:
            os._exit(17)  # injected crash: no cleanup, no report
        if pacer is not None:
            pacer.gate(t)
        last = trainer.step(t)  # reads its metrics back: the card is done
        distill_steps += int(last.get(f"c{rank}/distill_active", 0.0))
        if snap_dir and snap_every and (t + 1) % snap_every == 0:
            from repro_torch.fleet.snapshot import save_fleet

            save_fleet(snap_dir, t + 1, trainer, scheduler=pacer)
        if cfg.throttle_ms:
            time.sleep(cfg.throttle_ms / 1000.0)
    wall = time.perf_counter() - t0
    trace.complete("gossip/train", t0, rank=rank,
                   steps=spec.train.steps - start_step)
    ev = trainer.evaluate(test_arrays)

    # finish barrier: keep draining *through the bus* (so late arrivals
    # from slower peers are metered as delivered and never back up against
    # a full kernel buffer) until every client has finished sending. The
    # barrier is *count-based*: each rank reports how many frames it
    # successfully wrote per destination, the launcher aggregates them,
    # and every rank then drains until its transport has parsed exactly
    # that many inbound frames — a deterministic quiesce, not a timed
    # grace window. Frames held back by poll's no-delivery-before-tick
    # rule are released by the _DRAIN_ALL delivery, so on a lossless
    # localhost wire the fleet's delivered book equals its offered book
    # (asserted per edge by `launch_gossip`).
    bw0 = time.perf_counter()
    conn.send(("finished", rank,
               {"sent_to": {int(d): int(n)
                            for d, n in transport.sent_to.items()}}))
    while not conn.poll(0.05):
        trainer.bus.deliver(_DRAIN_ALL)
    expected_inbound = int(conn.recv()[1])  # ("all_finished", n_frames)
    if not cfg.resume:
        drain_deadline = time.monotonic() + transport.drain_timeout
        while transport.recv_count < expected_inbound:
            if time.monotonic() >= drain_deadline:
                break  # the launcher's per-edge check will name the gap
            trainer.bus.deliver(_DRAIN_ALL)
            time.sleep(0.002)
    # resumed fleets can't reconcile counts (per-rank snapshot counters
    # are uncoordinated cuts), so they rely on the settle-based quiesce
    # alone; fresh fleets use it to meter partial-frame leftovers
    transport.quiesce(settle=0.05, timeout=2.0)
    trainer.bus.deliver(_DRAIN_ALL)  # flush the last parsed frames
    barrier_wait_s = time.perf_counter() - bw0
    trace.complete("gossip/finish_barrier", bw0, rank=rank,
                   expected_inbound=expected_inbound,
                   received=transport.recv_count)

    trace_file = None
    if tracer is not None:
        from repro_torch.obs import write_trace

        trace_file = os.path.join(trace_dir, f"trace_r{rank}.json")
        write_trace(trace_file, tracer,
                    meta={"steps": spec.train.steps,
                          "start_step": start_step,
                          "spec_name": spec.name})

    meter = trainer.meter
    conn.send(("result", rank, {
        "rank": rank,
        "steps": spec.train.steps,
        "start_step": start_step,
        "wall_seconds": wall,
        "spawn_s": spawn_s,
        "setup_s": setup_s,
        "rendezvous_s": rendezvous_s,
        "barrier_wait_s": barrier_wait_s,
        "distill_steps": distill_steps,
        "final_loss": float(last.get(f"c{rank}/loss", float("nan"))),
        "eval": {k: float(v) for k, v in ev.items()},
        "offered_bytes": float(meter.total_bytes),
        "delivered_bytes": float(meter.delivered_bytes),
        "offered_messages": float(meter.num_messages),
        "delivered_messages": float(meter.delivered_messages),
        # this rank's per-edge books: edges it *sent on* (offered, booked
        # at publish) and edges it *received on* (delivered, booked at
        # deliver) — the launcher joins them into the fleet-wide
        # delivered == offered assertion
        "offered_by_edge": {f"{s}-{d}": int(b)
                            for (s, d), b in meter.by_edge.items()},
        "delivered_by_edge": {
            f"{s}-{d}": int(b)
            for (s, d), b in meter.by_edge_delivered.items()},
        "tombstoned_bytes": float(meter.tombstoned_bytes),
        "fresh_teachers": float(sum(meter.gate_fresh.values())),
        "stale_teachers": float(sum(meter.gate_stale.values())),
        "failed_sends": transport.failed_sends,
        "drain_stalls": transport.drain_stalls,
        "undrained_bytes": transport.undrained_bytes,
        "sched": (None if pacer is None
                  else {k: float(v) for k, v in pacer.stats.items()}),
        "trace_file": trace_file,
        # the port's own keys: where the rank ran, its kernels' launches
        # over the whole run, and the card memory it peaked at
        "device": str(dev),
        "kernel_launches": ops.launch_counts(),
        "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else 0),
    }))
    conn.recv()  # "done": every result is in; sockets may now close
    transport.close()


def _child_main(spec_json: str, rank: int, conn, data_path: str,
                cfg: _ChildConfig) -> None:
    try:
        _child_run(spec_json, rank, conn, data_path, cfg)
    except Exception:
        with contextlib.suppress(Exception):
            conn.send(("error", rank, traceback.format_exc()))
        raise


def _exit_desc(exitcode: Optional[int]) -> str:
    if exitcode is not None and exitcode < 0:
        return f"killed by signal {-exitcode}"
    return f"exit code {exitcode}"


class _FleetComms:
    """Receive messages from one child while watching the *whole* fleet:
    a child that dies without reporting fails the run immediately (rank +
    exit signal in the error), instead of stalling every live peer —
    which blocks on the dead one — until the hard timeout."""

    def __init__(self, conns: List[Any], procs: List[Any]):
        self.conns = conns
        self.procs = procs
        self._stash: Dict[int, List[Any]] = defaultdict(list)

    def recv(self, rank: int, timeout: float, phase: str) -> Any:
        deadline = time.monotonic() + max(timeout, 0.0)
        while True:
            if self._stash[rank]:
                return self._stash[rank].pop(0)
            if self.conns[rank].poll(0.1):
                try:
                    return self.conns[rank].recv()
                except EOFError:
                    raise RuntimeError(
                        f"gossip client {rank} died "
                        f"({_exit_desc(self.procs[rank].exitcode)}) "
                        f"during {phase} before reporting") from None
            self._watch(rank, phase)
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"gossip client {rank} sent nothing within "
                    f"{timeout:.0f}s during {phase} "
                    f"(alive={self.procs[rank].is_alive()})")

    def _watch(self, waiting_on: int, phase: str) -> None:
        """Sweep for silently dead children. A dead child's last words
        (an 'error' report, a stashed 'finished') are drained from its
        pipe first — a traceback beats a bare exit code."""
        for r, p in enumerate(self.procs):
            if r == waiting_on or p.is_alive():
                continue
            while True:
                try:
                    if not self.conns[r].poll(0):
                        break
                    msg = self.conns[r].recv()
                except (EOFError, OSError):
                    break
                if msg[0] == "error":
                    raise RuntimeError(
                        f"gossip client {msg[1]} failed during "
                        f"{phase}:\n{msg[2]}")
                self._stash[r].append(msg)
            if not self._stash[r]:
                raise RuntimeError(
                    f"gossip client {r} died "
                    f"({_exit_desc(p.exitcode)}) during {phase} without "
                    "reporting; reaping the fleet")


def launch_gossip(spec, timeout: float = 300.0,
                  start_timeout: float = 120.0,
                  throttle_ms: Optional[Dict[int, float]] = None,
                  die_at: Optional[Dict[int, int]] = None,
                  resume: bool = False,
                  check_delivery: bool = True,
                  device: Optional[str] = None,
                  child_init: Optional[Callable[[], None]] = None,
                  ) -> Dict[int, Dict[str, Any]]:
    """Run ``spec`` as one OS process per client; returns per-rank results.

    ``throttle_ms`` sleeps that many milliseconds after each local step of
    the given ranks — a real (wall-clock) straggler. ``timeout`` bounds
    the whole run: on expiry every child is terminated and TimeoutError
    raised, so a hung socket can never wedge the caller (or CI).

    ``die_at={rank: step}`` makes those ranks crash hard (``os._exit``)
    at their given local step — the failure-injection hook behind the
    kill-and-restore smoke. ``resume=True`` restarts every rank from its
    latest fleet snapshot under ``spec.train.snapshot_dir`` (ranks with
    no snapshot start fresh).

    ``check_delivery`` (default on) asserts the lossless-localhost
    invariant after the finish barrier: every edge's delivered bytes
    equal its offered bytes, joined across the per-rank meter books.
    The check skips runs where delivered < offered is *expected* —
    resumed fleets (per-rank snapshots are uncoordinated cuts) and runs
    with failed sends or tombstoned mail (a peer actually went away).

    ``device`` is where every child runs: None = the card, which each
    child must find (it raises otherwise, failing the launch with its
    rank). The launcher builds the fleet's data once from the spec and
    hands it to every child. ``child_init`` is a picklable callable each
    child runs first (to register a client arch, say)."""
    import torch

    from repro_torch.exp.runner import materialize_data

    spec = spec.validate()
    if spec.transport.kind != "socket":
        raise ValueError(
            f"launch_gossip needs transport kind 'socket', got "
            f"{spec.transport.kind!r}")
    if spec.schedule.mode not in ("sync", "scoreboard"):
        raise ValueError(
            "launch_gossip drives each client's own local loop at real "
            "wall-clock speed — the simulated-tick modes (async/lockstep) "
            "would be silently ignored by a multi-process run; use mode "
            "'sync' (optionally "
            "throttle_ms for deliberate stragglers) or 'scoreboard' "
            "(pace_ms + runahead drive a per-process GossipPacer)")
    if spec.schedule.mode == "scoreboard" and \
            spec.schedule.rates is not None:
        raise ValueError(
            "schedule.rates are simulation wall ticks; a multi-process "
            "scoreboard run paces with real milliseconds — use "
            "schedule.pace_ms")
    throttle = {int(k): float(v) for k, v in (throttle_ms or {}).items()}
    crash = {int(k): int(v) for k, v in (die_at or {}).items()}
    K = spec.num_clients
    on_cpu = torch.device("cuda" if device is None else device).type == "cpu"
    if not on_cpu and torch.cuda.is_available():
        _prebuild()
    data = materialize_data(spec.data, spec.partition, K)
    base = _ChildConfig(
        resume=resume, hard_timeout=timeout,
        device=None if device is None else str(device),
        threads=max(1, torch.get_num_threads() // K) if on_cpu else None,
        backend=_backend_flags(), child_init=child_init)
    ctx = mp.get_context("spawn")
    spec_json = spec.to_json()
    conns, procs = [], []
    data_dir = tempfile.mkdtemp(prefix="gossip_data_")
    try:
        data_path = os.path.join(data_dir, "data.pkl")
        with open(data_path, "wb") as f:
            pickle.dump(data, f, protocol=pickle.HIGHEST_PROTOCOL)
        for rank in range(K):
            parent_conn, child_conn = ctx.Pipe()
            cfg = dataclasses.replace(
                base, throttle_ms=throttle.get(rank, 0.0),
                die_at=crash.get(rank), started_at=time.time())
            p = ctx.Process(target=_child_main,
                            args=(spec_json, rank, child_conn, data_path,
                                  cfg),
                            daemon=True)
            p.start()
            child_conn.close()
            conns.append(parent_conn)
            procs.append(p)
        comms = _FleetComms(conns, procs)

        # phase 1: gather every child's listening port, broadcast the map.
        # The (p_recv, p_send) timestamps around each child's handshake are
        # the parent-side anchors of the trace merge's clock alignment
        # (repro_torch.obs.export.rendezvous_offset).
        ports: Dict[int, int] = {}
        p_recv: Dict[int, float] = {}
        p_send: Dict[int, float] = {}
        start_deadline = time.monotonic() + start_timeout
        for rank in range(K):
            msg = comms.recv(rank, start_deadline - time.monotonic(),
                             "setup")
            if msg[0] == "error":
                raise RuntimeError(
                    f"gossip client {msg[1]} failed during setup:\n{msg[2]}")
            ports[msg[1]] = msg[2]
            p_recv[msg[1]] = time.perf_counter()
        for rank, conn in enumerate(conns):
            # a child may die between reporting and the broadcast; the
            # next recv sweep surfaces it with its exit status
            with contextlib.suppress(OSError):
                conn.send(ports)
                p_send[rank] = time.perf_counter()

        # phase 2: finish barrier — every child reports that it has sent
        # its last frame along with its per-destination frame counts; the
        # counts are aggregated into each rank's expected inbound total
        # and broadcast back, so every rank drains until it has *all* of
        # its mail (count-based quiesce) instead of hoping a grace window
        # was long enough
        deadline = time.monotonic() + timeout
        expected_inbound: Dict[int, int] = defaultdict(int)
        for rank in range(K):
            msg = comms.recv(rank, deadline - time.monotonic(), "training")
            if msg[0] == "error":
                raise RuntimeError(
                    f"gossip client {msg[1]} failed:\n{msg[2]}")
            assert msg[0] == "finished", msg
            for dst, n in ((msg[2] or {}).get("sent_to") or {}).items():
                expected_inbound[int(dst)] += int(n)
        for rank, conn in enumerate(conns):
            with contextlib.suppress(OSError):
                conn.send(("all_finished", expected_inbound.get(rank, 0)))

        # phase 3: collect results under the hard run deadline
        results: Dict[int, Dict[str, Any]] = {}
        for rank in range(K):
            msg = comms.recv(rank, deadline - time.monotonic(),
                             "finish barrier")
            if msg[0] == "error":
                raise RuntimeError(
                    f"gossip client {msg[1]} failed:\n{msg[2]}")
            results[msg[1]] = msg[2]

        # merge the per-rank trace files (each on its own perf_counter
        # clock) into one parent-clock-aligned Chrome trace; a merge
        # failure must never fail an otherwise-successful run
        if spec.train.trace_dir:
            try:
                from repro_torch.obs import merge_traces

                rank_paths = {
                    r: res["trace_file"] for r, res in results.items()
                    if res.get("trace_file")
                    and os.path.exists(res["trace_file"])}
                if rank_paths:
                    merged = merge_traces(
                        rank_paths,
                        os.path.join(spec.train.trace_dir,
                                     "trace_merged.json"),
                        parent_anchors={
                            r: (p_recv[r], p_send[r]) for r in rank_paths
                            if r in p_recv and r in p_send},
                        meta={"spec_name": spec.name})
                    for r in rank_paths:
                        results[r]["trace_merged"] = merged
            except Exception:  # noqa: BLE001 — tracing is best-effort
                traceback.print_exc()

        # the lossless-localhost invariant, per edge: bytes offered by the
        # sender rank == bytes delivered at the receiver rank. Skipped
        # when a gap is *expected*: resumed fleets (uncoordinated
        # snapshot cuts) and runs with failed sends / tombstoned mail.
        lossy = any(r.get("failed_sends", 0) or r.get("tombstoned_bytes", 0)
                    for r in results.values())
        if check_delivery and not resume and not lossy:
            gaps = delivery_gaps(results)
            if gaps:
                raise RuntimeError(
                    "delivered != offered on a lossless localhost wire: "
                    + "; ".join(
                        f"edge {e}: offered {o} B, delivered {d} B"
                        for e, (o, d) in sorted(gaps.items())))

        # phase 4: exit barrier — only now may children close their sockets
        for conn in conns:
            with contextlib.suppress(OSError):
                conn.send("done")
        for p in procs:
            p.join(timeout=30)
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.is_alive():
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
        for conn in conns:
            conn.close()
        shutil.rmtree(data_dir, ignore_errors=True)


def delivery_gaps(results: Dict[int, Dict[str, Any]]
                  ) -> Dict[str, Tuple[int, int]]:
    """Join the per-rank meter books into fleet-wide per-edge totals and
    return the edges where delivered != offered as
    ``{"src-dst": (offered_bytes, delivered_bytes)}`` (empty = the
    lossless invariant holds). An edge's offered bytes are booked only by
    its sender rank, its delivered bytes only by its receiver rank."""
    offered: Dict[str, int] = defaultdict(int)
    delivered: Dict[str, int] = defaultdict(int)
    for r in results.values():
        for edge, b in (r.get("offered_by_edge") or {}).items():
            offered[edge] += int(b)
        for edge, b in (r.get("delivered_by_edge") or {}).items():
            delivered[edge] += int(b)
    return {e: (offered[e], delivered[e])
            for e in set(offered) | set(delivered)
            if offered[e] != delivered[e]}


def fleet_summary(results: Dict[int, Dict[str, Any]]) -> Dict[str, float]:
    """Aggregate per-rank reports into the fleet-level view the
    acceptance criteria (and the smoke benchmark) read."""
    vals = list(results.values())
    return {
        "clients": float(len(vals)),
        "offered_bytes": sum(r["offered_bytes"] for r in vals),
        "delivered_bytes": sum(r["delivered_bytes"] for r in vals),
        "offered_messages": sum(r["offered_messages"] for r in vals),
        "delivered_messages": sum(r["delivered_messages"] for r in vals),
        "distill_steps_min": min(r["distill_steps"] for r in vals),
        "distill_steps_total": sum(r["distill_steps"] for r in vals),
        "fresh_teachers_min": min(r["fresh_teachers"] for r in vals),
        "failed_sends": sum(r["failed_sends"] for r in vals),
        "drain_stalls": sum(r.get("drain_stalls", 0) for r in vals),
        "undrained_bytes": sum(r.get("undrained_bytes", 0) for r in vals),
        "mismatched_edges": float(len(delivery_gaps(results))),
        "backpressure_events": sum(
            (r.get("sched") or {}).get("backpressure_events", 0.0)
            for r in vals),
        "backpressure_seconds": sum(
            (r.get("sched") or {}).get("backpressure_s", 0.0)
            for r in vals),
        "wall_seconds_max": max(r["wall_seconds"] for r in vals),
        # launcher-overhead breakdown (absent in pre-obs result dicts)
        "setup_seconds_max": max(r.get("setup_s", 0.0) for r in vals),
        "rendezvous_seconds_max": max(
            r.get("rendezvous_s", 0.0) for r in vals),
        "barrier_wait_seconds_max": max(
            r.get("barrier_wait_s", 0.0) for r in vals),
    }
