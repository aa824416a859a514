"""Dependency-scoreboard fleet scheduler: out-of-order issue over the
trainer's per-client op primitives, with lockstep as the degenerate policy
(port of ``repro/core/scheduler.py``: the same ops, keys, gates, pacing
and state, over the port's `DecentralizedTrainer`; the public batch is
put on the trainer's device once per wall tick).

The paper's agents communicate over an arbitrary graph with no global
synchronization barrier. Earlier revisions of this module removed the
barrier with a lock-step wall-tick loop: one integer clock, every due
client stepped per tick. That keeps a slow client from *computing* every
tick, but the loop itself is still a barrier — nothing later than tick T
can start until everything at tick T finished, so one paced straggler
stalls clients whose inputs (fresh-enough neighbor mailboxes) are already
sitting in their mailboxes.

This module decomposes each client's progress into explicit *operations*
and dispatches them when their dependencies are satisfied, scoreboard
style (cf. the issue-queue/scoreboard schedulers in hardware: an op
issues when its operands are ready, not when a global clock says so):

  ``LocalStep(c, n)``   client c's n-th local optimization step, at wall
                        tick ``n * rates[c]``. Dispatched with
                        ``step_client(defer=True)`` so device compute
                        overlaps the communication ops that follow.
  ``Publish(c, s)``     encode + publish c's prediction window at its
                        pool boundary ``s`` (every ``rates[c] * S_P``
                        wall ticks).
  ``Pull(c, s)``        draw one in-neighbor (shared rng) and insert its
                        mailbox window into c's pool.
  ``Resolve(c, n)``     block on the deferred step's metrics (the
                        compute/comm overlap join point).
  ``Pump(s)``           the global transport drain at wall tick ``s``
                        (deliver in-flight mail, complete late pulls).

Each op carries a total-order key ``(wall, phase, client)`` with phases
``Publish < Pump < Pull < Resolve < LocalStep`` — exactly the synchronous
loop's operation order. Per client, ops execute in program order (its own
previous op is an implicit dependency); *across* clients the two shipped
policies differ only in what a not-ready op does to the rest of the
fleet:

  lockstep (`AsyncScheduler`)     strict key order, one wall tick per
                                  ``tick()``. A gated op blocks the tick
                                  — the global-barrier policy, bitwise
                                  identical to the previous revision.
  scoreboard (`ScoreboardScheduler`)  the lowest-keyed *ready* op issues;
                                  gated ops are overtaken. A fast client
                                  runs many local steps and pool rounds
                                  while a 4x-paced straggler completes
                                  one.

Dependencies (the gates, scoreboard policy only):

  run-ahead credit   a ``LocalStep`` at wall ``w`` needs
                     ``w <= min(in-neighbor progress) + runahead``.
                     A client that outruns its slowest in-neighbor by
                     more than the window *waits* (backpressure,
                     ``sched/backpressure`` spans) instead of training
                     against ever-staler teachers or dropping mail.
                     ``runahead=None`` = unbounded (no gate).
  pacing             ``pace_s[c]`` seconds minimum between c's local
                     steps (wall-clock heterogeneity: the benchmark's
                     simulated straggler, the gossip child's real one).
                     Under lockstep the slowest due pace bounds every
                     tick — the measured global stall; under scoreboard
                     only the paced client's own ops wait.

Clock model (unchanged)
  ``rates[i] = r`` wall ticks per local step of client i. Public batches
  are indexed by wall tick (`PublicPool` is deterministic in the step);
  a client's optimizer/LR schedule advances with its *local* step count,
  its distillation rng with the wall tick. Pool cadence: every
  ``r * S_P`` wall ticks. The bounded-staleness gate stays in the
  trainer (``RunConfig.max_staleness`` in ``_stack_teachers``): stale
  mail never teaches, a fully-stale client falls back to supervised.

Lockstep equivalence (the bitwise anchor)
  With equal rates, a lossless zero-latency transport, unbounded
  staleness and unbounded run-ahead, key order *is* the synchronous
  loop's operation sequence — same shared-rng draws, same publish /
  deliver / pull order, same LIFO metric resolves. Both policies are
  then *bitwise* equal to ``DecentralizedTrainer.step()``, asserted in
  tests/test_torch_scheduler.py.

Snapshots (`repro_torch.fleet`)
  ``state_dict()`` captures the clocks *and* the per-client issue
  cursors + pump position, so a fleet snapshot taken mid-pool-cadence
  under rate skew resumes bitwise — for either policy.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.runtime import DecentralizedTrainer, batch_to_device
from repro_torch.obs import tracer as trace

# "argument not passed" sentinel: freshness_report must distinguish an
# explicit max_staleness=None (unbounded view) from no argument at all
# (fall back to the trainer's configured bound)
_UNSET = object()

# op phase ranks within one wall tick: comm ops at wall s run between the
# local steps of tick s-1 and those of tick s (the synchronous loop's
# publish -> deliver -> pull -> resolve-metrics -> step ordering)
_PH_PUBLISH, _PH_PUMP, _PH_PULL, _PH_RESOLVE, _PH_STEP = range(5)

_OP_NAMES = {_PH_PUBLISH: "publish", _PH_PUMP: "pump", _PH_PULL: "pull",
             _PH_RESOLVE: "resolve", _PH_STEP: "step"}


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    """Per-client step rates plus the scoreboard policy knobs.

    ``rates[i]``: wall ticks per local step of client i (1 = steps every
    tick; 4 = a 4x slower client). ``runahead``: bounded run-ahead window
    in wall ticks (scoreboard policy; None = unbounded). ``pace_s[i]``:
    minimum real seconds between client i's local steps (None = no
    pacing; lockstep turns the slowest due pace into a global stall,
    scoreboard into a per-client one)."""

    rates: Tuple[int, ...]
    runahead: Optional[int] = None
    pace_s: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if not self.rates:
            raise ValueError("ScheduleConfig needs at least one client")
        if any(int(r) < 1 or int(r) != r for r in self.rates):
            raise ValueError(f"rates must be integers >= 1: {self.rates}")
        if self.runahead is not None and int(self.runahead) < 0:
            raise ValueError(f"runahead must be >= 0: {self.runahead}")
        if self.pace_s is not None:
            if len(self.pace_s) != len(self.rates):
                raise ValueError(
                    f"{len(self.pace_s)} pace entries for "
                    f"{len(self.rates)} rates")
            if any(p < 0 for p in self.pace_s):
                raise ValueError(f"pace_s must be >= 0: {self.pace_s}")

    @classmethod
    def uniform(cls, num_clients: int, rate: int = 1,
                **kw) -> "ScheduleConfig":
        return cls(tuple([rate] * num_clients), **kw)

    @classmethod
    def skewed(cls, num_clients: int, slow_rate: int,
               num_slow: int = 1, **kw) -> "ScheduleConfig":
        """The benchmark's fast/slow split: the last ``num_slow`` clients
        step ``slow_rate``x slower than the rest."""
        fast = num_clients - num_slow
        if fast < 0:
            raise ValueError("num_slow exceeds num_clients")
        return cls(tuple([1] * fast + [slow_rate] * num_slow), **kw)

    @property
    def max_rate(self) -> int:
        return max(self.rates)


class _Cursor:
    """One client's two in-order op streams.

    The *step* stream alternates LocalStep (at ``step_wall``) and Resolve
    (the deferred metrics join, keyed one tick later). The *comm* stream
    walks the client's pool boundaries: Publish then Pull at every
    ``rate * S_P`` wall ticks (Pull only, in the legacy params mode).
    A client's head op is the lower-keyed of the two stream heads, which
    preserves per-client program order while letting clients interleave.
    """

    __slots__ = ("step_wall", "resolving", "comm_wall", "pulling")

    def __init__(self, step_wall: int, comm_wall: int):
        self.step_wall = step_wall  # wall tick of the next LocalStep
        self.resolving = False  # a dispatched step awaits Resolve
        self.comm_wall = comm_wall  # next pool boundary (wall tick)
        self.pulling = False  # boundary's Publish done, Pull pending

    def to_state(self) -> Dict[str, Any]:
        return {"step_wall": int(self.step_wall),
                "resolving": bool(self.resolving),
                "comm_wall": int(self.comm_wall),
                "pulling": bool(self.pulling)}

    @classmethod
    def from_state(cls, d: Dict[str, Any]) -> "_Cursor":
        c = cls(int(d["step_wall"]), int(d["comm_wall"]))
        c.resolving = bool(d.get("resolving", False))
        c.pulling = bool(d.get("pulling", False))
        return c


class Scoreboard:
    """The shared op engine: per-client issue cursors over a
    `DecentralizedTrainer`'s op-granular primitives, a global transport
    pump, and the gate/stat machinery. Subclasses pick the dispatch
    policy (`AsyncScheduler` = lockstep windows, `ScoreboardScheduler` =
    out-of-order issue). The trainer must be freshly constructed (the
    scheduler owns time from wall tick 0; construction-time pool seeding
    is shared with the synchronous path)."""

    mode = "scoreboard"

    def __init__(self, trainer: DecentralizedTrainer,
                 schedule: Optional[ScheduleConfig] = None):
        self.trainer = trainer
        k = len(trainer.clients)
        self.schedule = schedule or ScheduleConfig.uniform(k)
        if len(self.schedule.rates) != k:
            raise ValueError(
                f"{len(self.schedule.rates)} rates for {k} clients")
        self.rates = [int(r) for r in self.schedule.rates]
        self.runahead = self.schedule.runahead
        self.pace_s = list(self.schedule.pace_s or [])
        self.wall = 0
        self.local_steps = [0] * k  # completed local steps per client
        sp = trainer.mhd_cfg.pool_update_every
        self._cadence = [r * sp for r in self.rates]
        self._cursors = [_Cursor(0, self._cadence[i]) for i in range(k)]
        self._pump_wall = 1  # next wall tick the transport pump drains
        self._inflight: Dict[int, Callable[[], Dict[str, float]]] = {}
        self._metrics: Dict[str, float] = {}
        self._public_cache: Tuple[Optional[int], Any] = (None, None)
        self._adj_cache: Tuple[Optional[int], Any] = (None, None)
        self._pace_deadline = [0.0] * k
        self._gate_since: Dict[int, float] = {}
        # perf_counter stamp of each client's latest resolved step — how
        # the skew benchmark reads "when did the fast clients finish"
        # without waiting out the straggler's tail
        self.resolved_at = [0.0] * k
        self.stats = {"issued": 0, "steps": 0, "overtakes": 0,
                      "backpressure_events": 0, "backpressure_s": 0.0,
                      "wait_s": 0.0}
        if trainer.exchange != "params":
            need = self.schedule.max_rate * sp
            if trainer.horizon < need:
                warnings.warn(
                    f"prediction horizon {trainer.horizon} < slowest "
                    f"client's publish gap {need} wall ticks: its windows "
                    f"will expire between publishes and students will fall "
                    f"back to supervised-only for the gap (set "
                    f"CommConfig.horizon >= max_rate * S_P to cover it)",
                    stacklevel=2)

    # -- cadence predicates (kept from the tick-loop API) ------------------

    def due(self, client_id: int, wall: int) -> bool:
        """Does this client take a local step at this wall tick?"""
        return wall % self.rates[client_id] == 0

    def pool_due(self, client_id: int, s: int) -> bool:
        """Is wall tick ``s`` this client's pool-refresh boundary (every
        S_P local steps = rate*S_P wall ticks)?"""
        return s % self._cadence[client_id] == 0

    # -- op heads and keys -------------------------------------------------

    def _active_ids(self) -> List[int]:
        return [c.client_id for c in self.trainer.local]

    def _step_head(self, cid: int) -> Optional[Tuple[int, int, int]]:
        cur = self._cursors[cid]
        if cur.resolving:
            k = len(self.trainer.clients)
            return (cur.step_wall + 1, _PH_RESOLVE, k - cid)
        return (cur.step_wall, _PH_STEP, cid)

    def _comm_head(self, cid: int) -> Tuple[int, int, int]:
        cur = self._cursors[cid]
        if cur.pulling or self.trainer.exchange == "params":
            return (cur.comm_wall, _PH_PULL, cid)
        return (cur.comm_wall, _PH_PUBLISH, cid)

    def _head(self, cid: int,
              step_limit: Optional[int] = None
              ) -> Optional[Tuple[Tuple[int, int, int], int]]:
        """Client cid's program head: ``(key, phase)``. ``step_limit``
        freezes the step stream once the client has completed that many
        local steps (run_until_steps); in-flight resolves and comm ops
        still drain."""
        step = self._step_head(cid)
        if step is not None and step[1] == _PH_STEP and \
                step_limit is not None and \
                self.local_steps[cid] >= step_limit:
            step = None
            # a client at its step limit quiesces: boundaries past its
            # final step stay queued (a live client's comm head likewise
            # never outruns its step stream — program order)
            if self._cursors[cid].comm_wall > self._cursors[cid].step_wall:
                return None
        comm = self._comm_head(cid)
        heads = [h for h in (step, comm) if h is not None]
        if not heads:
            return None
        key = min(heads)
        return key, key[1]

    def _candidates(self, limits: Optional[Sequence[Optional[int]]] = None
                    ) -> List[Tuple[Tuple[int, int, int], int, int]]:
        """All issueable op heads as ``(key, phase, client)``, sorted by
        key: one head per active client plus the transport pump (bounded
        by the furthest client head so it never outruns the fleet)."""
        out = []
        max_wall = 0
        for cid in self._active_ids():
            h = self._head(cid, None if limits is None else limits[cid])
            if h is None:
                continue
            key, phase = h
            max_wall = max(max_wall, key[0])
            out.append((key, phase, cid))
        if self.trainer.exchange != "params" and out and \
                self._pump_wall <= max_wall:
            out.append(((self._pump_wall, _PH_PUMP, -1), _PH_PUMP, -1))
        out.sort()
        return out

    # -- gates -------------------------------------------------------------

    def _gate(self, phase: int, cid: int, wall: int) -> Optional[str]:
        """Why this op cannot issue yet, or None if ready. Only
        ``LocalStep`` ops carry cross-client dependencies; everything
        else is ready the moment it is the client's program head."""
        if phase != _PH_STEP:
            return None
        if self.runahead is not None:
            nbrs = self._adj(wall)[cid]
            active = set(self._active_ids())
            progress = [self._cursors[j].step_wall
                        for j in nbrs if j in active and j != cid]
            if progress and wall > min(progress) + self.runahead:
                return "runahead"
        if self.pace_s and self.pace_s[cid] > 0 and \
                time.perf_counter() < self._pace_deadline[cid]:
            return "pace"
        return None

    def _pace_wait(self, cid: int) -> None:
        """Lockstep policy: a paced op blocks the window — sleep out the
        remaining pace (the global stall the scoreboard policy removes)."""
        delay = self._pace_deadline[cid] - time.perf_counter()
        if delay > 0:
            t0 = trace.now()
            time.sleep(delay)
            self.stats["wait_s"] += delay
            trace.complete("sched/wait", t0, client=cid, reason="pace")

    # -- op execution ------------------------------------------------------

    def _public_batch(self, wall: int):
        cached_wall, batch = self._public_cache
        if cached_wall != wall:
            batch = batch_to_device(self.trainer.public.sample(wall),
                                    self.trainer.device)
            self._public_cache = (wall, batch)
        return batch

    def _adj(self, wall: int):
        cached_wall, adj = self._adj_cache
        if cached_wall != wall:
            adj = self.trainer.graph_fn(wall)
            self._adj_cache = (wall, adj)
        return adj

    def _exec(self, phase: int, cid: int, wall: int,
              limits: Optional[Sequence[Optional[int]]] = None) -> None:
        """Issue one op. The caller has checked gates and program order;
        this is pure execution + cursor advance."""
        tr = self.trainer
        self.stats["issued"] += 1
        if cid in self._gate_since:
            t0 = self._gate_since.pop(cid)
            waited = trace.now() - t0
            self.stats["backpressure_events"] += 1
            self.stats["backpressure_s"] += waited
            trace.complete("sched/backpressure", t0, client=cid,
                           wall=wall, op=_OP_NAMES[phase])
        if phase == _PH_STEP:
            c = tr.clients[cid]
            resolve = tr.step_client(
                c, self._public_batch(wall), wall,
                opt_step=self.local_steps[cid], defer=True)
            self.local_steps[cid] += 1
            self.stats["steps"] += 1
            self._inflight[cid] = resolve
            self._cursors[cid].resolving = True
            if self.pace_s and self.pace_s[cid] > 0:
                self._pace_deadline[cid] = \
                    time.perf_counter() + self.pace_s[cid]
            trace.instant("sched/issue", op="step", client=cid, wall=wall)
        elif phase == _PH_RESOLVE:
            resolve = self._inflight.pop(cid, None)
            if resolve is not None:
                m = resolve()
                m[f"c{cid}/local_step"] = float(self.local_steps[cid])
                self._metrics.update(m)
            cur = self._cursors[cid]
            cur.resolving = False
            cur.step_wall += self.rates[cid]
            self.resolved_at[cid] = time.perf_counter()
        elif phase == _PH_PUBLISH:
            self._exec_publish(wall, limits)
        elif phase == _PH_PULL:
            adj = self._adj(wall)
            tr.pull_client(cid, wall, adj)
            trace.instant("sched/issue", op="pull", client=cid, wall=wall)
            cur = self._cursors[cid]
            cur.pulling = False
            cur.comm_wall += self._cadence[cid]
        elif phase == _PH_PUMP:
            tr.comm_pump(wall)
            self._pump_wall = wall + 1

    def _exec_publish(self, wall: int,
                      limits: Optional[Sequence[Optional[int]]] = None
                      ) -> None:
        """Issue every active publish head at this wall tick as one
        grouped call (the window encode shares the public batches — and
        in the degenerate case this is exactly the synchronous round's
        single ``_publish_clients`` call)."""
        ids = [cid for cid in self._active_ids()
               if self._head(cid, None if limits is None else limits[cid])
               == ((wall, _PH_PUBLISH, cid), _PH_PUBLISH)]
        trace.instant("sched/pool_round", wall=wall, clients=ids)
        self.trainer.publish_clients(ids, wall)
        for cid in ids:
            self._cursors[cid].pulling = True

    # -- dispatch ----------------------------------------------------------

    def _issue_lockstep_window(self) -> None:
        """Strict key order through one wall tick: every op with key
        below ``(wall+1, STEP)`` issues; a paced op stalls the window
        (the lockstep barrier)."""
        limit = (self.wall + 1, _PH_STEP, -(1 << 30))
        while True:
            cands = self._candidates()
            if not cands or cands[0][0] >= limit:
                return
            key, phase, cid = cands[0]
            # pacing is the only gate the barrier honors: in strict key
            # order the run-ahead credit can never bind (no client gets
            # ahead of the window), so it is vacuously satisfied
            if self._gate(phase, cid, key[0]) == "pace":
                self._pace_wait(cid)
            self._exec(phase, cid, key[0])

    def _issue_one(self, limits: Optional[Sequence[Optional[int]]] = None
                   ) -> bool:
        """Scoreboard policy: issue the lowest-keyed *ready* op, letting
        ready ops overtake gated ones. When every candidate is gated,
        sleep until the earliest pace deadline (``sched/wait``); pure
        run-ahead stalls with no pace pending mean no op can ever become
        ready without external progress — return False."""
        while True:
            cands = self._candidates(limits)
            if not cands:
                return False
            best_gated = None
            for i, (key, phase, cid) in enumerate(cands):
                reason = self._gate(phase, cid, key[0])
                if reason is None:
                    if i > 0:
                        self.stats["overtakes"] += 1
                    self._exec(phase, cid, key[0], limits)
                    return True
                if cid >= 0 and cid not in self._gate_since and \
                        reason == "runahead":
                    self._gate_since[cid] = trace.now()
                if reason == "pace" and (
                        best_gated is None or self._pace_deadline[cid] <
                        self._pace_deadline[best_gated]):
                    best_gated = cid
            if best_gated is None:
                return False  # all run-ahead gated: stalled
            self._pace_wait(best_gated)

    def quiesce(self) -> None:
        """Join every in-flight deferred step so the scheduler is at a
        clean issue boundary (the state `state_dict` snapshots). Only
        ops that precede a pending Resolve in some client's program
        order execute — comm rounds not yet due stay queued in the
        cursors, which the snapshot captures."""
        while any(cur.resolving for cur in self._cursors):
            heads = []
            for cid in self._active_ids():
                if self._cursors[cid].resolving:
                    h = self._head(cid)
                    if h is not None:
                        heads.append((h[0], h[1], cid))
            if not heads:
                # a resolving client left the fleet: drop its join
                for cid, cur in enumerate(self._cursors):
                    if cur.resolving and cid not in self._active_ids():
                        self._inflight.pop(cid, None)
                        cur.resolving = False
                        cur.step_wall += self.rates[cid]
                continue
            heads.sort()
            key, phase, cid = heads[0]
            if self.trainer.exchange != "params" and (
                    self._pump_wall < key[0] or
                    (self._pump_wall == key[0] and phase > _PH_PUMP)):
                self._exec(_PH_PUMP, -1, self._pump_wall)
                continue
            self._exec(phase, cid, key[0])

    def _pop_metrics(self) -> Dict[str, float]:
        m = self._metrics
        self._metrics = {}
        return m

    # -- snapshot/restore (repro_torch.fleet) ------------------------------

    def state_dict(self) -> Dict[str, Any]:
        """The scheduler's clocks and issue cursors: wall tick, per-client
        local step counts, each client's step/comm stream positions and
        the transport pump — what a fleet snapshot needs to resume the
        loop bitwise mid-pool-cadence (`repro_torch.fleet.snapshot`). Must be
        taken at an issue boundary (no in-flight deferred steps):
        ``quiesce()`` first if driving out of order."""
        if self._inflight:
            raise RuntimeError(
                f"state_dict with {len(self._inflight)} unresolved "
                "deferred steps; call quiesce() first")
        return {"wall": int(self.wall),
                "local_steps": [int(s) for s in self.local_steps],
                "mode": self.mode,
                "pump_wall": int(self._pump_wall),
                "cursors": [c.to_state() for c in self._cursors]}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.wall = int(state["wall"])
        steps = [int(s) for s in state["local_steps"]]
        if len(steps) != len(self.local_steps):
            raise ValueError(
                f"{len(steps)} local_steps for "
                f"{len(self.local_steps)} clients")
        self.local_steps = steps
        if "cursors" in state:
            self._cursors = [_Cursor.from_state(d)
                             for d in state["cursors"]]
            self._pump_wall = int(state["pump_wall"])
        else:
            # legacy clock-only snapshot: reconstruct the cursors from
            # the wall/step counts (exact for churn-free runs — a
            # client's n-th step sits at n*rate, its next boundary at
            # the first cadence multiple past the wall)
            for cid, cur in enumerate(self._cursors):
                cur.step_wall = steps[cid] * self.rates[cid]
                cur.resolving = False
                cad = self._cadence[cid]
                cur.comm_wall = ((self.wall // cad) + 1) * cad
                cur.pulling = False
            self._pump_wall = self.wall + 1
        self._inflight = {}
        self._gate_since = {}
        self._public_cache = (None, None)
        self._adj_cache = (None, None)

    # -- telemetry ---------------------------------------------------------

    def freshness_report(self, max_staleness: Any = _UNSET
                         ) -> Dict[int, Dict[str, float]]:
        """Per-client view of mailbox freshness against each client's own
        clock (prediction modes only): total mailbox size, how much of it
        passes the staleness bound, and the bus-clock reading.

        ``max_staleness`` defaults to the trainer's configured
        ``run_cfg.max_staleness``; passing ``None`` explicitly requests
        the *unbounded* view (the whole mailbox counts as fresh) rather
        than falling back to the configured bound."""
        tr = self.trainer
        if tr.exchange == "params":
            return {}
        ms = tr.run_cfg.max_staleness if max_staleness is _UNSET \
            else max_staleness
        out: Dict[int, Dict[str, float]] = {}
        for c in tr.local:
            cid = c.client_id
            box = tr.bus.mailbox(cid)
            fresh = tr.bus.poll_fresh(cid, ms)
            out[cid] = {
                "clock": float(tr.bus.clock(cid)),
                "mailbox": float(len(box)),
                "fresh": float(len(fresh)),
                "local_steps": float(self.local_steps[cid]),
            }
        return out

    # -- driving loop (shared) ---------------------------------------------

    def run(self, wall_ticks: int,
            eval_arrays: Optional[Dict[str, np.ndarray]] = None,
            eval_every: int = 0,
            log_every: int = 0) -> List[Tuple[int, Dict[str, float]]]:
        """Run ``wall_ticks`` ticks; optionally evaluate every
        ``eval_every`` ticks. Returns the (tick, eval-metrics) history."""
        history: List[Tuple[int, Dict[str, float]]] = []
        for _ in range(wall_ticks):
            metrics = self.tick()
            t = self.wall - 1
            if log_every and t % log_every == 0 and metrics:
                losses = [v for k, v in metrics.items()
                          if k.endswith("/loss")]
                print(f"tick {t}: mean stepped-client loss "
                      f"{float(np.mean(losses)):.4f}")
            if eval_arrays is not None and eval_every and \
                    (t + 1) % eval_every == 0:
                history.append((t + 1, self.trainer.evaluate(eval_arrays)))
        return history

    def tick(self) -> Dict[str, float]:
        raise NotImplementedError


class AsyncScheduler(Scoreboard):
    """The lockstep policy: `tick()` advances the wall clock by one tick,
    issuing every op in strict key order — step every due client (in
    client-id order, against the tick's shared public batch), then the
    communication phase, then the LIFO metric resolves. With pacing
    configured, the slowest due client's pace bounds the whole tick (the
    global stall the scoreboard policy removes). Returns the due
    clients' step metrics."""

    mode = "lockstep"

    def tick(self) -> Dict[str, float]:
        wall = self.wall
        n_due = sum(1 for c in self.trainer.local
                    if self.due(c.client_id, wall))
        with trace.span("sched/tick", wall=wall, due=n_due):
            self._issue_lockstep_window()
        self.wall = wall + 1
        trace.counter("sched/wall", self.wall)
        return self._pop_metrics()


class ScoreboardScheduler(Scoreboard):
    """The out-of-order policy: ready ops issue the moment their
    dependencies (program order, run-ahead credit, pace) are satisfied,
    overtaking gated ones. ``tick()`` keeps the wall-tick driving surface
    (one tick's worth of progress per call, for `Experiment.run` parity);
    ``run_until_steps`` is the free-running loop the benchmark and the
    straggler demos use."""

    mode = "scoreboard"

    def tick(self) -> Dict[str, float]:
        """Advance one wall tick: issue ready ops until every active
        client's step stream has moved past the current tick. Identical
        to the lockstep window when nothing is gated; under gates, ops of
        *later* ticks may issue early rather than stall the fleet."""
        wall = self.wall
        with trace.span("sched/tick", wall=wall, mode="scoreboard"):
            while any(self._cursors[cid].step_wall <= wall
                      or self._cursors[cid].resolving
                      for cid in self._active_ids()):
                if not self._issue_one():
                    break  # fully stalled on run-ahead credit
        self.wall = wall + 1
        trace.counter("sched/wall", self.wall)
        return self._pop_metrics()

    def run_until_steps(self, targets: Sequence[int],
                        max_ops: int = 1 << 22
                        ) -> List[Tuple[int, Dict[str, float]]]:
        """Free-run until every active client has completed its target
        local step count (a frozen client still resolves and
        communicates, but issues no further steps). Stops early when
        every remaining op is run-ahead gated — the bounded window's
        backpressure, observable in ``stats``. Returns per-issue metric
        snapshots for the ticks that produced any."""
        limits = [int(t) for t in targets]
        if len(limits) != len(self.local_steps):
            raise ValueError(
                f"{len(limits)} targets for "
                f"{len(self.local_steps)} clients")
        history: List[Tuple[int, Dict[str, float]]] = []
        ops = 0
        while any(self.local_steps[cid] < limits[cid]
                  for cid in self._active_ids()):
            if not self._issue_one(limits):
                break
            ops += 1
            if ops >= max_ops:
                break
            if self._metrics:
                history.append((ops, self._pop_metrics()))
        self.quiesce()
        if self._metrics:
            history.append((ops, self._pop_metrics()))
        self.wall = max((c.step_wall for c in self._cursors),
                        default=self.wall)
        return history


def run_async(trainer: DecentralizedTrainer, wall_ticks: int,
              rates: Optional[Sequence[int]] = None,
              **run_kw) -> AsyncScheduler:
    """Convenience: wrap a trainer in a lockstep scheduler and run it."""
    sched = AsyncScheduler(
        trainer,
        ScheduleConfig(tuple(int(r) for r in rates)) if rates else None)
    sched.run(wall_ticks, **run_kw)
    return sched


class GossipPacer:
    """The scoreboard policy for a one-client-per-process gossip fleet
    (`launch/gossip.py`): the child's training loop *is* its LocalStep
    stream, so the scheduler reduces to the two gates — wall-clock
    pacing (replacing the launcher's post-step throttle sleep) and the
    run-ahead credit against the freshest inbound mail per in-neighbor.
    A child that outruns its slowest in-neighbor by more than
    ``runahead`` local steps waits, pumping the transport while it does
    (backpressure instead of racing ahead against ever-staler teachers);
    ``escape_s`` caps any single wait so a dead peer degrades to the
    staleness gate rather than a hang."""

    def __init__(self, trainer: DecentralizedTrainer, client_id: int,
                 runahead: Optional[int] = None, pace_s: float = 0.0,
                 escape_s: float = 20.0):
        self.trainer = trainer
        self.client_id = int(client_id)
        self.runahead = None if runahead is None else int(runahead)
        self.pace_s = float(pace_s)
        self.escape_s = float(escape_s)
        self._deadline = 0.0
        self.stats = {"backpressure_events": 0, "backpressure_s": 0.0,
                      "pace_s": 0.0, "escapes": 0}

    def _neighbor_progress(self, t: int) -> Optional[int]:
        """The slowest in-neighbor's freshest published step, from this
        rank's mailbox (no mail yet = position 0)."""
        nbrs = self.trainer.graph_fn(t)[self.client_id]
        if not nbrs:
            return None
        box = self.trainer.bus.mailbox(self.client_id)
        positions = []
        for j in nbrs:
            mail = box.get(j)
            positions.append(0 if mail is None else int(mail.sent_step))
        return min(positions)

    def gate(self, t: int) -> None:
        """Block until step ``t`` may issue: pace first, then run-ahead
        credit, draining the transport while waiting."""
        if self.pace_s > 0:
            delay = self._deadline - time.perf_counter()
            if delay > 0:
                t0 = trace.now()
                time.sleep(delay)
                self.stats["pace_s"] += delay
                trace.complete("sched/wait", t0, client=self.client_id,
                               reason="pace", step=t)
            self._deadline = time.perf_counter() + self.pace_s
        if self.runahead is None:
            return
        progress = self._neighbor_progress(t)
        if progress is None or t <= progress + self.runahead:
            return
        t0 = trace.now()  # 0.0 when tracing is off — span bookkeeping only
        w0 = time.perf_counter()
        deadline = time.monotonic() + self.escape_s
        while t > (progress or 0) + self.runahead:
            if time.monotonic() >= deadline:
                self.stats["escapes"] += 1
                break
            self.trainer.bus.deliver(t)
            time.sleep(0.002)
            progress = self._neighbor_progress(t)
        self.stats["backpressure_events"] += 1
        self.stats["backpressure_s"] += time.perf_counter() - w0
        trace.complete("sched/backpressure", t0, client=self.client_id,
                       step=t, op="step")

    # -- snapshot/restore (repro_torch.fleet) ------------------------------

    def state_dict(self) -> Dict[str, Any]:
        return {"gossip_pacer": True, "client_id": self.client_id,
                "stats": {k: float(v) for k, v in self.stats.items()}}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        for k, v in state.get("stats", {}).items():
            if k in self.stats:
                self.stats[k] = type(self.stats[k])(v)
