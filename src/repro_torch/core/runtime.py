"""Decentralized MHD runtime (paper §4.1), in PyTorch — port of
``repro/core/runtime.py``.

K clients, each with private data, an optimizer and a rolling pool P_i of
stale teachers (N_P entries, refreshed from graph neighbours every S_P
steps). Every global step each client draws a private batch and the shared
public batch, samples Δ teachers from its pool, and takes one step on
Eq. (1) — whose distillation terms run on the port's kernels
(`repro_torch.core.mhd`).

Exchange modes (``exchange=``):
  * ``"params"`` — pools hold neighbours' parameters and re-run their
    forward passes locally (the reference's simulation shortcut);
  * ``"prediction_topk"`` / ``"prediction_dense"`` — the paper's protocol:
    every S_P steps a client publishes an encoded window of predictions on
    the next public batches (`repro_torch.comm`, on the ``topk_wire``
    kernel), students decode mail, params never leave a client.

Stepping models: ``step(t)`` is the synchronous loop; `core/scheduler`
drives the op-granular entry points below (``step_client(defer=True)``,
``publish_clients``, ``pull_client``, ``comm_pump``) on per-client
cadences, in lockstep or out of order. Bounded staleness
(``RunConfig.max_staleness``): a sampled teacher older than the bound
never teaches, and a client whose whole sample is stale takes the
supervised step. The fleet surface (``local_clients``, ``membership``,
``deactivate_client`` / ``activate_client`` / ``reinit_client``) is what
`repro_torch.fleet` drives for churn and snapshots.

The numpy rng draws and their order are the reference's (the neighbour
pull, the pool sample, the pool seeds, the public and private streams), so
given the same initial parameters both packages choose the same teachers
at the same steps. Initial parameters are torch draws, which cannot
replay the reference's ``jax.random`` streams: ``init_scheme="legacy"``
chains one CPU generator through the fleet (`init_fleet`), and
``"per_client"`` (and ``reinit_client``) seed one CPU generator per client
from ``(seed, client id)`` (`client_generator`), so a client's draw is the
same in every process. ``save`` / ``restore`` persist each client's
(params, opt_state) in the reference's per-client layout
(`repro_torch.checkpoint.io.save_client_states`).

Runs on the GPU unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_map

from repro_torch import resolve_device
from repro_torch.checkpoint.pool import CheckpointPool, PoolEntry
from repro_torch.core.evaluation import (
    fleet_beta_metrics,
    label_histogram,
    per_label_head_accuracy,
)
from repro_torch.core.graph import Adjacency, as_graph_fn, validate_adjacency
from repro_torch.core.mhd import MHDConfig, mhd_total_loss
from repro_torch.data.pipeline import (BatchIterator, PublicPool,
                                       client_stream_seed)
from repro_torch.models.zoo import ModelBundle
from repro_torch.obs import tracer as trace
from repro_torch.optim.optimizers import Optimizer

Tensor = torch.Tensor


def client_loss(bundle: ModelBundle, params, private_batch, public_batch,
                teachers, mhd_cfg: MHDConfig,
                rng: Optional[torch.Generator] = None
                ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Eq. (1) for one client: (loss, metrics). Positions-as-samples
    bundles (`repro_torch.lm.lm_client_bundle`) carry their own CE targets
    (next tokens) and an auxiliary loss (MoE router balancing)."""
    out_priv = bundle.apply(params, private_batch)
    out_pub = bundle.apply(params, public_batch)
    labels = out_priv["labels"] if "labels" in out_priv \
        else private_batch["labels"]
    loss, metrics = mhd_total_loss(out_priv, labels, out_pub, teachers,
                                   mhd_cfg, rng)
    if out_priv.get("aux_loss") is not None:
        loss = loss + out_priv["aux_loss"]
    return loss, metrics


def distill_update(bundle: ModelBundle, optimizer: Optimizer,
                   mhd_cfg: MHDConfig, params, opt_state, private_batch,
                   public_batch, teachers, step: int,
                   rng: Optional[torch.Generator] = None):
    """One distillation update of one client: Eq. (1), its gradients and
    the optimizer's update. Returns (params, opt_state, metrics); consumes
    ``opt_state`` (the optimizer takes each moment out as it makes the new
    one). The trainer's `_distill_update`, and what
    `obs.metrics.distill_step_cost` counts on meta copies."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss, metrics = client_loss(bundle, leaves, private_batch, public_batch,
                                teachers, mhd_cfg, rng)
    grads = dict(zip(leaves, torch.autograd.grad(
        loss, list(leaves.values()), allow_unused=True,
        materialize_grads=True)))
    new_params, new_opt = optimizer.update(grads, opt_state, params, step)
    metrics["loss"] = loss
    return new_params, new_opt, metrics


def meta_like(tree):
    """The shapes and dtypes of a tree of tensors, on the meta device."""
    return tree_map(lambda x: torch.empty_like(x, device="meta")
                    if isinstance(x, Tensor) else x, tree)


def batch_to_device(batch: Dict[str, np.ndarray],
                    device: torch.device) -> Dict[str, Tensor]:
    """A host batch of numpy arrays as tensors on ``device``."""
    return {k: torch.from_numpy(np.require(v, requirements="CW")).to(device)
            for k, v in batch.items()}


def init_fleet(bundles: Sequence[ModelBundle], seed: int,
               device: torch.device) -> List[Dict[str, Tensor]]:
    """Each bundle's initial params from one CPU generator chained through
    the fleet, so the draw does not depend on the device; moved to
    ``device``. Every trainer of the port draws its clients this way."""
    gen = torch.Generator().manual_seed(seed)
    return [{k: v.to(device) for k, v in b.init(gen).items()}
            for b in bundles]


def client_generator(seed: int, client_id: int) -> torch.Generator:
    """Client ``client_id``'s own CPU generator, seeded from ``(seed,
    client_id)`` alone: its draw does not depend on which other clients a
    process materializes (``init_scheme="per_client"``,
    ``reinit_client``)."""
    words = np.random.SeedSequence((int(seed), int(client_id))
                                   ).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(
        (int(words[0]) << 32) | int(words[1]))


def read_metrics(metrics: Dict[str, Tensor]) -> Dict[str, float]:
    """Every metric tensor of a step read back to the host at once."""
    vals = torch.stack([v.detach().float().reshape(())
                        for v in metrics.values()]).tolist()
    return dict(zip(metrics, vals))


@dataclasses.dataclass
class RunConfig:
    steps: int = 1000
    batch_size: int = 32
    public_batch_size: int = 32
    eval_every: int = 200
    eval_batch_size: int = 256
    seed: int = 0
    # bounded-staleness gate: the oldest pool entry (in steps, or wall
    # ticks under the scheduler) that may still teach; None = unbounded
    max_staleness: Optional[int] = None


@dataclasses.dataclass
class ClientState:
    client_id: int
    bundle: ModelBundle
    params: Optional[Dict[str, Tensor]]  # None: not driven by this process
    opt_state: Any
    pool: CheckpointPool
    private_iter: BatchIterator
    label_hist: np.ndarray  # private-label distribution, for β_priv


class DecentralizedTrainer:
    def __init__(
        self,
        bundles: Sequence[ModelBundle],
        optimizer: Optimizer,
        mhd_cfg: MHDConfig,
        run_cfg: RunConfig,
        arrays: Dict[str, np.ndarray],  # {"images": ..., "labels": ...}
        client_indices: Sequence[np.ndarray],
        public_indices: np.ndarray,
        graph: Adjacency,
        num_labels: int,
        exchange: str = "params",
        comm: Optional[Any] = None,  # repro_torch.comm.CommConfig
        transport: Optional[Any] = None,  # repro_torch.comm.Transport
        local_clients: Optional[Sequence[int]] = None,
        init_scheme: str = "legacy",
        membership: Optional[Any] = None,
        device: Optional[Any] = None,
    ):
        # ``local_clients``: the clients this process drives (one trainer
        # a process in a multi-process fleet; remote clients exist only as
        # mailbox senders). ``init_scheme``: "legacy" draws every client
        # from one chained generator, "per_client" only the local ones,
        # each from its own (`client_generator`). ``membership``
        # (`repro_torch.fleet.Membership`): clients dead at step 0 start
        # deactivated and the bus tombstones mail addressed to the dead;
        # the churn itself is applied from outside (`fleet.ChurnDriver`).
        if local_clients is not None and exchange == "params":
            raise ValueError(
                "local_clients requires a prediction exchange: the legacy "
                "params mode reads neighbor parameters from shared memory, "
                "which other processes don't have")
        if init_scheme not in ("legacy", "per_client"):
            raise ValueError(f"unknown init_scheme {init_scheme!r}; "
                             "known: legacy, per_client")
        if init_scheme == "per_client" and exchange == "params":
            raise ValueError(
                "init_scheme='per_client' skips materializing non-local "
                "clients; the legacy params exchange reads every client's "
                "raw params and needs the legacy scheme")
        self.device = resolve_device(device)
        # each bundle's distill-update arguments on meta, from its first
        # distillation step (the reference's _distill_arg_shapes)
        self._distill_arg_shapes: Dict[str, Tuple] = {}
        if not callable(graph):
            validate_adjacency(graph)
        self.graph_fn = as_graph_fn(graph)
        self.mhd_cfg = mhd_cfg
        self.run_cfg = run_cfg
        self.optimizer = optimizer
        self.num_labels = num_labels
        self.rng = np.random.default_rng(run_cfg.seed)
        self.public = PublicPool(arrays, public_indices,
                                 run_cfg.public_batch_size, seed=run_cfg.seed)

        self.exchange = exchange
        if exchange == "params":
            self.comm_cfg = self.codec = self.bus = self.meter = None
            pool_cls = CheckpointPool
        else:
            from repro_torch.comm import (CommConfig, CommMeter,
                                          LoopbackTransport, PredictionBus,
                                          PredictionPool, make_codec)

            self.comm_cfg = comm or CommConfig()
            self.codec = make_codec(exchange, self.comm_cfg)
            self.meter = CommMeter()
            self.bus = PredictionBus(
                transport if transport is not None else LoopbackTransport(),
                self.graph_fn, len(bundles), meter=self.meter,
                membership=membership)
            self.horizon = self.comm_cfg.horizon or mhd_cfg.pool_update_every
            pool_cls = PredictionPool
            self._pending: Dict[int, Dict[int, int]] = {
                i: {} for i in range(len(bundles))}

        if local_clients is None:
            self.local_ids = list(range(len(bundles)))
        else:
            self.local_ids = sorted({int(c) for c in local_clients})
            if any(i < 0 or i >= len(bundles) for i in self.local_ids):
                raise ValueError(f"local_clients {self.local_ids} out of "
                                 f"range for {len(bundles)} clients")
        self._arrays = arrays
        self._client_indices = list(client_indices)
        # the clients whose params this process drew (per_client: the
        # local ones only)
        self.initialized_clients: List[int] = []
        if init_scheme == "legacy":
            inits = init_fleet(bundles, run_cfg.seed, self.device)
        else:
            inits = [self._client_init(b, i) if i in self.local_ids
                     else None for i, b in enumerate(bundles)]
        self.clients: List[ClientState] = []
        for i, (bundle, params) in enumerate(zip(bundles, inits)):
            if params is not None:
                self.initialized_clients.append(i)
            self.clients.append(ClientState(
                client_id=i,
                bundle=bundle,
                params=params,
                opt_state=(None if params is None
                           else optimizer.init(params)),
                pool=pool_cls(mhd_cfg.pool_size, mhd_cfg.pool_update_every,
                              seed=run_cfg.seed + 101 * i),
                private_iter=BatchIterator(arrays, client_indices[i],
                                           run_cfg.batch_size,
                                           seed=client_stream_seed(
                                               run_cfg.seed, i)),
                label_hist=label_histogram(arrays["labels"],
                                           client_indices[i], num_labels),
            ))
        # clients dead at wall step 0 (scripted late joiners) start
        # deactivated: they neither step nor publish until activated
        self._dead: set = set()
        if membership is not None:
            alive0 = membership.alive(0)
            self._dead = {i for i in range(len(bundles)) if i not in alive0}
        self.local = [self.clients[i] for i in self.local_ids
                      if i not in self._dead]
        self._seed_pools(step=0)

    def _client_init(self, bundle: ModelBundle,
                     cid: int) -> Dict[str, Tensor]:
        """Client ``cid``'s params from its own generator, on the device."""
        gen = client_generator(self.run_cfg.seed, cid)
        return {k: v.to(self.device) for k, v in bundle.init(gen).items()}

    # -- per-client steps ---------------------------------------------------

    def _teacher_apply(self, bundle: ModelBundle) -> Callable:
        @torch.no_grad()
        def apply_fn(params, batch):
            out = bundle.apply(params, batch)
            keep = {"embedding": out["embedding"], "logits": out["logits"],
                    "aux_logits": out["aux_logits"]}
            # positions-as-samples bundles (repro_torch.lm) carry their own
            # targets and a position → sequence map: never on the wire
            # (the publish path names its keys), read by the evaluator
            for k in ("labels", "sample_rows"):
                if k in out:
                    keep[k] = out[k]
            return keep

        return apply_fn

    def _distill_update(self, c: ClientState, private_batch, public_batch,
                        teachers, step: int,
                        rng: Optional[torch.Generator]) -> Dict[str, Tensor]:
        if c.bundle.name not in self._distill_arg_shapes:
            # the update's arguments on meta, the first time this bundle
            # distils: enough to count the update again
            # (obs.metrics.distill_step_cost) without holding any data
            self._distill_arg_shapes[c.bundle.name] = meta_like(
                (c.params, c.opt_state, private_batch, public_batch,
                 teachers)) + (step, rng is not None)
        c.params, c.opt_state, metrics = distill_update(
            c.bundle, self.optimizer, self.mhd_cfg, c.params, c.opt_state,
            private_batch, public_batch, teachers, step, rng)
        return metrics

    def _supervised_update(self, c: ClientState, private_batch,
                           step: int) -> Dict[str, Tensor]:
        """Fallback step for clients with no usable teachers: Eq. (1) with
        both distillation terms zero — plain supervised CE."""
        params = {k: v.detach().requires_grad_() for k, v in c.params.items()}
        out = c.bundle.apply(params, private_batch)
        labels = out["labels"] if "labels" in out \
            else private_batch["labels"]
        ce = torch.nn.functional.cross_entropy(out["logits"].float(),
                                               labels.long())
        loss = ce
        if out.get("aux_loss") is not None:
            loss = loss + out["aux_loss"]
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()), allow_unused=True,
            materialize_grads=True)))
        c.params, c.opt_state = self.optimizer.update(
            grads, c.opt_state, c.params, step)
        return {"ce": ce, "loss": loss}

    # -- pool mechanics -----------------------------------------------------

    def _seed_pools(self, step: int) -> None:
        """Fill each pool from its neighbours' initial state: params in
        legacy mode, published prediction windows in prediction mode."""
        if self.exchange != "params":
            self._publish_round(step)
        adj = self.graph_fn(step)
        for c in self.local:
            for j in adj[c.client_id]:
                if len(c.pool) >= c.pool.capacity:
                    break
                entry = self._fetch_entry(c, j, step)
                if entry is not None:
                    c.pool.insert(entry)

    # -- client churn (repro_torch.fleet) ----------------------------------

    @property
    def active_ids(self) -> List[int]:
        """The locally driven clients currently alive (stepping order)."""
        return [c.client_id for c in self.local]

    def _require_local(self, cid: int) -> ClientState:
        if cid not in self.local_ids:
            raise ValueError(
                f"client {cid} is not driven by this process "
                f"(local: {self.local_ids})")
        return self.clients[cid]

    def deactivate_client(self, cid: int) -> None:
        """Kill one locally driven client: it stops stepping, publishing
        and pulling, and its mailbox, pending pulls and teacher pool die
        with it (params and optimizer state survive only in snapshots).
        Idempotent."""
        cid = int(cid)
        self._require_local(cid)
        self._dead.add(cid)
        self.local = [c for c in self.local if c.client_id != cid]
        if self.exchange != "params":
            self.bus.clear_mailbox(cid)
            self._pending[cid] = {}
        self.clients[cid].pool.entries.clear()

    def activate_client(self, cid: int) -> None:
        """(Re)activate a locally driven client whose state exists —
        restored from a snapshot (`repro_torch.fleet.snapshot`) or drawn
        by ``reinit_client``."""
        cid = int(cid)
        c = self._require_local(cid)
        if c.params is None:
            raise ValueError(
                f"client {cid} has no materialized state; restore it from "
                "a snapshot or call reinit_client first")
        self._dead.discard(cid)
        self.local = [self.clients[i] for i in self.local_ids
                      if i not in self._dead]

    def reinit_client(self, cid: int) -> None:
        """Fresh state for a joining or restarting client, as a relaunched
        process would build it: params from the client's own generator
        (`client_generator`, whatever the fleet's ``init_scheme``), fresh
        optimizer state, its private stream rewound to the start and a
        freshly seeded pool."""
        cid = int(cid)
        c = self._require_local(cid)
        c.params = self._client_init(c.bundle, cid)
        c.opt_state = self.optimizer.init(c.params)
        c.private_iter = BatchIterator(
            self._arrays, self._client_indices[cid], self.run_cfg.batch_size,
            seed=client_stream_seed(self.run_cfg.seed, cid))
        c.pool = type(c.pool)(self.mhd_cfg.pool_size,
                              self.mhd_cfg.pool_update_every,
                              seed=self.run_cfg.seed + 101 * cid)
        self.initialized_clients.append(cid)

    def _maybe_update_pools(self, step: int) -> None:
        if step % self.mhd_cfg.pool_update_every != 0:
            self._comm_tick(step)
            return
        if self.exchange != "params":
            self._publish_round(step)
            self._resolve_pending(step)  # older rounds' pulls first
        adj = self.graph_fn(step)
        for c in self.local:
            self._pull_client(c, step, adj)

    def _comm_tick(self, step: int) -> None:
        """Between pool rounds: drain in-flight mail and complete late
        pulls (nothing to do in the params mode)."""
        if self.exchange != "params":
            self.bus.deliver(step)
            self._resolve_pending(step)

    # -- op-granular entry points (core/scheduler.py) -----------------------
    # The scheduler issues a client's progress as LocalStep / Publish /
    # Pull / Resolve ops; these are the surfaces it drives
    # (``step_client(defer=True)`` is the LocalStep + Resolve pair).

    def comm_pump(self, step: int) -> None:
        """The transport pump op: deliver in-flight mail at wall tick
        ``step`` and complete late pulls."""
        self._comm_tick(step)

    def publish_clients(self, client_ids: Sequence[int], step: int) -> int:
        """The Publish op for a group of clients (they share the window's
        public batches); delivery is the pump's job. Returns the number
        of clients that had a receiver under G_t."""
        return self._publish_clients(list(client_ids), step)

    def pull_client(self, client_id: int, step: int,
                    adj: Optional[Adjacency] = None) -> None:
        """The Pull op: one pool-refresh pull for one client."""
        self._pull_client(self.clients[client_id], step, adj)

    def _pull_client(self, client: ClientState, step: int,
                     adj: Optional[Adjacency] = None) -> None:
        """One pool-refresh pull: draw a random in-neighbour (shared rng,
        consumed in client-id order) and insert its entry if usable."""
        nbrs = (adj if adj is not None
                else self.graph_fn(step))[client.client_id]
        if not nbrs:
            return
        j = int(self.rng.choice(list(nbrs)))
        entry = self._fetch_entry(client, j, step)
        trace.instant("runtime/pull", client=client.client_id, src=j,
                      step=step, hit=entry is not None)
        if entry is not None:
            client.pool.insert(entry)

    def _fetch_entry(self, client: ClientState, j: int,
                     step: int) -> Optional[PoolEntry]:
        """Teacher j's raw params (legacy) or its decoded mailbox window;
        a pull that finds no usable mail is recorded as pending."""
        if self.exchange == "params":
            return PoolEntry(j, self.clients[j].params, step)
        mail = self.bus.mailbox(client.client_id).get(j)
        if mail is None or mail.sent_step + self.horizon <= step:
            self._pending[client.client_id][j] = step
            return None
        return PoolEntry(j, self._decode_window(mail), mail.sent_step)

    def _resolve_pending(self, step: int) -> None:
        """Complete pulls that found no usable message at their round as
        soon as a window that still covers the current step arrives."""
        t0 = trace.now()
        resolved = 0
        for c in self.local:
            keep: Dict[int, int] = {}
            for j, rnd in self._pending[c.client_id].items():
                mail = self.bus.mailbox(c.client_id).get(j)
                if mail is not None and mail.sent_step >= rnd and \
                        mail.sent_step + self.horizon > step:
                    c.pool.insert(PoolEntry(j, self._decode_window(mail),
                                            mail.sent_step))
                    resolved += 1
                elif rnd + self.horizon > step:
                    keep[j] = rnd
            self._pending[c.client_id] = keep
        if resolved:
            trace.complete("runtime/resolve", t0, step=step,
                           resolved=resolved)

    # -- prediction exchange ------------------------------------------------

    def _publish_round(self, step: int) -> None:
        """Every client with a subscriber encodes and publishes, then mail
        is delivered (every round drains the transport, subscribed or
        not)."""
        self._publish_clients(None, step)
        self.bus.deliver(step)

    def _publish_clients(self, client_ids: Optional[Sequence[int]],
                         step: int) -> int:
        """The selected clients (None = every active local one) encode
        their predictions on the next ``horizon`` public batches and
        publish them; the caller delivers. Returns the number that had a
        receiver under G_t. A publisher whose outputs the codec refuses
        (non-finite) is skipped and metered."""
        from repro_torch.comm import NonFiniteError

        adj = self.graph_fn(step)
        subscribed = {j for nbrs in adj for j in nbrs}
        selected = self.local if client_ids is None else \
            [self.clients[i] for i in client_ids]
        todo = [c for c in selected if c.client_id in subscribed]
        if not todo:
            return 0
        W = self.horizon
        ids = np.stack([self.public.sample_ids(step + w) for w in range(W)])
        batches = [batch_to_device(self.public.sample(step + w), self.device)
                   for w in range(W)]
        for c in todo:
            t_fwd = trace.now()
            apply_fn = self._teacher_apply(c.bundle)
            frames = [apply_fn(c.params, b) for b in batches]
            outs = {key: torch.stack([f[key] for f in frames]).float()
                    for key in ("embedding", "logits", "aux_logits")}
            trace.complete("publish/forward", t_fwd, client=c.client_id,
                           step=step, window=W)
            t_enc = trace.now()
            try:
                payload = self.codec.encode(c.client_id, step, step, ids,
                                            outs)
            except NonFiniteError:
                self.meter.rejected_publishes += 1
                continue
            trace.complete("publish/encode", t_enc, client=c.client_id,
                           step=step, nbytes=len(payload))
            self.bus.publish(c.client_id, payload, step)
        return len(todo)

    def _decode_window(self, mail) -> Any:
        from repro_torch.comm import PredictionWindow

        with trace.span("wire/decode", src=mail.src,
                        nbytes=len(mail.payload)):
            msg = self.codec.decode(mail.payload)
            for w in range(msg.window):
                expect = self.public.sample_ids(msg.t0 + w).astype(np.uint64)
                if not np.array_equal(msg.arrays["sample_ids"][w], expect):
                    raise ValueError(
                        f"sample-id mismatch in message from client "
                        f"{msg.src} at public step {msg.t0 + w}")
            # densified once per received window, kept on the device
            return PredictionWindow(msg.t0, batch_to_device(
                self.codec.densify(msg), self.device))

    # -- teacher assembly ---------------------------------------------------

    def _stack_teachers(self, client: ClientState, public_batch,
                        step: int) -> Tuple[Optional[Dict[str, Tensor]], int]:
        """Sample Δ pool entries, drop the expired prediction windows and
        the entries the bounded-staleness gate rejects, and stack the
        survivors' public-batch outputs. Returns ``(teachers, skipped)``;
        teachers is None when nothing survived (supervised fallback)."""
        entries = client.pool.sample(self.mhd_cfg.delta)
        sampled = len(entries)
        if self.exchange != "params":
            entries = client.pool.usable(entries, step)
        ms = self.run_cfg.max_staleness
        if ms is not None:
            entries = [e for e in entries if step - e.step <= ms]
        skipped = sampled - len(entries)
        if skipped:
            trace.instant("runtime/gate_skip", client=client.client_id,
                          step=step, fresh=len(entries), skipped=skipped)
        if self.meter is not None and sampled:
            self.meter.record_gate(client.client_id, len(entries), skipped)
        if not entries:
            return None, skipped
        # pad to Δ by cycling over the originally sampled entries
        entries = [entries[i % len(entries)]
                   for i in range(self.mhd_cfg.delta)]
        outs = []
        for e in entries:
            if self.exchange == "params":
                teacher_bundle = self.clients[e.client_id].bundle
                outs.append(self._teacher_apply(teacher_bundle)(
                    e.params, public_batch))
            else:
                outs.append(e.params.frame(step))
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}, \
            skipped

    # -- training loop ------------------------------------------------------

    def step_client(self, c: ClientState, public_batch, t: int,
                    opt_step: Optional[int] = None, defer: bool = False):
        """One local optimization step for client ``c`` at (wall) step t.

        ``opt_step`` is the client's optimizer and LR-schedule step — its
        local step count under the scheduler; None = t (the synchronous
        loop, where the two clocks coincide). The bus clock, the
        confidence rng's seed and the trace use the wall step t.

        ``defer=True`` returns a zero-arg *resolve* callable: the update is
        queued on the device, and the one host sync that reads its metrics
        happens only when the callable runs — the caller runs the
        communication phase in between."""
        opt_step = t if opt_step is None else opt_step
        t_step = trace.now()
        if self.exchange != "params":
            self.bus.advance(c.client_id, t)
        private_batch = batch_to_device(c.private_iter.next(), self.device)
        teachers, skipped = self._stack_teachers(c, public_batch, t)
        t_up = trace.now()
        if teachers is None:
            metrics = self._supervised_update(c, private_batch, opt_step)
        else:
            rng = None
            if self.mhd_cfg.confidence == "random":
                rng = torch.Generator(device=self.device).manual_seed(
                    (t << 10) + c.client_id)
            metrics = self._distill_update(c, private_batch, public_batch,
                                           teachers, opt_step, rng)

        def resolve() -> Dict[str, float]:
            out = {f"c{c.client_id}/{k}": v
                   for k, v in read_metrics(metrics).items()}
            trace.complete(
                "runtime/supervised" if teachers is None
                else "runtime/distill",
                t_up, client=c.client_id, step=t, bundle=c.bundle.name)
            out[f"c{c.client_id}/stale_skipped"] = float(skipped)
            out[f"c{c.client_id}/distill_active"] = float(
                teachers is not None)
            if self.exchange != "params":
                out[f"c{c.client_id}/mail_staleness"] = \
                    self.bus.staleness(c.client_id, t)
            trace.complete("runtime/step", t_step, client=c.client_id,
                           step=t, distill=teachers is not None)
            return out

        return resolve if defer else resolve()

    def step(self, t: int) -> Dict[str, float]:
        public_batch = batch_to_device(self.public.sample(t), self.device)
        # queue every client's update, run the communication phase while
        # the device computes, then read the metrics (resolved LIFO so the
        # per-client trace spans nest)
        pending = [self.step_client(c, public_batch, t, defer=True)
                   for c in self.local]
        self._maybe_update_pools(t + 1)
        all_metrics: Dict[str, float] = {}
        for resolve in reversed(pending):
            all_metrics.update(resolve())
        return all_metrics

    def train(self, eval_arrays: Optional[Dict[str, np.ndarray]] = None,
              log_every: int = 0,
              eval_hook: Optional[Callable[[int, Dict], None]] = None):
        history = []
        for t in range(self.run_cfg.steps):
            metrics = self.step(t)
            if log_every and t % log_every == 0:
                loss = np.mean([v for k, v in metrics.items()
                                if k.endswith("/loss")])
                print(f"step {t}: mean client loss {loss:.4f}")
            if eval_arrays is not None and self.run_cfg.eval_every and \
                    (t + 1) % self.run_cfg.eval_every == 0:
                ev = self.evaluate(eval_arrays)
                history.append((t + 1, ev))
                if eval_hook:
                    eval_hook(t + 1, ev)
        return history

    # -- checkpointing ------------------------------------------------------

    def save(self, directory: str, step: int) -> None:
        """Persist every materialized client's (params, opt_state), one
        directory a client — a decentralized run is resumable per client
        (under ``init_scheme="per_client"`` a process saves its own)."""
        from repro_torch.checkpoint.io import save_client_states

        have = [c for c in self.clients if c.params is not None]
        save_client_states(directory, step,
                           [(c.params, c.opt_state) for c in have],
                           ids=[c.client_id for c in have])

    def restore(self, directory: str, step: Optional[int] = None) -> int:
        """Load every materialized client's (params, opt_state) onto
        ``self.device`` and reseed the pools at the restored step. Pools,
        mailboxes and the data streams are not part of a checkpoint (the
        fleet snapshot, `repro_torch.fleet.snapshot`, holds them)."""
        from repro_torch.checkpoint.io import restore_client_states

        have = [c for c in self.clients if c.params is not None]
        restored_step, states = restore_client_states(
            directory, [(c.params, c.opt_state) for c in have], step,
            ids=[c.client_id for c in have])
        for c, (params, opt_state) in zip(have, states):
            c.params = params
            c.opt_state = opt_state
        if self.exchange != "params":
            # construction-time windows are expired at the restored step —
            # drop them (and any stale pulls) so reseeding actually lands
            for c in self.clients:
                c.pool.entries.clear()
            self._pending = {c.client_id: {} for c in self.clients}
        self._seed_pools(step=restored_step)
        return int(restored_step)

    # -- evaluation (β_priv / β_sh, paper §4.2.1) ---------------------------

    def evaluate(self, arrays: Dict[str, np.ndarray]) -> Dict[str, float]:
        """Per-label accuracies on a uniform test set; β_sh = uniform mean,
        β_priv = mean weighted by the client's private label
        distribution."""
        m = self.mhd_cfg.num_aux_heads
        per_client = []
        for c in self.local:
            per_label, present = per_label_head_accuracy(
                self._teacher_apply(c.bundle), c.params, arrays,
                self.num_labels, m, self.run_cfg.eval_batch_size)
            per_client.append((c.client_id, per_label, present, c.label_hist))
        return fleet_beta_metrics(per_client, m)
