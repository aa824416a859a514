"""Decentralized MHD runtime (paper §4.1), in PyTorch — port of the
synchronous path of ``repro/core/runtime.py``.

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

The numpy rng draws and their order are the reference's (the neighbour
pull, the pool sample, the pool seeds, the public and private streams), so
given the same initial parameters both packages choose the same teachers
at the same steps. Not ported yet: ``local_clients``, ``membership``,
``init_scheme="per_client"``, the scheduler's op-granular entry points
and its ``max_staleness`` gate, and checkpointing; they raise or are
absent.

Runs on the GPU unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

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


@dataclasses.dataclass
class RunConfig:
    steps: int = 1000
    batch_size: int = 32
    public_batch_size: int = 32
    eval_every: int = 200
    eval_batch_size: int = 256
    seed: int = 0


@dataclasses.dataclass
class ClientState:
    client_id: int
    bundle: ModelBundle
    params: Dict[str, Tensor]
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
        if local_clients is not None or membership is not None or \
                init_scheme != "legacy":
            raise NotImplementedError(
                "local_clients, membership and init_scheme='per_client' "
                "belong to the multi-process and fleet layers, a later "
                "slice of the port")
        self.device = resolve_device(device)
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
                self.graph_fn, len(bundles), meter=self.meter)
            self.horizon = self.comm_cfg.horizon or mhd_cfg.pool_update_every
            pool_cls = PredictionPool
            self._pending: Dict[int, Dict[int, int]] = {
                i: {} for i in range(len(bundles))}

        self.local_ids = list(range(len(bundles)))
        self.clients: List[ClientState] = []
        # one CPU generator chained through every client's init, so the
        # draw does not depend on the device
        gen = torch.Generator().manual_seed(run_cfg.seed)
        for i, bundle in enumerate(bundles):
            params = {k: v.to(self.device) for k, v in bundle.init(gen).items()}
            self.clients.append(ClientState(
                client_id=i,
                bundle=bundle,
                params=params,
                opt_state=optimizer.init(params),
                pool=pool_cls(mhd_cfg.pool_size, mhd_cfg.pool_update_every,
                              seed=run_cfg.seed + 101 * i),
                private_iter=BatchIterator(arrays, client_indices[i],
                                           run_cfg.batch_size,
                                           seed=client_stream_seed(
                                               run_cfg.seed, i)),
                label_hist=label_histogram(arrays["labels"],
                                           client_indices[i], num_labels),
            ))
        self.local = list(self.clients)
        self._seed_pools(step=0)

    # -- host → device ------------------------------------------------------

    def _batch(self, batch_np: Dict[str, np.ndarray]) -> Dict[str, Tensor]:
        return {k: torch.from_numpy(np.require(v, requirements="CW"))
                .to(self.device) for k, v in batch_np.items()}

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
        params = {k: v.detach().requires_grad_() for k, v in c.params.items()}
        loss, metrics = client_loss(c.bundle, params, private_batch,
                                    public_batch, teachers, self.mhd_cfg, rng)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True, materialize_grads=True)
        c.params, c.opt_state = self.optimizer.update(
            dict(zip(params, grads)), c.opt_state, c.params, step)
        metrics["loss"] = loss
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
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True, materialize_grads=True)
        c.params, c.opt_state = self.optimizer.update(
            dict(zip(params, grads)), c.opt_state, c.params, step)
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

    def _maybe_update_pools(self, step: int) -> None:
        if step % self.mhd_cfg.pool_update_every != 0:
            if self.exchange != "params":
                self.bus.deliver(step)
                self._resolve_pending(step)
            return
        if self.exchange != "params":
            self._publish_round(step)
            self._resolve_pending(step)  # older rounds' pulls first
        adj = self.graph_fn(step)
        for c in self.local:
            self._pull_client(c, step, adj)

    def _pull_client(self, client: ClientState, step: int,
                     adj: Adjacency) -> None:
        """One pool-refresh pull: draw a random in-neighbour (shared rng,
        consumed in client-id order) and insert its entry if usable."""
        nbrs = adj[client.client_id]
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
        is delivered."""
        from repro_torch.comm import NonFiniteError

        adj = self.graph_fn(step)
        subscribed = {j for nbrs in adj for j in nbrs}
        todo = [c for c in self.local if c.client_id in subscribed]
        if todo:
            W = self.horizon
            ids = np.stack([self.public.sample_ids(step + w)
                            for w in range(W)])
            batches = [self._batch(self.public.sample(step + w))
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
        self.bus.deliver(step)

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
            return PredictionWindow(msg.t0, self._batch(
                self.codec.densify(msg)))

    # -- teacher assembly ---------------------------------------------------

    def _stack_teachers(self, client: ClientState, public_batch,
                        step: int) -> Tuple[Optional[Dict[str, Tensor]], int]:
        """Sample Δ pool entries, drop the expired prediction windows, and
        stack the survivors' public-batch outputs. Returns ``(teachers,
        skipped)``; teachers is None when nothing survived (supervised
        fallback)."""
        entries = client.pool.sample(self.mhd_cfg.delta)
        sampled = len(entries)
        if self.exchange != "params":
            entries = client.pool.usable(entries, step)
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
                    defer: bool = False):
        """One local optimization step for client ``c`` at step t.

        ``defer=True`` returns a zero-arg *resolve* callable: the update is
        queued on the device, and the one host sync that reads its metrics
        happens only when the callable runs — the synchronous loop runs
        the communication phase in between."""
        t_step = trace.now()
        if self.exchange != "params":
            self.bus.advance(c.client_id, t)
        private_batch = self._batch(c.private_iter.next())
        teachers, skipped = self._stack_teachers(c, public_batch, t)
        t_up = trace.now()
        if teachers is None:
            metrics = self._supervised_update(c, private_batch, t)
        else:
            rng = None
            if self.mhd_cfg.confidence == "random":
                rng = torch.Generator(device=self.device).manual_seed(
                    (t << 10) + c.client_id)
            metrics = self._distill_update(c, private_batch, public_batch,
                                           teachers, t, rng)

        def resolve() -> Dict[str, float]:
            names = list(metrics)
            vals = torch.stack([metrics[k].detach().float().reshape(())
                                for k in names]).tolist()
            out = {f"c{c.client_id}/{k}": v for k, v in zip(names, vals)}
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
        public_batch = self._batch(self.public.sample(t))
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
