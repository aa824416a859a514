"""Multi-pod MHD: the paper's fused pod step, clients mapped to the 'pod'
mesh axis (port of ``repro/core/mhd_distributed.py``).

K clients co-train. The reference stacks them along a leading client dim
sharded over 'pod' and lets XLA partition each within its pod. In the
port every rank runs its own block of the fleet: the K clients split
into contiguous blocks over the pod ranks, a rank holding its clients'
params stacked (K/|pod|, …), each leaf cut to its block by the sharding
rules on the pod's axes (`launch.shardings.partition_specs`). Within a
pod the batch splits over the pod's token axes (the logical 'batch'
role: 'data' under ``"tp"``, whose 'model' ranks share their tokens and
split the layers; 'data' and 'model' under ``"fsdp"``). A rank's
gradient is its block of the pod's: the gathers' backward has summed it
over the token ranks that share the block, an all-reduce sums it over
those that hold the same block of other tokens, and it is divided by the
number of token shards (the pod's loss is their mean). A batch whose
rows the token shards do not divide runs whole on every rank of the pod,
as the reference's partitioner pads it. A clipping optimizer clips by the
norm of the whole fleet's gradient, every client's, as the reference's
step clips the stacked tree (`optim.optimizers.global_norm` under the
mesh, the 'pod' axis cutting the client dim).

Every step each client scores the shared public batch; teacher
predictions move between pods along the bus adjacency (``adj[i]`` names
client i's in-neighbor, `DistributedMHDConfig.neighbors`; None = the
1-hop ring). A pack whose student lives on its own rank moves locally
(at one pod rank, the reference's ``jnp.roll`` / ``jnp.take``); the
others cross in one ``all_to_all_single`` a leaf with split sizes only
to the partners, booked as the reference books its ring exchange,
``collective-permute`` (`roofline.op_cost.collective_kind`).

Wire formats:
  * ``exchange="full"`` — full-vocab teacher logits (+ embeddings);
  * ``exchange="topk"`` — the top-k logits + indices + the teacher's
    logsumexp (+ the embedding), packed by the ``topk_wire`` kernel
    (`comm.wire.topk_pack_outputs`); Λ stays exact, CE against the
    truncated teacher drops the mass beyond k.

The loss is the reference's mean over the K clients: a rank's loss is the
sum of its clients' terms over the global K, the reported loss and
metrics are all-reduced. Under ``"tp"`` each 'model' rank scores its
block of the public rows (`core.lm_adapter.lm_mhd_outputs`), and the
distillation term is the sum of the blocks' parts over 'model'.
``max_public_positions`` keeps the first positions of the whole public
batch, as the reference does: each token shard keeps those that fall in
its block of the flattened positions, and its term is its block's mean
times its share of them (a shard that keeps none runs its forward and
scores, packs and exchanges nothing). The
reference's `_topk_2stage` (a two-stage top-k for XLA's sort) has no
caller there and is not ported.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.comm.wire import (dense_xent_and_conf, sparse_xent_and_conf,
                                   topk_pack_outputs)
from repro_torch.common import sharding as SH
from repro_torch.common.sharding import (axis_index, mesh_axis_sizes,
                                         use_mesh)
from repro_torch.core.lm_adapter import lm_mhd_outputs
from repro_torch.core.mhd import MHDConfig, embedding_distillation_loss
from repro_torch.launch.shardings import partition_specs, shard_params
from repro_torch.models import transformer as TF
from repro_torch.models.layers import MetaDraw
from repro_torch.models.zoo import ModelBundle
from repro_torch.roofline import op_cost

Tensor = torch.Tensor
POD = "pod"


@dataclasses.dataclass(frozen=True)
class DistributedMHDConfig:
    """Pod-fleet shape + wire format.

    ``neighbors`` is the bus-style adjacency (``adj[i]`` = client i's
    in-neighbors, the same contract as `PredictionBus.graph_fn`'s output)
    restricted to exactly one teacher per client — the pod runtime is the
    Δ=1 fused path. ``None`` keeps the 1-hop ring (client i distills from
    client i-1 mod K)."""

    num_clients: int = 2  # = number of pods
    exchange: str = "full"  # "full" | "topk"
    topk: int = 32
    max_public_positions: int = 0  # cap distilled positions (0 = all)
    neighbors: Optional[Tuple[Tuple[int, ...], ...]] = None


def _teacher_sources(dist_cfg: DistributedMHDConfig) -> List[int]:
    """Resolve the adjacency to ``src[i]`` = the client whose prediction
    client i distills from, validating the Δ=1 contract."""
    K = dist_cfg.num_clients
    if dist_cfg.neighbors is None:
        return [(i - 1) % K for i in range(K)]
    if len(dist_cfg.neighbors) != K:
        raise ValueError(
            f"{len(dist_cfg.neighbors)} neighbor rows for {K} clients")
    srcs = []
    for i, nbrs in enumerate(dist_cfg.neighbors):
        if len(nbrs) != 1:
            raise ValueError(
                f"client {i} has {len(nbrs)} in-neighbors; the pod "
                "runtime is the fused Δ=1 path — exactly one teacher "
                "per client (use the host-loop runtime for wider "
                "distillation neighborhoods)")
        j = int(nbrs[0])
        if not 0 <= j < K or j == i:
            raise ValueError(f"client {i} names teacher {j}, not a "
                             f"distinct client in [0, {K})")
        srcs.append(j)
    return srcs


# ---------------------------------------------------------------------------
# the fleet's layout on the mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PodLayout:
    """Where this rank sits: its pod (``pod`` of ``n_pods``), its clients
    ``clients`` (a contiguous block of the K), the pod's axes ``inner``,
    and its block ``shard`` of the ``n_shards`` token shards of its pod
    over the axes ``tokens``."""

    num_clients: int
    n_pods: int
    pod: int
    inner: Tuple[str, ...]
    n_shards: int
    shard: int
    tokens: Tuple[str, ...] = ()

    @property
    def per_pod(self) -> int:
        return self.num_clients // self.n_pods

    @property
    def clients(self) -> range:
        return range(self.pod * self.per_pod, (self.pod + 1) * self.per_pod)

    def owner(self, client: int) -> int:
        return client // self.per_pod


def pod_layout(num_clients: int, mesh=None) -> PodLayout:
    """The layout of ``num_clients`` clients on ``mesh`` (None: one rank
    holding them all)."""
    sizes = mesh_axis_sizes(mesh) if mesh is not None else {}
    n_pods = sizes.get(POD, 1)
    if num_clients % n_pods:
        raise ValueError(f"{num_clients} clients do not split into "
                         f"{n_pods} pods")
    inner = tuple(a for a in sizes if a != POD)
    tokens = SH.token_axes({a: sizes[a] for a in inner})
    return PodLayout(
        num_clients, n_pods,
        int(mesh.get_local_rank(POD)) if POD in sizes else 0, inner,
        math.prod(sizes[a] for a in tokens),
        axis_index(mesh, tokens) if tokens else 0, tokens)


def pod_specs(bundle: ModelBundle, mesh, lay: PodLayout):
    """{name: spec} of the leaves cut on the pod's axes (no client dim)."""
    if not lay.inner:
        return {}
    return partition_specs(_meta_params(bundle),
                           mesh_axis_sizes(mesh, lay.inner))


def local_params(stacked: Dict[str, Tensor], bundle: ModelBundle,
                 num_clients: int, mesh=None) -> Dict[str, Tensor]:
    """This rank's block of the client-stacked params (K, …): its clients'
    rows, each leaf cut to its block on its pod's axes (`pod_specs`)."""
    lay = pod_layout(num_clients, mesh)
    rows = slice(lay.clients.start, lay.clients.stop)
    out = {k: v[rows] for k, v in stacked.items()}
    if lay.inner:
        sizes = mesh_axis_sizes(mesh, lay.inner)
        coords = {a: int(mesh.get_local_rank(a)) for a in lay.inner}
        out = shard_params(out, pod_specs(bundle, mesh, lay), sizes,
                           coords, lead=1)
    return {k: v.contiguous() for k, v in out.items()}


def _meta_params(bundle: ModelBundle) -> Dict[str, Tensor]:
    return bundle.init(MetaDraw().manual_seed(0))


# ---------------------------------------------------------------------------
# the teacher exchange
# ---------------------------------------------------------------------------

def _flat(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif v is not None:
            out[prefix + k] = v
    return out


def _unflat(flat: Dict[str, Tensor], like: Dict[str, Any],
            prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in like.items():
        if isinstance(v, dict):
            out[k] = _unflat(flat, v, f"{prefix}{k}/")
        else:
            out[k] = None if v is None else flat[prefix + k]
    return out


def exchange_teachers(packs: Sequence[Dict[str, Any]],
                      dist_cfg: DistributedMHDConfig, lay: PodLayout,
                      group=None) -> List[Dict[str, Any]]:
    """Each local student's teacher pack, from ``packs`` (this rank's
    clients' packs, in client order): local ones by reference, the rest
    in one ``all_to_all_single`` a leaf over ``group`` (the pod axis's),
    each rank sending only to the ranks whose students its clients
    teach."""
    srcs = _teacher_sources(dist_cfg)
    K = dist_cfg.num_clients
    if lay.n_pods == 1:
        # the reference's jnp.roll (a ring) / jnp.take along the clients
        return [packs[srcs[i]] for i in range(K)]
    base = lay.clients.start
    # sends: to each other pod, its students' teachers held here, in
    # student order; receives: the teachers of this pod's students held
    # elsewhere, by source pod, then student order
    sends = {p: [srcs[i] - base for i in range(p * lay.per_pod,
                                               (p + 1) * lay.per_pod)
                 if lay.owner(srcs[i]) == lay.pod]
             for p in range(lay.n_pods) if p != lay.pod}
    remote = [i for i in lay.clients if lay.owner(srcs[i]) != lay.pod]
    order = sorted(remote, key=lambda i: (lay.owner(srcs[i]), i))
    in_split = [len(sends.get(p, ())) for p in range(lay.n_pods)]
    out_split = [sum(1 for i in remote if lay.owner(srcs[i]) == p)
                 for p in range(lay.n_pods)]
    flats = [_flat(p) for p in packs]
    received: Dict[str, Tensor] = {}
    with op_cost.collective_kind("collective-permute"):
        for key, ref in flats[0].items():
            rows = [flats[j][key] for p in range(lay.n_pods)
                    for j in sends.get(p, ())]
            inp = (torch.stack(rows) if rows else
                   ref.new_empty((0, *ref.shape))).contiguous()
            out = ref.new_empty((len(order), *ref.shape))
            dist.all_to_all_single(out, inp, output_split_sizes=out_split,
                                   input_split_sizes=in_split, group=group)
            received[key] = out
    teachers = []
    for i in lay.clients:
        if lay.owner(srcs[i]) == lay.pod:
            teachers.append(packs[srcs[i] - base])
        else:
            j = order.index(i)
            teachers.append(_unflat({k: v[j] for k, v in received.items()},
                                    packs[0]))
    return teachers


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

def _distill_loss_one_client(student: Dict[str, Any],
                             teacher: Dict[str, Any], mhd: MHDConfig,
                             exchange: str) -> Tensor:
    """Eqs. (2),(4),(5) against ONE ring teacher (Δ=1 in the pod runtime).

    student: dense outputs; teacher: dense or top-k-packed, constants.
    Eq. 4's gate takes the teacher where its confidence is at least the
    self candidate's (ties go to the teacher)."""
    total = torch.zeros((), dtype=torch.float32,
                        device=student["logits"].device)
    emb = embedding_distillation_loss(
        student["embedding"], teacher["embedding"][None], mhd.nu_emb)
    for k in range(1, mhd.num_aux_heads + 1):
        student_head = student["aux_logits"][k - 1]
        self_src = (student["logits"] if k == 1
                    else student["aux_logits"][k - 2]).detach()
        if exchange == "topk":
            t_pack = (teacher["logits"] if k == 1 else
                      {n: v[k - 2] for n, v in teacher["aux_logits"].items()})
            ce_t, conf_t = sparse_xent_and_conf(student_head, t_pack)
        else:
            t_logits = (teacher["logits"] if k == 1
                        else teacher["aux_logits"][k - 2])
            ce_t, conf_t = dense_xent_and_conf(student_head, t_logits)
        ce_s, conf_s = dense_xent_and_conf(student_head, self_src)
        use_teacher = conf_t >= conf_s  # Eq. 4 argmax over {teacher, self}
        total = total + torch.where(use_teacher, ce_t, ce_s).mean()
    return mhd.nu_aux * total + emb


def _untaught(student: Dict[str, Any], mhd: MHDConfig) -> Tensor:
    """0 in place of `_distill_loss_one_client` on a rank that scores no
    row, differentiated through the same outputs (the student heads and,
    where Eq. 2 counts, the embedding), so that the backward runs the same
    collectives as on its peers."""
    used = [student["aux_logits"][k] for k in range(mhd.num_aux_heads)]
    if mhd.nu_emb != 0.0:
        used.append(student["embedding"])
    zero = student["logits"].new_zeros((), dtype=torch.float32)
    return zero + 0.0 * sum(u.float().sum() for u in used)


def _private_ce(bundle: ModelBundle, params, tokens: Tensor
                ) -> Tuple[Tensor, Tensor]:
    """(the next-token CE of the private batch, its MoE aux loss): the
    main head's logits at the B·(T−1) positions, cast to bf16 as
    `lm_mhd_outputs` gives them, their log-softmax in f32 (the aux heads,
    which nothing here reads, are not formed); vocabulary-parallel where
    the logits are blocks of the vocabulary (`TF.token_nll`)."""
    cfg = bundle.config
    skip_mtp = {"mtp": False} if getattr(cfg, "mtp", False) else {}
    out = bundle.apply(params, {"tokens": tokens}, logits=False, **skip_mtp)
    logits = TF.head_logits(params, cfg, out["hidden"][:, :-1])
    logits = logits.to(torch.bfloat16).float()
    if logits.shape[-1] < cfg.vocab_size:
        nll = TF.token_nll(logits, tokens[:, 1:], cfg.vocab_size)
        return nll.mean(), out["aux_loss"]
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, tokens[:, 1:, None].long())[..., 0]
    return -ll.mean(), out["aux_loss"]


def _stack_grads(grads: List[Dict[str, Tensor]]) -> Dict[str, Tensor]:
    out = {}
    for k in list(grads[0]):
        out[k] = torch.stack([g.pop(k) for g in grads])
    return out


def make_distributed_mhd_step(bundle: ModelBundle, optimizer,
                              mhd: MHDConfig,
                              dist_cfg: DistributedMHDConfig, mesh=None):
    """Returns train_step(state, batch) for this rank's block of the fleet.

    state["params"]: this rank's clients' params stacked (K/|pod|, …)
    (`local_params`); state["opt"] its optimizer state, state["step"] an
    int. batch: the fleet's {"private_tokens": (K, B, T), "public_tokens":
    (B_pub, T)}, the same on every rank: a rank takes its clients' rows
    and its token shard. ``mesh`` is a DeviceMesh with a 'pod' axis and
    any of 'data', 'model' (None: one rank, no process group). The step
    consumes ``state``, as `launch.steps.make_train_step` does.
    """
    K = dist_cfg.num_clients
    _teacher_sources(dist_cfg)
    if dist_cfg.exchange not in ("full", "topk"):
        raise ValueError(f"exchange {dist_cfg.exchange!r}")
    lay = pod_layout(K, mesh)
    Q = lay.n_shards
    pod_group = mesh.get_group(POD) if lay.n_pods > 1 else None
    specs = pod_specs(bundle, mesh, lay)
    n_inner = math.prod(mesh_axis_sizes(mesh, lay.inner).values()) \
        if lay.inner else 1

    def shard_rows(x: Tensor) -> Tuple[Tensor, bool]:
        """This rank's block of the rows over the pod's token shards, or
        all of them (True) where the shards do not divide them."""
        if x.shape[0] % Q:
            return x, True
        size = x.shape[0] // Q
        return x[lay.shard * size:(lay.shard + 1) * size], False

    def rows_mesh(whole: bool):
        """The pod's axes active, on the whole batch if ``whole``."""
        if not lay.inner:
            return use_mesh(None)
        return use_mesh(mesh, lay.inner, specs, whole_rows=whole)

    def kept_positions(n_blk: int, whole: bool) -> Tuple[int, int]:
        """(the positions this rank's block of ``n_blk`` public positions
        keeps, those the reference keeps of the whole public batch): the
        first max_public_positions of the flattened batch, split over the
        token shards' blocks in order."""
        total = n_blk * (1 if whole else Q)
        cap = dist_cfg.max_public_positions
        kept = min(cap, total) if cap else total
        first = 0 if whole else lay.shard * n_blk
        return min(max(kept - first, 0), n_blk), kept

    def fleet_specs(grads: Dict[str, Tensor]):
        lead = (POD,) if POD in mesh.mesh_dim_names else (None,)
        return {k: lead + tuple(specs.get(k, ())) for k in grads}

    def step(state: Dict[str, Any], batch: Dict[str, Tensor]):
        priv_all = batch["private_tokens"][lay.clients.start:
                                           lay.clients.stop]
        pub, pub_whole = shard_rows(batch["public_tokens"])
        priv_whole = bool(priv_all.shape[1] % Q)
        n_blk = pub.shape[0] * (pub.shape[1] - 1)
        keep, n_kept = kept_positions(n_blk, pub_whole)
        n_local = len(lay.clients)
        leaves = [{k: v[j].detach().requires_grad_()
                   for k, v in state["params"].items()}
                  for j in range(n_local)]
        ce, pub_outs, aux = [], [], []
        with rows_mesh(False):
            part = SH.active_partition()
            R = TF.vocab_shards(bundle.config)
            for j in range(n_local):
                with rows_mesh(priv_whole):
                    ce_j, priv_aux = _private_ce(
                        bundle, leaves[j], shard_rows(priv_all[j])[0])
                # a block that keeps no position still runs the forward
                # (its collectives), and distills nothing
                with rows_mesh(pub_whole):
                    out = lm_mhd_outputs(
                        bundle, leaves[j], {"tokens": pub},
                        max_positions=keep if keep < n_blk else 0)
                ce.append(ce_j)
                pub_outs.append({"embedding": out["embedding"],
                                 "logits": out["logits"],
                                 "aux_logits": out["aux_logits"]})
                aux.append(out["aux_loss"] + priv_aux)
            # the rows this rank scores: its block's kept positions, of
            # which each model rank holds a block under "tp"
            rows = out["labels"].shape[0] if keep else 0
            frozen = wire = teachers = None
            if rows:
                # stop-grad BEFORE packing: the top-k must not be
                # differentiated (it only feeds the frozen teacher side)
                frozen = [{k: (None if v is None else v.detach())
                           for k, v in o.items()} for o in pub_outs]
                wire = ([topk_pack_outputs(f, dist_cfg.topk)
                         for f in frozen]
                        if dist_cfg.exchange == "topk" else frozen)
                teachers = exchange_teachers(wire, dist_cfg, lay, pod_group)
                dist_loss = [_distill_loss_one_client(s, t, mhd,
                                                      dist_cfg.exchange)
                             for s, t in zip(pub_outs, teachers)]
            else:
                dist_loss = [_untaught(o, mhd) for o in pub_outs]
            # the reference's term is the mean over its kept positions:
            # each rank's block mean times its share of them, times the
            # token shards the pod's mean is over (1 where every block
            # keeps all its positions), summed over 'model' where each
            # model rank scored its block of the rows
            share = (1 if pub_whole else Q) * rows / n_kept
            if R > 1:
                dist_loss = [SH.tp_exit(d * share, part) for d in dist_loss]
            elif share != 1:
                dist_loss = [d * share for d in dist_loss]
            ce_sum, dist_sum = sum(ce) / K, sum(dist_loss) / K
            loss = ce_sum + dist_sum + sum(aux) / K
            flat = [v for lv in leaves for v in lv.values()]
            # inside the mesh: a rematerialised unit gathers its blocks
            # again in the backward
            grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                        materialize_grads=True)
        names = list(leaves[0])
        per_client = [dict(zip(names, grads[j * len(names):
                                            (j + 1) * len(names)]))
                      for j in range(n_local)]
        metrics = torch.stack([loss.detach(), ce_sum.detach(),
                               dist_sum.detach()])
        del loss, ce, pub_outs, aux, frozen, wire, teachers, dist_loss
        del leaves, flat, grads
        grads = _stack_grads(per_client)
        if Q > 1:
            # the pod's objective is the mean of its token shards' losses
            SH.mean_over_token_shards(grads, specs, mesh, lay.tokens)
        if mesh is not None:
            # every inner rank holds its token shard's values (the model
            # ranks of a shard the same under "tp")
            dist.all_reduce(metrics)
            metrics = metrics / n_inner
        # a clipping optimizer's norm covers the fleet: every client's
        # blocks, the pod axis cutting the client dim
        with use_mesh(mesh, None, fleet_specs(grads)) if mesh is not None \
                else use_mesh(None):
            params, opt = optimizer.update(grads, state["opt"],
                                           state["params"], state["step"])
        new_state = {"params": params, "opt": opt, "step": state["step"] + 1}
        return new_state, {"loss": metrics[0], "ce": metrics[1],
                           "dist": metrics[2]}

    return step
