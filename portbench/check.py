"""What decides ``correct``: the plain reference draws its own feed (each
client's private batches and teachers and each step's public batch, by
the pipeline's documented sampling, `data/draws.py`), computes each
teacher's seed window, follows each client through the first
``checked_steps`` steps from the same weights, and five numbers compare
its readings with the program's:

  feed_gap    the draws in which the program's feed differs from the
              reference's: each client's private batch and sampled
              teachers at each checked step, each checked step's public
              batch, and which teachers' windows each student's pool
              holds. Exact: its limit is 0;
  loss_gap    the worst |loss − reference loss| / |reference loss| over
              every client and checked step;
  grad_gap    the worst leaf's gap between the norms of the first
              gradient as the optimizer got it (the program's worked out
              from its state after one step, the optimizer reference's
              ``first_gradient``), against the larger of the leaf's
              reference norm and the median leaf's;
  change_gap  the same for the norm of each leaf's change over the
              checked steps, leaving out leaves whose reference gradient
              is under a thousandth of the median leaf's;
  wire_gap    the seed windows as every student holds them, by the
              wire's digest (for the adaptive wire: each row's k + 1
              largest logits, sorted), against the reference's; the
              largest absolute difference.

The parts are the traffic's: ``task``, ``exchange`` and ``optimizer``
name modules under ``reference/`` (`spec.parts`). The reference runs
after the window, once the program's state is freed, one client at a
time, in float64 (or, for the control, in float32 with TF32 on).
"""
from __future__ import annotations

import importlib
import types
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from portbench import spec
from portbench import weights as W
from portbench.data import draws

NUMBERS = ("feed_gap", "loss_gap", "grad_gap", "change_gap", "wire_gap")


def reference_module(name: str):
    return importlib.import_module(f"portbench.reference.{name}")


class Readings:
    """One side's readings: loss per client and checked step, first
    gradient and change norms per client and leaf, the digests of the
    seed windows by (student, teacher), and the feed."""

    def __init__(self, clients: int):
        self.loss: List[List[float]] = [[] for _ in range(clients)]
        self.grad: List[Dict[str, float]] = [{} for _ in range(clients)]
        self.change: List[Dict[str, float]] = [{} for _ in range(clients)]
        self.windows: Dict = {}
        self.feed = None


def reference_feed(traffic: dict, data) -> types.SimpleNamespace:
    """The feed of the checked steps by the documented sampling:
    ``private[i][t]`` and ``public[t]`` batches, ``teacher[i][t]`` ids,
    ``pools[i]`` the teachers client i holds after the seed round, and
    ``public_at(t)`` any step's public batch."""
    arrays, public, private = data
    K, S = traffic["clients"], traffic["checked_steps"]
    b, m, seed = traffic["batch"], traffic["mhd"], traffic["schedule_seed"]
    pub_arrays = {k: v for k, v in arrays.items() if k != "labels"}

    def public_at(t: int) -> Dict[str, np.ndarray]:
        return draws.take(pub_arrays, draws.public_indices(
            public, b["public"], seed, t))

    nbrs = draws.graph(traffic["graph"], K)
    pools = [draws.pool(nbrs[i], m["pool_size"]) for i in range(K)]
    return types.SimpleNamespace(
        private=[[draws.take(arrays, sel) for sel in draws.private_indices(
            private[i], b["private"], seed, i, S)] for i in range(K)],
        public={t: public_at(t) for t in range(S)}, public_at=public_at,
        pools=pools,
        teacher=[draws.teachers(pools[i], m["delta"], seed, i, S)
                 for i in range(K)])


def _same(got: Optional[Dict[str, np.ndarray]],
          want: Dict[str, np.ndarray]) -> bool:
    return got is not None and all(
        k in got and np.array_equal(got[k], v) for k, v in want.items())


def feed_gap(program, reference, steps: int) -> int:
    """The number of draws of the checked steps in which ``program``'s
    feed differs from ``reference``'s."""
    bad = 0
    for i, want in enumerate(reference.private):
        got = program.private[i]
        bad += sum(not _same(got[t] if t < len(got) else None, want[t])
                   for t in range(steps))
        got = program.teacher[i]
        bad += sum((got[t] if t < len(got) else None) !=
                   reference.teacher[i][t] for t in range(steps))
        bad += sorted(program.pools[i]) != sorted(reference.pools[i])
    bad += sum(not _same(program.public.get(t), reference.public[t])
               for t in range(steps))
    return bad


def _cut(out: Dict[str, torch.Tensor], n: int) -> Dict[str, torch.Tensor]:
    """The first n rows of each output (rows are the second last dim)."""
    return {k: v.narrow(v.dim() - 2, 0, n) for k, v in out.items()}


def teacher_frames(model, task, wire, config: dict, traffic: dict,
                   seed: int, teacher: int,
                   public_at: Callable[[int], Dict[str, np.ndarray]],
                   device, dtype):
    """What a student holds of ``teacher``'s seed window, by step: the
    teacher's outputs from its initial weights on each public batch the
    window covers, through the wire."""
    params = {k: v.to(dtype) for k, v in W.make_weights(
        model.leaves(config), model.init_kind, seed, teacher,
        device).items()}
    with torch.no_grad():
        return wire.receive(lambda t: task.outputs(
            model, params, config, public_at(t), traffic, device),
            traffic, config)


def run_reference(config: dict, traffic: dict, seed: int, data, device,
                  dtype=torch.float64, tf32: bool = False,
                  fault: Optional[str] = None) -> Readings:
    """The reference's readings over the checked steps, on the
    benchmark's ``data`` (arrays, public indices, private indices).
    ``fault`` plants one of the faults the check must catch, in the
    reference put in the program's place: "half" (half of each batch's
    rows left out, the mean over the rest), "token" (one published
    token altered), "exchange" (no teacher: the supervised step)."""
    model = reference_module(config["reference"])
    p = spec.parts(traffic)
    task, wire, optim = p["task"], p["wire"], p["optim"]
    K, S = traffic["clients"], traffic["checked_steps"]
    out = Readings(K)
    feed = out.feed = reference_feed(traffic, data)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        frames: Dict[int, Dict[int, Dict[str, torch.Tensor]]] = {}
        for j in sorted({j for pool in feed.pools for j in pool}):
            frames[j] = teacher_frames(model, task, wire, config, traffic,
                                       seed, j, feed.public_at, device,
                                       dtype)
            if fault == "token":
                # one published token's prediction altered where it is
                # produced: position 0 carries position 1's row
                for f in frames[j].values():
                    for v in f.values():
                        v[..., 0, :] = v[..., 1, :]
            d = wire.digest(frames[j], traffic)
            for i, pool in enumerate(feed.pools):
                if d is not None and j in pool:
                    out.windows[(i, j)] = d
        for i in range(K):
            params = {k: v.to(dtype) for k, v in W.make_weights(
                model.leaves(config), model.init_kind, seed, i,
                device).items()}
            start = {k: v.clone() for k, v in params.items()}
            state: Dict[str, Dict[str, torch.Tensor]] = {}
            for t in range(S):
                priv = feed.private[i][t]
                leaves = {k: v.detach().requires_grad_() for k, v in
                          params.items()}
                o_priv = task.outputs(model, leaves, config, priv, traffic,
                                      device)
                labels = task.labels(priv, traffic, device)
                o_pub = teacher = None
                if fault != "exchange" and feed.teacher[i][t]:
                    o_pub = task.outputs(model, leaves, config,
                                         feed.public[t], traffic, device)
                    teacher = frames[feed.teacher[i][t][0]][t]
                if fault == "half":
                    n = labels.shape[0] // 2
                    o_priv, labels = _cut(o_priv, n), labels[:n]
                    if teacher is not None:
                        o_pub, teacher = _cut(o_pub, n), _cut(teacher, n)
                loss = task.objective(o_priv, labels, o_pub, teacher,
                                      traffic)
                grads = dict(zip(leaves, torch.autograd.grad(
                    loss, list(leaves.values()), allow_unused=True,
                    materialize_grads=True)))
                del leaves, o_priv, o_pub
                with torch.no_grad():
                    clipped = optim.step(params, grads, state, t,
                                         traffic["optimizer"])
                out.loss[i].append(float(loss.detach()))
                if t == 0:
                    out.grad[i] = leaf_norms(clipped)
                del grads, clipped
            out.change[i] = {k: float(torch.linalg.vector_norm(
                (params[k] - start[k]).double())) for k in params}
            del params, start, state
            if device.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev
    return out


def leaf_norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def worst_gap(program: Dict[str, float], reference: Dict[str, float],
              leaves: List[str]):
    """(gap, leaf): the worst leaf's gap between the two sides' norms,
    against the larger of its reference norm and the median leaf's; a
    leaf the program lacks reads 1."""
    med = float(np.median([reference[k] for k in leaves]))
    worst, name = 0.0, ""
    for k in leaves:
        if k not in program:
            return 1.0, k
        gap = abs(program[k] - reference[k]) / max(reference[k], med)
        if gap > worst:
            worst, name = gap, k
    return worst, name


def gaps(program: Readings, reference: Readings) -> Dict[str, object]:
    """The five numbers of ``program`` against ``reference``, and the
    leaves that gave the two leaf-wise ones (``grad_leaf``,
    ``change_leaf``)."""
    loss = max(abs(p - r) / abs(r)
               for pl, rl in zip(program.loss, reference.loss)
               for p, r in zip(pl, rl))
    grad = change = (0.0, "")
    for i in range(len(reference.grad)):
        g_ref = reference.grad[i]
        names = list(g_ref)
        grad = max(grad, worst_gap(program.grad[i], g_ref, names))
        med = float(np.median([g_ref[k] for k in names]))
        moved = [k for k in names if g_ref[k] >= 1e-3 * med]
        change = max(change, worst_gap(program.change[i],
                                       reference.change[i], moved))
    # a window one side lacks is the feed's to count (the pools)
    wire = max((float((program.windows[k] - reference.windows[k]).abs()
                      .max()) for k in program.windows
                if k in reference.windows), default=0.0)
    steps = len(reference.loss[0])
    return {"feed_gap": feed_gap(program.feed, reference.feed, steps),
            "loss_gap": loss, "grad_gap": grad[0], "change_gap": change[0],
            "wire_gap": wire, "grad_leaf": grad[1],
            "change_leaf": change[1]}
