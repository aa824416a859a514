"""Multi-process runs for the port's distributed CPU tests (not a test
module): `start_ranks` spawns one process a rank into one gloo process
group, rendezvous through a FileStore under the caller's temporary
directory (never a fixed TCP port: xdist workers run side by side), every
group with a 60 s timeout; the caller works meanwhile, then `wait_ranks`
joins every process with a deadline, terminating all and failing on
expiry. The rank bodies below import torch
and the port only (no jax): `pod_steps` runs
`core.mhd_distributed.make_distributed_mhd_step`, `a2a_cases`
`models.moe_a2a.moe_apply_a2a`, `tp_steps` the sharded
`launch.steps.make_train_step` / `make_mhd_train_step`,
`vocab_rows_case` `common.sharding.vocab_to_rows`, each reading its
inputs from and writing each rank's results to ``torch.save`` files.
"""
import datetime
import multiprocessing
import os
import time
import traceback

TIMEOUT_S = 240.0


def _entry(fn, rank, world, store, err, args):
    import torch
    import torch.distributed as dist

    import test_torch_threads

    test_torch_threads.share_cores()
    torch.set_num_threads(max(1, torch.get_num_threads() // world))
    for op in (torch.exp, torch.log, torch.sqrt, torch.tanh):
        op(torch.ones(1))
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        fn(rank, world, *args)
    except BaseException:
        with open(f"{err}.{rank}", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def start_ranks(fn, world: int, tmp_dir: str, *args):
    """Spawn the ``world`` ranks running ``fn(rank, world, *args)``; the
    caller may work meanwhile, then `wait_ranks`."""
    ctx = multiprocessing.get_context("spawn")
    store = os.path.join(tmp_dir, f"store{world}")
    err = os.path.join(tmp_dir, f"err{world}")
    procs = [ctx.Process(target=_entry,
                         args=(fn, r, world, store, err, args))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, err, time.monotonic()


def wait_ranks(handle, timeout: float = TIMEOUT_S) -> None:
    """Join the ranks of `start_ranks`; raise with the failing ranks'
    tracebacks, or ``timeout`` seconds after their start with every
    process terminated."""
    procs, err, start = handle
    deadline = start + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(5)
    if hung:
        raise AssertionError(f"ranks {hung} of {len(procs)} still running "
                             f"after {timeout} s: terminated")
    bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        msgs = []
        for r in bad:
            path = f"{err}.{r}"
            msgs.append(open(path).read() if os.path.exists(path)
                        else f"rank {r}: exit code {procs[r].exitcode}")
        raise AssertionError("\n".join(msgs))


# ---------------------------------------------------------------------------
# rank bodies
# ---------------------------------------------------------------------------

def pod_steps(rank, world, in_path, out_path):
    """Every case of ``in_path`` on this rank's block of the fleet: its
    params after the steps (each leaf its block by the sharding rules on
    its pod's axes, under the strategy the case names, "tp" by default),
    each step's metrics, its clients, its coordinates in its pod, the
    leaves' specs and, for a case with ``"record_rows"``, the rows of
    each call of the distillation loss (`_distill_loss_one_client`)."""
    import torch

    from repro_torch.core import mhd_distributed as MD
    from repro_torch.core.mhd import MHDConfig
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.shardings import apply_sharding_strategy
    from repro_torch.models import build_bundle
    from repro_torch.optim import OptimizerConfig, make_optimizer

    cases = torch.load(in_path, weights_only=False)
    out = {}
    meshes = {}
    for name, c in cases.items():
        shape, axes = c["mesh"][world]
        if (shape, axes) not in meshes:
            meshes[shape, axes] = make_test_mesh(shape, axes, "cpu")
        mesh = meshes[shape, axes]
        apply_sharding_strategy(c.get("sharding", "tp"))
        bundle = build_bundle(c["cfg"])
        opt = make_optimizer(OptimizerConfig(**c["opt"]))
        dcfg = MD.DistributedMHDConfig(**c["dist"])
        step = MD.make_distributed_mhd_step(bundle, opt, MHDConfig(**c["mhd"]),
                                            dcfg, mesh)
        params = MD.local_params(c["params"], bundle, dcfg.num_clients, mesh)
        state = {"params": params, "opt": opt.init(params), "step": 0}
        metrics, rows = [], []
        distill = MD._distill_loss_one_client
        if c.get("record_rows"):
            def recorded(student, *args):
                rows.append(int(student["logits"].shape[0]))
                return distill(student, *args)

            MD._distill_loss_one_client = recorded
        try:
            for batch in c["batches"]:
                state, m = step(state, batch)
                metrics.append({k: float(v) for k, v in m.items()})
        finally:
            MD._distill_loss_one_client = distill
        lay = MD.pod_layout(dcfg.num_clients, mesh)
        sizes = dict(zip(axes, shape))
        inner = {a: sizes[a] for a in lay.inner}
        out[name] = {"params": state["params"], "metrics": metrics,
                     "clients": list(lay.clients), "inner": lay.inner,
                     "coords": tuple(int(mesh.get_local_rank(a))
                                     for a in lay.inner),
                     "sizes": inner,
                     "specs": MD.pod_specs(bundle, mesh, lay),
                     "distilled_rows": rows}
        apply_sharding_strategy("tp")
    torch.save(out, f"{out_path}.{rank}")


def a2a_cases(rank, world, in_path, out_path):
    """Every case of ``in_path`` whose mesh has ``world`` ranks:
    `moe_apply_a2a` on this rank's block of the tokens over every axis
    (the ``"fsdp"`` strategy's layout) and its shards of the expert
    weights (cut by the sharding rules), then the backward of
    its loss |ranks|·Σ y·cot + c·aux, whose mean over the ranks is the
    reference's Σ y·cot + c·aux. Writes y, the aux, each leaf's gradient
    under the mean convention (summed over the ranks that hold the same
    block of it, then divided by the number of ranks; the token block's
    divided) and the rank's coordinates."""
    import torch
    import torch.distributed as dist

    from repro_torch.common.sharding import axis_index, group_of, use_mesh
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.shardings import (apply_sharding_strategy,
                                              param_pspec, shard_leaf)
    from repro_torch.models.moe_a2a import moe_apply_a2a

    apply_sharding_strategy("fsdp")
    cases = torch.load(in_path, weights_only=False)
    out, meshes = {}, {}
    for name, c in cases.items():
        shape, axes = c["mesh"]
        if len(shape) and int(torch.tensor(shape).prod()) != world:
            continue
        if (shape, axes) not in meshes:
            meshes[shape, axes] = make_test_mesh(shape, axes, "cpu")
        mesh = meshes[shape, axes]
        sizes = dict(zip(axes, shape))
        coords = {a: int(mesh.get_local_rank(a)) for a in axes}
        n = world
        blk = axis_index(mesh, axes)
        rows = c["x"].shape[0] // n
        x = c["x"][blk * rows:(blk + 1) * rows].clone().requires_grad_()
        cot = c["cot"][blk * rows:(blk + 1) * rows]
        params, specs = {}, {}
        for k, v in c["params"].items():
            spec = param_pspec(f"ffn/{k}", tuple(v.shape), sizes)
            if k in ("w_gate", "w_up", "w_down") and any(
                    e is not None for e in spec):
                specs[k] = spec
                v = shard_leaf(v, spec, sizes, coords)
            params[k] = v.clone().requires_grad_()
        with use_mesh(mesh):
            y, aux = moe_apply_a2a(params, x, c["cfg"], scoring=c["scoring"])
        loss = n * (y * cot).sum() + c["c"] * aux
        loss.backward()
        grads = {"x": x.grad / n}
        for k, v in params.items():
            g = v.grad
            used = {a for e in specs.get(k, ()) if e is not None
                    for a in ((e,) if isinstance(e, str) else e)}
            rest = tuple(a for a in axes if a not in used)
            if rest:  # summed over the ranks that hold the same block
                dist.all_reduce(g, group=group_of(mesh, rest))
            grads[k] = g / n
        out[name] = {"y": y.detach(), "aux": float(aux.detach()),
                     "grads": grads,
                     "coords": tuple(coords[a] for a in axes),
                     "specs": specs}
    torch.save(out, f"{out_path}.{rank}")


def tp_steps(rank, world, in_path, out_path):
    """Every case of ``in_path`` whose (data, model) mesh has ``world``
    ranks, under the case's strategy, from this rank's blocks of the
    case's params (cut by `launch.shardings.partition_specs`) over its
    global batches: `launch.steps.make_train_step`, or for a case with
    ``"mhd"`` `make_mhd_train_step` with the Δ teachers' blocks cut alike.
    A case with ``"count"`` counts its first step with
    `roofline.op_cost.OpCounter`. Writes the rank's blocks after the
    steps, each step's metrics, its coordinates, the specs, the blocks'
    shapes from `train_state_shapes` and the count."""
    import torch

    from repro_torch.common.sharding import active_partition, use_mesh
    from repro_torch.core.mhd import MHDConfig
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.shardings import apply_sharding_strategy
    from repro_torch.models import build_bundle
    from repro_torch.optim import OptimizerConfig, make_optimizer
    from repro_torch.roofline.op_cost import OpCounter

    cases = torch.load(in_path, weights_only=False)
    out, meshes = {}, {}
    for name, c in cases.items():
        shape, axes = c["mesh"]
        if int(torch.tensor(shape).prod()) != world:
            continue
        if (shape, axes) not in meshes:
            meshes[shape, axes] = make_test_mesh(shape, axes, "cpu")
        mesh = meshes[shape, axes]
        apply_sharding_strategy(c["sharding"])
        try:
            bundle = build_bundle(c["cfg"])
            opt = make_optimizer(OptimizerConfig(**c["opt"]))
            if "mhd" in c:
                step = ST.make_mhd_train_step(bundle, opt,
                                              MHDConfig(**c["mhd"]))
            else:
                step = ST.make_train_step(bundle, opt)
            count = None
            with use_mesh(mesh):
                part = active_partition()
                specs = ST.mesh_specs(bundle, part)
                params = ST.shard_rank(c["params"], specs, part)
                extra = ({"teacher_params": ST.shard_rank(
                    c["teachers"], specs, part, lead=1)}
                    if "mhd" in c else {})
                state = {"params": params, "opt": opt.init(params),
                         "step": 0}
                metrics = []
                for t, batch in enumerate(c["batches"]):
                    batch = {**batch, **extra}
                    if t == 0 and c.get("count"):
                        with OpCounter(args=(state, batch)) as counter:
                            state, m = step(state, batch)
                        count = counter.to_dict()
                    else:
                        state, m = step(state, batch)
                    metrics.append({k: float(v) for k, v in m.items()})
                shapes = ST.train_state_shapes(bundle, opt)["params"]
        finally:
            apply_sharding_strategy("tp")
        out[name] = {"params": state["params"], "metrics": metrics,
                     "coords": tuple(int(mesh.get_local_rank(a))
                                     for a in axes),
                     "specs": specs, "count": count,
                     "meta_shapes": {k: tuple(v.shape)
                                     for k, v in shapes.items()}}
    torch.save(out, f"{out_path}.{rank}")

def vocab_rows_case(rank, world, out_path):
    """`common.sharding.vocab_to_rows` of 7 rows of a 10-wide vocabulary,
    this rank holding its 5 columns, then the backward of Σ rows·cot:
    writes the whole rows, the cotangent, this rank's rows and its
    columns' gradient."""
    import torch

    from repro_torch.common.sharding import use_mesh, vocab_to_rows
    from repro_torch.launch.mesh import make_test_mesh

    mesh = make_test_mesh((world,), ("model",), "cpu")
    g = torch.Generator().manual_seed(0)
    whole = torch.randn(7, 10, generator=g)
    cot = torch.randn(7, 10, generator=g)
    n = 10 // world
    x = whole[:, rank * n:(rank + 1) * n].clone().requires_grad_()
    with use_mesh(mesh):
        rows = vocab_to_rows(x)
    lo = sum(4 if r < 1 else 3 for r in range(rank))
    (rows * cot[lo:lo + rows.shape[0]]).sum().backward()
    torch.save({"whole": whole, "cot": cot, "rows": rows.detach(),
                "grad": x.grad}, f"{out_path}.{rank}")

