"""The dry run on one card: count every (architecture × input shape) step
without a card (port of ``repro/launch/dryrun.py``).

The reference lowers and compiles each step for a 256- or 512-chip TPU
mesh, faked as host devices, and prices the HLO. The port counts the same
step on the ``meta`` device (`roofline.op_cost`): the train state and the
inputs are meta tensors, so nothing is allocated and the step never runs;
the counter sees every operation the card would launch, each hand kernel
as one entry of its own cost. It needs no card and sets no environment.
With no mesh flag the mesh is one card (``"1"``). ``--multi-pod``
counts rank 0 of the reference's 2×16×16 mesh (``"2x16x16"``, 512 chips)
and ``--both-meshes`` the 16×16 (``"16x16"``, 256 chips) and the 2×16×16:
the step runs under a fake process group of that many ranks
(``torch.distributed``'s ``fake`` backend: every collective returns at
once, on meta tensors too) on the production mesh, with rank 0's blocks
of every leaf by the sharding rules and the strategy ``--sharding``
(``"tp"`` | ``"fsdp"``, the reference's), each collective booked by its
kind. ``--step mhd`` counts the paper's pod step (`dryrun_mhd`): rank 0
of the 2×16×16 mesh, two pods, each a client, its teacher exchange
booked as the reference's ``collective-permute``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-12b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out artifacts/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --multi-pod --arch gemma3-12b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --both-meshes --arch mamba2-370m --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --step mhd --exchange topk

Per run: the step counted in the reference's dtype choices (a bf16 bundle;
``sgd_momentum`` with bf16 state for ``train``), its FLOPs by type, bytes,
peak memory and collective bytes, written as a JSON record with the
reference's keys; ``--all`` prints the roofline table on the H100 at the
end.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from typing import Any, Dict, Iterator, Optional

import torch
import torch.distributed as dist

from repro_torch.common.pytree import tree_size
from repro_torch.common.sharding import active_partition, use_mesh
from repro_torch.configs import arch_ids, get_config
from repro_torch.configs.shapes import INPUT_SHAPES, input_specs, supports_shape
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shardings import apply_sharding_strategy
from repro_torch.launch.steps import (
    make_prefill_step,
    make_serve_step,
    make_train_step,
    param_shapes,
    train_state_shapes,
)
from repro_torch.models.layers import MetaDraw
from repro_torch.models.zoo import build_bundle
from repro_torch.optim.optimizers import OptimizerConfig, make_optimizer
from repro_torch.roofline.analysis import (
    format_table,
    roofline_from_artifacts,
)
from repro_torch.roofline.op_cost import OpCounter, tree_bytes

MESH, CHIPS = "1", 1
# the reference's meshes: name -> (chips, multi_pod)
MESHES = {"16x16": (256, False), "2x16x16": (512, True)}
MHD_PODS, MHD_PUBLIC = 2, 16


def _memory_dict(args_bytes: int, out_bytes: int, peak: int
                 ) -> Dict[str, float]:
    """The reference's ``memory_analysis`` keys: the step's arguments,
    outputs, and the peak of the storages it made (its outputs among
    them)."""
    return {"argument_size_in_bytes": float(args_bytes),
            "output_size_in_bytes": float(out_bytes),
            "temp_size_in_bytes": float(peak),
            "alias_size_in_bytes": 0.0,
            "generated_code_size_in_bytes": 0.0}


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool = False,
               mesh: Optional[str] = None,
               overrides: Optional[Dict[str, Any]] = None,
               sharding: str = "tp",
               verbose: bool = True) -> Dict[str, Any]:
    """Count one (arch, shape) step and return the record: on one card
    (``mesh`` None or ``"1"``), or as rank 0 of the reference's
    ``"16x16"`` / ``"2x16x16"`` mesh (``multi_pod=True``: the latter)
    under ``sharding``."""
    mesh_name = "2x16x16" if multi_pod else (mesh or MESH)
    if mesh_name != MESH and mesh_name not in MESHES:
        raise ValueError(f"mesh {mesh_name!r}: one of {[MESH, *MESHES]}")
    chips = MESHES[mesh_name][0] if mesh_name in MESHES else CHIPS
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = INPUT_SHAPES[shape_name]
    skip = supports_shape(arch, cfg, shape)
    record: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "chips": chips,
        "mode": shape.mode, "tokens": shape.global_batch * (
            1 if shape.mode == "decode" else shape.seq_len),
    }
    if mesh_name != MESH:
        record["sharding"] = sharding
    if skip:
        record["status"] = "skip"
        record["skip_reason"] = skip
        if verbose:
            print(f"[SKIP] {arch} × {shape_name} × {mesh_name}: {skip}")
        return record

    bundle = build_bundle(cfg, dtype=torch.bfloat16)
    with _production_mesh(mesh_name, sharding) as mesh, use_mesh(mesh):
        t0 = time.time()
        specs = input_specs(cfg, shape_name)
        if shape.mode == "train":
            opt = make_optimizer(OptimizerConfig(
                name="sgd_momentum", init_lr=0.1, total_steps=60_000,
                state_dtype="bfloat16"))
            state = train_state_shapes(bundle, opt)
            params = state["params"]
            step, args = make_train_step(bundle, opt), (state, specs)
        else:
            params = param_shapes(bundle)
            if shape.mode == "prefill":
                step, args = make_prefill_step(bundle), (params, specs)
            else:
                step, args = make_serve_step(bundle), (params, specs)
        lower_s = time.time() - t0
        args_bytes = tree_bytes((args[0], _rank_rows(args[1])))
        t1 = time.time()
        with OpCounter(args=args) as counter:
            out = step(*args)
        count_s = time.time() - t1
    cost = counter.to_dict()
    record.update({
        "status": "ok",
        # building the meta state and inputs, and the counted run: the
        # port's counterparts of lowering and compiling
        "lower_s": round(lower_s, 2),
        "compile_s": round(count_s, 2),
        "num_params": int(tree_size(
            params if mesh_name == MESH
            else bundle.init(MetaDraw().manual_seed(0)))),
        "memory": _memory_dict(args_bytes, tree_bytes(out),
                               counter.peak_bytes),
        "collective_bytes_raw": {**counter.coll,
                                 "total": cost["collective_total"]},
        "hlo_cost": cost,
        "kernels": counter.kernels,
        "ops": counter.ops,
    })
    if verbose:
        print(f"[OK] {arch} × {shape_name} × {mesh_name} "
              f"(count {count_s:.1f}s, params "
              f"{record['num_params'] / 1e9:.2f}B)")
        print(f"  memory: {record['memory']}")
        print(f"  counted/device: flops={cost['flops']:.3e} "
              f"(f32 {cost['flops_f32']:.3e}, 3xTF32 "
              f"{cost['flops_tf32x3']:.3e}, bf16 {cost['flops_bf16']:.3e}) "
              f"bytes={cost['bytes']:.3e} "
              f"coll={cost['collective_total']:.3e}")
    return record


def _rank_rows(batch):
    """The rows of a global meta batch this rank reads (its token shard,
    where the shards divide it), for the argument bytes."""
    part = active_partition()
    if part is None:
        return batch
    from repro_torch.launch.steps import _forward_rows

    out = {}
    for k, v in batch.items():
        if isinstance(v, dict):
            out[k] = {n: _forward_rows(c, part, int(n.startswith("stage")))
                      for n, c in v.items()}
        else:
            out[k] = _forward_rows(v, part)
    return out


@contextlib.contextmanager
def _production_mesh(mesh_name: str, sharding: str) -> Iterator[Any]:
    """The named production mesh (rank 0 of a fake group of its chips)
    under the strategy, put back to ``"tp"`` after; None for one card."""
    if mesh_name == MESH:
        yield None
        return
    chips, multi_pod = MESHES[mesh_name]
    apply_sharding_strategy(sharding)
    try:
        with fake_group(chips):
            yield make_production_mesh(multi_pod=multi_pod,
                                       device_type="cpu")
    finally:
        apply_sharding_strategy("tp")


@contextlib.contextmanager
def fake_group(world: int) -> Iterator[None]:
    """A ``fake`` process group of ``world`` ranks with this process as
    rank 0, torn down after."""
    # registers the fake backend's process-group creator
    import torch.testing._internal.distributed.fake_pg  # noqa: F401

    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def dryrun_mhd(arch: str, shape_name: str = "train_4k", *,
               exchange: str = "full", topk: int = 32,
               overrides: Optional[Dict[str, Any]] = None,
               sharding: str = "tp",
               verbose: bool = True) -> Dict[str, Any]:
    """Count the PAPER-TECHNIQUE step: 2 MHD clients on the 2-pod mesh,
    teacher predictions exchanged between the pods
    (`core.mhd_distributed`), as rank 0 of the 2×16×16 mesh sees it under
    a fake group of 512 ranks, each client's leaves cut over its pod's
    16×16 by the rules. exchange="full" ships full-vocab logits; "topk"
    the sparsified wire format. The reference's defaults: a bf16 bundle,
    sgd_momentum with bf16 state, B = global batch / K private and 16
    public sequences a step."""
    from repro_torch.core.mhd import MHDConfig
    from repro_torch.core.mhd_distributed import (DistributedMHDConfig,
                                                  local_params,
                                                  make_distributed_mhd_step)

    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = INPUT_SHAPES[shape_name]
    K = MHD_PODS
    bundle = build_bundle(cfg, dtype=torch.bfloat16)
    mhd = MHDConfig(nu_emb=1.0, nu_aux=3.0,
                    num_aux_heads=cfg.num_aux_heads, delta=1)
    dcfg = DistributedMHDConfig(num_clients=K, exchange=exchange, topk=topk)
    opt = make_optimizer(OptimizerConfig(
        name="sgd_momentum", init_lr=0.1, total_steps=60_000,
        state_dtype="bfloat16"))
    record: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": "2x16x16-mhd",
        "chips": MESHES["2x16x16"][0], "mode": "mhd_train",
        "exchange": exchange, "topk": topk, "sharding": sharding,
        "tokens": shape.global_batch * shape.seq_len,
    }
    t0 = time.time()
    B, T = shape.global_batch // K, shape.seq_len
    params = bundle.init(MetaDraw().manual_seed(0))
    batch = {"private_tokens": torch.empty((K, B, T), dtype=torch.int32,
                                           device="meta"),
             "public_tokens": torch.empty((MHD_PUBLIC, T), dtype=torch.int32,
                                          device="meta")}
    with _production_mesh("2x16x16", sharding) as mesh:
        stacked = {k: v.unsqueeze(0).expand(K, *v.shape)
                   for k, v in params.items()}
        local = local_params(stacked, bundle, K, mesh)
        state = {"params": local, "opt": opt.init(local), "step": 0}
        step = make_distributed_mhd_step(bundle, opt, mhd, dcfg, mesh)
        args = (state, batch)
        lower_s = time.time() - t0
        args_bytes = tree_bytes(args)
        t1 = time.time()
        with OpCounter(args=args) as counter:
            out = step(*args)
        count_s = time.time() - t1
    cost = counter.to_dict()
    record.update({
        "status": "ok",
        "lower_s": round(lower_s, 2),
        "compile_s": round(count_s, 2),
        "num_params": int(tree_size(params) * K),
        "memory": _memory_dict(args_bytes, tree_bytes(out),
                               counter.peak_bytes),
        "collective_bytes_raw": {**counter.coll,
                                 "total": cost["collective_total"]},
        "hlo_cost": cost,
        "kernels": counter.kernels,
        "ops": counter.ops,
    })
    if verbose:
        print(f"[OK] MHD({exchange}) {arch} × {shape_name} × 2x16x16 "
              f"(count {count_s:.1f}s)")
        print(f"  memory: {record['memory']}")
        print(f"  counted/device: flops={cost['flops']:.3e} "
              f"bytes={cost['bytes']:.3e} "
              f"coll={cost['collective_total']:.3e} "
              f"({record['collective_bytes_raw']})")
    return record


def report(rec: Dict[str, Any]):
    """The record's `RooflineReport` on the default card (the H100)."""
    cfg = get_config(rec["arch"])
    cost = {**rec["hlo_cost"], "bytes accessed": rec["hlo_cost"]["bytes"]}
    return roofline_from_artifacts(
        rec["arch"], rec["shape"], rec["mesh"], rec["chips"], cost,
        rec["collective_bytes_raw"], rec["memory"], cfg, rec["num_params"],
        rec["tokens"], rec["mode"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    p.add_argument("--all", action="store_true",
                   help="run every (arch, shape)")
    p.add_argument("--multi-pod", action="store_true",
                   help="count rank 0 of the 2x16x16 mesh")
    p.add_argument("--both-meshes", action="store_true",
                   help="count rank 0 of the 16x16 and the 2x16x16 mesh")
    p.add_argument("--sharding", default="tp", choices=["tp", "fsdp"])
    p.add_argument("--out", default="artifacts/dryrun_torch")
    p.add_argument("--step", default="auto", choices=["auto", "mhd"],
                   help="'mhd' counts the 2-client pod-exchange step on "
                        "the 2x16x16 mesh (--arch defaults to gemma3-12b, "
                        "--shape to train_4k)")
    p.add_argument("--exchange", default="full", choices=["full", "topk"])
    args = p.parse_args(argv)
    if args.step == "mhd":
        os.makedirs(args.out, exist_ok=True)
        arch = args.arch or "gemma3-12b"
        shape_name = args.shape or "train_4k"
        tag = f"mhd_{args.exchange}__{arch}__{shape_name}".replace("/", "_")
        rec = dryrun_mhd(arch, shape_name, exchange=args.exchange,
                         sharding=args.sharding)
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=2)
        return 0

    os.makedirs(args.out, exist_ok=True)
    archs = arch_ids() if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = (list(MESHES) if args.both_meshes else
              ["2x16x16"] if args.multi_pod else [MESH])
    failures, reports = 0, []
    for mesh_name in meshes:
        for arch in archs:
            for shape_name in shapes:
                tag = f"{arch}__{shape_name}__{mesh_name}".replace("/", "_")
                try:
                    rec = dryrun_one(arch, shape_name, mesh=mesh_name,
                                     sharding=args.sharding)
                except Exception as e:  # a dry-run failure is a port bug
                    failures += 1
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "status": "fail",
                           "error": f"{type(e).__name__}: {e}"}
                    print(f"[FAIL] {arch} × {shape_name} × {mesh_name}: "
                          f"{rec['error']}")
                if rec["status"] == "ok":
                    reports.append(report(rec))
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=2)
    if reports:
        print(format_table(reports))
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
