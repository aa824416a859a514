"""Tensor and FSDP sharding within a pod (`repro_torch.common.sharding`'s
partition, `launch.shardings.partition_specs` / `shard_params`, the model
code's blocks, `launch.steps` under an active mesh) against the JAX
package's sharded step and the port's unsharded one, on the CPU.

  * `make_train_step` under `use_mesh` on (data, model) meshes of 1×2,
    2×1 and 2×2 across spawned gloo ranks (`torch_ranks.tp_steps`), under
    the ``"tp"`` and ``"fsdp"`` strategies, 2 SGD-momentum steps from the
    port's draw on the same global batches, for reduced qwen2.5-32b (the
    reference's own sharded case, tests/test_shardings.py), gemma3-12b,
    mamba2-370m, zamba2-7b, arctic-480b and deepseek-v3 on the
    expert-parallel MoE (``moe_impl="a2a"``), whisper-large-v3 and
    llama-3.2-vision-90b. Every rank's metrics and the params put back
    together from the ranks' blocks are held, the metrics within 1e-4
    relative and the params within 1e-5 absolute (the pod step's
    tolerances, tests/test_torch_mhd_distributed.py):
      - against the port's unsharded step, except the a2a families on a
        'model' axis, whose per-rank capacity and aux differ from one
        device's by design (as the reference's do);
      - against the reference's jitted step with its params, optimizer
        state and batch sharded by its rules (three subprocesses, 8
        forced host devices each, the reference's a2a boundary rounding
        to bf16 in the input's dtype as tests/test_torch_moe_a2a.py
        explains): for the a2a families on a 'model' axis its run on the
        same mesh and strategy; for every other family, whose sharded
        function is the unsharded one, its 2×2 run under "tp" (and under
        "fsdp" for qwen2.5-32b, the reference's own case); at 2×1 the
        reference's a2a takes its scatter form, the unsharded function,
        which tests/test_torch_lm.py and test_torch_mla.py hold against
        the reference;
  * a batch that the token shards do not divide: reduced qwen2.5-32b with
    3 sequences a step on the 2×2 mesh under ``"fsdp"`` (4 token shards),
    which every rank computes whole, as the reference's batch sharding
    replicates it; held against the port's unsharded step and the
    reference's run of the same case; and reduced arctic-480b on the
    expert-parallel MoE at 3 sequences, whose a2a region takes each
    rank's block of the 48 flattened tokens itself (the reference's
    ``shard_map`` split), against the reference's run of the same case;
  * clipping by the global norm (SGD-momentum with ``grad_clip_norm`` 4,
    which binds: the reference's norm exceeds it at every step) for
    reduced qwen2.5-32b and arctic-480b on the a2a MoE, on 2×2 under both
    strategies: each rank's blocks clipped by the whole gradient's norm,
    against the reference's run of the same case (and qwen2.5-32b's
    against the port's unsharded step);
  * each rank holds exactly its blocks: every leaf's shape is the block
    shape of its `param_pspec` spec on the mesh, on the state and on
    `train_state_shapes`' meta state;
  * `make_mhd_train_step` under `use_mesh` (reduced minitron-4b, one
    student and Δ = 2 teachers, their blocks cut alike) on 1×2 under both
    strategies and 2×1, 2 steps, against the port's unsharded step at the
    same tolerances: under ``"tp"`` each model rank scores its block of
    the rows and Eq. 1 is the sum of the blocks' parts;
  * a sharded step counts alike on the CPU over gloo and on meta under a
    fake group (`roofline.op_cost`, as tests/test_torch_roofline.py holds
    the one-card steps):
    reduced qwen2.5-32b at (1, 2) under "tp", rank 0's FLOPs by type,
    bytes and collective bytes by kind;
  * the primitives on two ranks: `vocab_to_rows` with a row count the
    ranks do not divide, forward and backward against the whole rows.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import test_torch_threads
import torch_ranks
from repro_torch.configs import get_reduced
from repro_torch.launch import steps as TSTEPS
from repro_torch.launch.shardings import (block_shape, param_pspec,
                                          unshard_leaf)
from repro_torch.models import build_bundle
from repro_torch.optim import OptimizerConfig, make_optimizer

test_torch_threads.share_cores()

for _op in (torch.exp, torch.log, torch.sqrt, torch.tanh):
    _op(torch.ones(1))

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RTOL_METRICS, ATOL_PARAMS = 1e-4, 1e-5
STEPS, B, T, T_AUDIO = 2, 4, 16, 24
# family entries that run qwen2.5-32b and arctic-480b (the a2a MoE) on a
# batch of 3 rows, which the 4 token shards of 2x2 under "fsdp" do not
# divide
UNEVEN, UNEVEN_A2A, UNEVEN_B = "qwen2.5-32b@b3", "arctic-480b@b3", 3
# family entries whose optimizer clips by the global norm, at a norm
# their gradients exceed
CLIP, CLIP_NORM = ("qwen2.5-32b@clip", "arctic-480b@clip"), 4.0


def arch(family: str) -> str:
    return family.split("@")[0]


OPT = dict(name="sgd_momentum", init_lr=0.01, total_steps=10)
OPT_CLIP = dict(OPT, grad_clip_norm=CLIP_NORM)


def family_opt(family: str) -> dict:
    return OPT_CLIP if family in CLIP else OPT


def family_rows(family: str) -> int:
    return UNEVEN_B if family.endswith("@b3") else B
AXES = ("data", "model")
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2)}
STRATEGIES = ["tp", "fsdp"]
# family -> the moe_impl it runs with (None: its reduced config's)
FAMILIES = {"qwen2.5-32b": None, "gemma3-12b": None, "mamba2-370m": None,
            "zamba2-7b": None, "arctic-480b": "a2a",
            "deepseek-v3-671b": "a2a", "whisper-large-v3": None,
            "llama-3.2-vision-90b": None, UNEVEN: None, UNEVEN_A2A: "a2a",
            CLIP[0]: None, CLIP[1]: "a2a"}
A2A = {f for f in FAMILIES if FAMILIES[f] == "a2a" or
       get_reduced(arch(f)).moe_impl == "a2a"}
CASES = [(f, m, s) for f in FAMILIES if "@" not in f for m in MESHES
         for s in STRATEGIES] + [(UNEVEN, "2x2", "fsdp"),
                                 (UNEVEN_A2A, "2x2", "fsdp")] + [
    (f, "2x2", s) for f in CLIP for s in STRATEGIES]


def case_name(family: str, mesh: str, strategy: str) -> str:
    return f"{family}-{mesh}-{strategy}"


def reduced(family: str):
    cfg = get_reduced(arch(family))
    if FAMILIES[family]:
        cfg = dataclasses.replace(cfg, moe_impl=FAMILIES[family])
    return cfg


def family_batches(cfg, seed: int = 3, rows: int = B) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        b = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (rows, T)).astype(np.int32))}
        if cfg.vision is not None:
            b["vision_embeds"] = torch.from_numpy(rng.standard_normal(
                (rows, cfg.vision.num_patches, cfg.vision.embed_dim))
                .astype(np.float32))
        if cfg.audio is not None:
            b["audio_frames"] = torch.from_numpy(rng.standard_normal(
                (rows, T_AUDIO, cfg.audio.frame_dim)).astype(np.float32))
        out.append(b)
    return out


def on_model_axis(family: str, mesh: str) -> bool:
    """The a2a MoE on a 'model' axis: per-rank capacity and aux."""
    return family in A2A and MESHES[mesh][1] > 1


def reference_run(family: str, mesh: str, strategy: str):
    """The reference's sharded run a case is held against: its own on the
    same mesh and strategy for the a2a families on a 'model' axis; for
    every other family the 2×2 run under "tp" (both strategies' sharded
    function is the unsharded one; qwen2.5-32b, the reference's own
    case, also runs under "fsdp"); None for the a2a at model 1 (its
    scatter form, the unsharded function). The uneven batches' and the
    clipping cases are held against their own runs."""
    if on_model_axis(family, mesh) or "@" in family:
        return case_name(family, mesh, strategy)
    if family in A2A:
        return None
    if family == "qwen2.5-32b":
        return case_name(family, "2x2", strategy)
    return case_name(family, "2x2", "tp")


REFERENCE_PROCESSES = 3


MHD_MESHES = [("1x2", "tp"), ("1x2", "fsdp"), ("2x1", "tp")]
# the case whose first step rank 0 also counts on the CPU
COUNTED = ("qwen2.5-32b", "1x2", "tp")
MHD = dict(nu_emb=1.0, nu_aux=3.0, num_aux_heads=2, delta=2)
B_PUB = 2


def mhd_case(seed: int = 5) -> dict:
    cfg = get_reduced("minitron-4b")
    bundle = build_bundle(cfg)
    draws = [bundle.init(torch.Generator().manual_seed(seed + i))
             for i in range(3)]
    rng = np.random.default_rng(seed)
    batches = [{"private_tokens": torch.from_numpy(rng.integers(
                    0, cfg.vocab_size, (B, T)).astype(np.int32)),
                "public_tokens": torch.from_numpy(rng.integers(
                    0, cfg.vocab_size, (B_PUB, T)).astype(np.int32))}
               for _ in range(STEPS)]
    return {"cfg": cfg, "opt": OPT, "mhd": MHD, "params": draws[0],
            "teachers": {k: torch.stack([d[k] for d in draws[1:]])
                         for k in draws[0]},
            "batches": batches}



@pytest.fixture(scope="module")
def inputs():
    out = {}
    for f in FAMILIES:
        cfg = reduced(f)
        params = build_bundle(cfg).init(torch.Generator().manual_seed(0))
        out[f] = {"cfg": cfg, "params": params, "batches": family_batches(
            cfg, rows=family_rows(f))}
    return out


REFERENCE = textwrap.dedent("""
    import os, sys, json, dataclasses
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               "--xla_cpu_multi_thread_eigen=false "
                               "--xla_backend_optimization_level=0 "
                               "--xla_llvm_disable_expensive_passes=true")
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.checkpoint.io import flatten_with_paths
    from repro.common.sharding import set_logical_rule
    from repro.configs import get_reduced
    from repro.launch import shardings as SH
    from repro.launch.steps import make_train_step
    from repro.models import moe_a2a as A
    from repro.models.zoo import build_bundle
    from repro.optim.optimizers import (Optimizer, OptimizerConfig,
                                        _global_norm, make_optimizer)

    # the a2a's boundary rounding the cotangent to bf16 in its own dtype
    # (as written it returns bf16, which an f32 backward refuses;
    # tests/test_torch_moe_a2a.py)
    @jax.custom_vjp
    def rounded(x):
        return x

    rounded.defvjp(lambda x: (x, None),
                   lambda _, g: (g.astype(jnp.bfloat16).astype(g.dtype),))
    A._bf16_grad_boundary = rounded

    def apply_strategy(s):
        # repro.launch.dryrun's _apply_sharding_strategy (the module sets
        # XLA_FLAGS for 512 devices when imported)
        batch = ("pod", "data", "model") if s == "fsdp" else ("pod", "data")
        set_logical_rule("batch", batch)
        set_logical_rule("model", None if s == "fsdp" else "model")
        set_logical_rule("expert", "model")
        SH.DEFAULT_ROLES["batch"] = batch
        SH.DEFAULT_ROLES["tp"] = ("model",) if s == "fsdp" else "model"

    def nested(flat):
        out = {}
        for k, v in flat.items():
            *parents, leaf = k.split("/")
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = v
        return out

    cases = json.loads(open(sys.argv[1]).read())
    inp = np.load(sys.argv[2])
    out = {}
    for c in cases:
        apply_strategy(c["sharding"])
        f = c["family"]
        cfg = get_reduced(f.split("@")[0])
        if c["moe_impl"]:
            cfg = dataclasses.replace(cfg, moe_impl=c["moe_impl"])
        bundle = build_bundle(cfg)
        opt = make_optimizer(OptimizerConfig(**c["opt"]))
        clip = c["opt"].get("grad_clip_norm")
        if clip:
            # the optimizer's state also keeps the norm of the gradient
            # it was given, the whole sharded tree's
            base = opt
            opt = Optimizer(
                init=lambda p: {**base.init(p),
                                "norm": jnp.zeros((), jnp.float32)},
                update=lambda g, s, p, t: (lambda r: (r[0], {
                    **r[1], "norm": _global_norm(g)}))(base.update(
                        g, {"momentum": s["momentum"]}, p, t)))
        params = nested({k[len(f) + 3:]: inp[k] for k in inp.files
                         if k.startswith(f"{f}/p/")})
        state = {"params": params, "opt": jax.tree.map(
            np.asarray, opt.init(params)), "step": np.zeros((), np.int32)}
        shape = tuple(c["mesh"])
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2,
                             devices=jax.devices()[:shape[0] * shape[1]])
        with jax.set_mesh(mesh):
            ps = SH.params_shardings(params, mesh)
            spec = {"params": ps, "opt": {"momentum": ps}, "step": P()}
            if clip:
                spec["opt"]["norm"] = P()
            batches = [{k[len(f"{f}/b{t}/"):]: inp[k]
                        for k in inp.files
                        if k.startswith(f"{f}/b{t}/")}
                       for t in range(c["steps"])]
            step = jax.jit(make_train_step(bundle, opt),
                           in_shardings=(spec, SH.batch_shardings(
                               batches[0], mesh)),
                           out_shardings=(spec, None))
            for t, b in enumerate(batches):
                state, m = step(state, b)
                for k, v in m.items():
                    out[f"{c['name']}/m{t}/{k}"] = np.asarray(v)
                if clip:
                    out[f"{c['name']}/n{t}"] = np.asarray(
                        state["opt"]["norm"])
        for k, v in flatten_with_paths(state["params"]).items():
            out[f"{c['name']}/p/{k}"] = np.asarray(v)
    np.savez(sys.argv[3], **out)
""")


@pytest.fixture(scope="module")
def ranked(inputs, tmp_path_factory):
    """The port's sharded runs (one gloo group a world size) and the
    reference's (one subprocess a strategy), all started before the
    port's unsharded runs, which go on meanwhile."""
    tmp = tmp_path_factory.mktemp("tp")
    arrays = {}
    for f, inp in inputs.items():
        arrays.update({f"{f}/p/{k}": v.numpy()
                       for k, v in inp["params"].items()})
        for t, b in enumerate(inp["batches"]):
            arrays.update({f"{f}/b{t}/{k}": v.numpy()
                           for k, v in b.items()})
    np.savez(str(tmp / "ref_in.npz"), **arrays)
    (tmp / "ref.py").write_text(REFERENCE)
    runs = {"reference": {}}
    todo = sorted({reference_run(f, m, s) for f, m, s in CASES} - {None})
    # the a2a families' compiles are the slowest: spread them first
    todo.sort(key=lambda n: n.split("-1x2")[0].split("-2x2")[0] not in A2A)
    for i in range(REFERENCE_PROCESSES):
        cases = [{"name": n, "family": f, "moe_impl": FAMILIES[f],
                  "mesh": list(MESHES[m]), "sharding": s,
                  "opt": family_opt(f), "steps": STEPS}
                 for n in todo[i::REFERENCE_PROCESSES]
                 for f, m, s in CASES if case_name(f, m, s) == n]
        (tmp / f"ref_{i}.json").write_text(json.dumps(cases))
        runs["reference"][i] = subprocess.Popen(
            [sys.executable, str(tmp / "ref.py"), str(tmp / f"ref_{i}.json"),
             str(tmp / "ref_in.npz"), str(tmp / f"ref_{i}.npz")],
            env=dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for world in (2, 4):
        todo = {}
        for f, m, s in CASES:
            if int(np.prod(MESHES[m])) == world:
                todo[case_name(f, m, s)] = {
                    "cfg": inputs[f]["cfg"], "params": inputs[f]["params"],
                    "batches": inputs[f]["batches"], "opt": family_opt(f),
                    "mesh": (MESHES[m], AXES), "sharding": s,
                    "count": (f, m, s) == COUNTED}
        if world == 2:
            todo.update({f"mhd-{m}-{s}": {**mhd_case(),
                                          "mesh": (MESHES[m], AXES),
                                          "sharding": s}
                         for m, s in MHD_MESHES})
        torch.save(todo, str(tmp / f"in{world}.pt"))
        runs[world] = torch_ranks.start_ranks(
            torch_ranks.tp_steps, world, str(tmp), str(tmp / f"in{world}.pt"),
            str(tmp / f"out{world}"))
    c = mhd_case()
    torch.save({f"{m}-{s}": {**c, "mesh": (MESHES[m], AXES), "sharding": s}
                for m, s in MHD_MESHES}, str(tmp / "mhd_in.pt"))
    return runs, tmp


@pytest.fixture(scope="module")
def unsharded(inputs, ranked):
    """The port's unsharded step over each family's batches: (metrics a
    step, the params after)."""
    out = {}
    for f, inp in inputs.items():
        bundle = build_bundle(inp["cfg"])
        opt = make_optimizer(OptimizerConfig(**family_opt(f)))
        params = {k: v.clone() for k, v in inp["params"].items()}
        state = {"params": params, "opt": opt.init(params), "step": 0}
        step = TSTEPS.make_train_step(bundle, opt)
        metrics = []
        for b in inp["batches"]:
            state, m = step(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
        out[f] = metrics, state["params"]
    return out


@pytest.fixture(scope="module")
def done(ranked):
    """{"reference": {name: (metrics, params)}, "norms": {name: the
    reference's gradient norm a step, for the clipping cases}, world:
    {rank: {name: result}}} once every process has ended."""
    runs, tmp = ranked
    out = {"reference": {}, "norms": {}}
    for s, proc in runs["reference"].items():
        try:
            _, err = proc.communicate(timeout=torch_ranks.TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise
        assert proc.returncode == 0, err[-3000:]
        with np.load(str(tmp / f"ref_{s}.npz")) as f:
            ref = {k: f[k] for k in f.files}
        names = {k.split("/", 1)[0] for k in ref}
        for name in names:
            metrics = [{k.rsplit("/", 1)[1]: float(v) for k, v in
                        ref.items() if k.startswith(f"{name}/m{t}/")}
                       for t in range(STEPS)]
            params = {k[len(name) + 3:]: v for k, v in ref.items()
                      if k.startswith(f"{name}/p/")}
            out["reference"][name] = metrics, params
            if f"{name}/n0" in ref:
                out["norms"][name] = [float(ref[f"{name}/n{t}"])
                                      for t in range(STEPS)]
    for world in (2, 4):
        torch_ranks.wait_ranks(runs[world])
        out[world] = {r: torch.load(str(tmp / f"out{world}.{r}"),
                                    weights_only=False)
                      for r in range(world)}
    return out


def assembled(ranks: dict, name: str, mesh: str):
    """The whole params from the ranks' blocks (ranks that hold the same
    block must agree bitwise) and the metrics every rank reported (which
    must agree)."""
    sizes = dict(zip(AXES, MESHES[mesh]))
    first = ranks[0][name]
    for r, res in ranks.items():
        assert res[name]["metrics"] == first["metrics"], (name, r)
    params = {}
    for k in first["params"]:
        blocks = {}
        for res in ranks.values():
            res = res[name]
            spec = res["specs"].get(k, ())
            used = [AXES.index(a) for e in spec if e is not None
                    for a in ((e,) if isinstance(e, str) else e)]
            key = tuple(res["coords"][i] if i in used else 0
                        for i in range(len(AXES)))
            if key in blocks:
                assert torch.equal(blocks[key], res["params"][k]), (name, k)
            blocks[key] = res["params"][k]
        spec = first["specs"].get(k, ())
        params[k] = unshard_leaf(blocks, spec, sizes, AXES) if spec \
            else blocks[(0, 0)]
    return first["metrics"], params


def hold(metrics, params, ref, what: str) -> None:
    ref_metrics, ref_params = ref
    assert len(metrics) == len(ref_metrics) == STEPS
    for t, (m, r) in enumerate(zip(metrics, ref_metrics)):
        assert set(m) == set(r), (what, t)
        for k in r:
            np.testing.assert_allclose(m[k], r[k], rtol=RTOL_METRICS,
                                       err_msg=f"{what} step {t} {k}")
    assert set(params) == set(ref_params), what
    for k, v in params.items():
        want = ref_params[k]
        want = want.numpy() if isinstance(want, torch.Tensor) else want
        np.testing.assert_allclose(v.numpy(), want, rtol=0,
                                   atol=ATOL_PARAMS, err_msg=f"{what} {k}")


@pytest.mark.parametrize("family,mesh,strategy", CASES)
def test_sharded_train_step_matches(family, mesh, strategy, inputs,
                                    unsharded, done):
    name = case_name(family, mesh, strategy)
    world = int(np.prod(MESHES[mesh]))
    metrics, params = assembled(done[world], name, mesh)
    if not on_model_axis(family, mesh):
        hold(metrics, params, unsharded[family], f"{name} vs unsharded")
    ref = reference_run(family, mesh, strategy)
    if ref is not None:
        hold(metrics, params, done["reference"][ref],
             f"{name} vs the reference's {ref}")
    if family in CLIP:  # the clip binds at every step
        assert min(done["norms"][ref]) > CLIP_NORM, done["norms"][ref]
    moved = [k for k in params
             if not torch.equal(params[k], inputs[family]["params"][k])]
    assert moved, name


@pytest.mark.parametrize("world", [2, 4])
def test_each_rank_holds_its_param_pspec_block(world, done):
    """Every leaf of every rank's state, and of `train_state_shapes`' meta
    state under the same mesh, is the block its spec gives on the mesh;
    the rules cut some leaf along each axis of size above 1."""
    for r, res in done[world].items():
        for name, c in res.items():
            if name.startswith("mhd-"):
                continue
            mesh = name.rsplit("-", 2)[1]
            sizes = dict(zip(AXES, MESHES[mesh]))
            family = name.rsplit("-", 2)[0]
            whole = build_bundle(reduced(family)).init(
                torch.Generator().manual_seed(0))
            cut = set()
            for k, v in whole.items():
                spec = param_pspec(k, tuple(v.shape), sizes)
                assert c["specs"].get(k, ()) == (
                    spec if any(e is not None for e in spec) else ())
                want = block_shape(v.shape, spec, sizes)
                assert tuple(c["params"][k].shape) == want, (name, r, k)
                assert c["meta_shapes"][k] == want, (name, r, k)
                cut.update(e for e in spec if isinstance(e, str))
            assert cut == {a for a, n in sizes.items() if n > 1}, name


def test_vocab_to_rows_splits_uneven_rows(tmp_path):
    handle = torch_ranks.start_ranks(torch_ranks.vocab_rows_case, 2,
                                     str(tmp_path), str(tmp_path / "out"))
    torch_ranks.wait_ranks(handle)
    res = [torch.load(str(tmp_path / f"out.{r}"), weights_only=False)
           for r in range(2)]
    x = res[0]["whole"]
    # rank 0 takes the first ceil(7/2) = 4 rows, rank 1 the other 3
    assert [r["rows"].shape[0] for r in res] == [4, 3]
    assert torch.equal(torch.cat([r["rows"] for r in res]), x)
    cot = res[0]["cot"]
    for r, out in enumerate(res):
        # the gradient of Σ rows·cot over this rank's vocabulary block
        block = slice(r * 5, (r + 1) * 5)
        assert torch.equal(out["grad"], cot[:, block])


def test_sharded_mhd_train_step_matches_unsharded(done):
    from repro_torch.core.mhd import MHDConfig

    c = mhd_case()
    bundle = build_bundle(c["cfg"])
    opt = make_optimizer(OptimizerConfig(**OPT))
    step = TSTEPS.make_mhd_train_step(bundle, opt, MHDConfig(**MHD))
    params = {k: v.clone() for k, v in c["params"].items()}
    state = {"params": params, "opt": opt.init(params), "step": 0}
    metrics = []
    for b in c["batches"]:
        state, m = step(state, {**b, "teacher_params": c["teachers"]})
        metrics.append({k: float(v) for k, v in m.items()})
    for mesh, strategy in MHD_MESHES:
        name = f"mhd-{mesh}-{strategy}"
        got_metrics, got = assembled(done[2], name, mesh)
        hold(got_metrics, got, (metrics, state["params"]), name)


def test_a_sharded_step_counts_the_same_on_the_cpu_and_on_meta(inputs,
                                                               done):
    from repro_torch.common.sharding import use_mesh
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.roofline.op_cost import OpCounter

    family, mesh_name, _ = COUNTED
    case = inputs[family]
    bundle = build_bundle(case["cfg"])
    opt = make_optimizer(OptimizerConfig(**OPT))
    batch = {k: v.to("meta") for k, v in case["batches"][0].items()}
    with fake_group(2):
        mesh = make_test_mesh(MESHES[mesh_name], AXES, "cpu")
        with use_mesh(mesh):
            state = TSTEPS.train_state_shapes(bundle, opt)
            with OpCounter(args=(state, batch)) as counter:
                TSTEPS.make_train_step(bundle, opt)(state, batch)
    meta = counter.to_dict()
    assert meta == done[2][0][case_name(*COUNTED)]["count"]
    assert meta["collective_all-reduce"] > 0
