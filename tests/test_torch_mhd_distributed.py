"""The pod runtime (`repro_torch.core.mhd_distributed`), its wire helpers
(`repro_torch.comm.wire`) and `launch.steps.make_mhd_train_step` against
the JAX package's, on the CPU.

  * the four in-graph wire helpers against ``repro.comm.wire``'s: ``idx``
    and ``vals`` exact, ``lse`` within 2 ulp, the CEs within 1e-5
    relative;
  * `_teacher_sources`' errors, the reference's messages;
  * `make_distributed_mhd_step` on reduced minitron-4b and mamba2-370m
    (2 aux heads), both exchanges, 2 steps against the reference's
    jitted step from the same stacked params and batches: the loss and
    metrics within 1e-4 relative, the params within 1e-5 absolute, at
    world size 1 (no process group), 2 (pod 2) and 4 (pod 2 × data 2),
    the last two across spawned gloo processes (`torch_ranks`, one
    group a world size, made once for the module);
  * a non-ring adjacency (the reference's gather form), K = 4, at world
    size 1 and across 2 pods of two clients each (local and remote
    moves);
  * reduced minitron-4b, top-k exchange, on a (pod 2, model 2) mesh
    under the ``"tp"`` strategy (each pod's leaves cut over 'model', its
    attention and MLP tensor-parallel, each model rank scoring its block
    of the public rows) and under ``"fsdp"`` (the model ranks splitting
    the tokens, the leaves gathered where used), against the reference's
    jitted step, every rank's blocks put back together by their specs;
  * reduced arctic-480b on the expert-parallel MoE (``moe_impl="a2a"``),
    both clients in one pod whose two ranks split the tokens over
    'model', against the reference's step on the same (pod 1, model 2)
    mesh (a forced two-device subprocess; the reference's a2a boundary
    replaced by one that rounds to bf16 in the input's dtype, as
    tests/test_torch_moe_a2a.py explains), its expert shards put back
    together by their specs;
  * what the pod step once refused, against the reference's jitted step
    on the same case: a private and a public batch of 3 rows on (pod 2,
    data 2), which each pod's 2 token shards do not divide (every rank of
    the pod computes them whole), and on (pod 1, data 2, model 2) under
    ``"tp"``, where each model rank scores its block of the 45 public
    positions' whole rows (23 and 22); ``max_public_positions`` with 2
    token shards a pod, on (pod 2, data 2) at 10 of the 30 public
    positions (the second shard keeps none, and scores, packs and
    exchanges nothing), on (pod 2, model 2) under ``"fsdp"`` at 20 (the
    shards keep 15 and 5) and on (pod 1, data 2, model 2) under ``"tp"``
    at 20 (each shard's kept rows split over 'model');
  * clipping by the global norm (SGD-momentum with ``grad_clip_norm`` 4,
    which binds: the reference's norm of the stacked fleet's gradient
    exceeds it at every step) on (pod 2) and on (pod 2, model 2) under
    ``"tp"``: each rank clips its clients' blocks by the fleet's norm;
  * `make_mhd_train_step` against the reference's.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_threads
import torch_ranks
from repro.checkpoint import io as JIO
from repro.comm import wire as JW
from repro.configs import get_reduced as jax_reduced
from repro.core import mhd_distributed as JMD
from repro.core.mhd import MHDConfig as JMHDConfig
from repro.launch import steps as JSTEPS
from repro.models.zoo import build_bundle as jax_bundle
from repro.optim.optimizers import OptimizerConfig as JOptimizerConfig
from repro.optim.optimizers import make_optimizer as jax_optimizer
from repro_torch.comm import wire as TW
from repro_torch.configs import get_reduced
from repro_torch.core import mhd_distributed as MD
from repro_torch.core.mhd import MHDConfig
from repro_torch.launch import steps as TSTEPS
from repro_torch.launch.shardings import unshard_leaf
from repro_torch.models import build_bundle
from repro_torch.optim import OptimizerConfig, make_optimizer
from test_torch_xattn import nested

test_torch_threads.share_cores()

for _op in (torch.exp, torch.log, torch.sqrt, torch.tanh):
    _op(torch.ones(1))

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RTOL_METRICS, ATOL_PARAMS = 1e-4, 1e-5
ARCHS = ["mamba2-370m", "minitron-4b"]
EXCHANGES = ["full", "topk"]
STEPS, K, B, B_PUB, T, TOPK = 2, 2, 2, 2, 16, 8
OPT = dict(name="sgd_momentum", init_lr=0.01, total_steps=10)
CLIP_NORM = 4.0
MHD = dict(nu_emb=1.0, nu_aux=3.0, num_aux_heads=2, delta=1)
# world size -> (mesh shape, axes) of the multi-process runs
MESHES = {2: ((2,), ("pod",)), 4: ((2, 2), ("pod", "data"))}
# arctic-480b on the expert-parallel MoE, both clients in one pod whose
# two ranks split the tokens over 'model' (the reference: a forced
# two-device mesh in a subprocess)
A2A, A2A_MESH = "arctic-a2a", ((1, 2), ("pod", "model"))
# tensor and FSDP sharding within each of two pods: the pod step on a
# (pod 2, model 2) mesh under each strategy
POD_MODEL = {f"minitron-4b-topk-pod-model-{s}": s for s in ("tp", "fsdp")}
POD_MODEL_MESH = {4: ((2, 2), ("pod", "model"))}
# not a ring: client 0 teaches 1 (its own pod at two pods) and 2 (the
# other pod); 3 learns from 2 in its pod, 0 from 3 across
GATHER = ((3,), (0,), (0,), (2,))
# the cases the pod step once refused, and the clipping cases: name ->
# (case() arguments, meshes, strategy); B_PUB · (T - 1) = 30 public
# positions, 15 a token shard's block at 2 shards a pod
POD_DATA = {4: ((2, 2), ("pod", "data"))}
# one pod whose 2 data shards each split their rows' vocabulary over 2
# model ranks under "tp"
DATA_MODEL = {4: ((1, 2, 2), ("pod", "data", "model"))}
REFUSED = {
    "uneven": (dict(rows=3, pub_rows=3), POD_DATA, "tp"),
    "uneven-tp": (dict(rows=3, pub_rows=3), DATA_MODEL, "tp"),
    "capped": (dict(max_pub=10), POD_DATA, "tp"),
    "capped-fsdp": (dict(max_pub=20), POD_MODEL_MESH, "fsdp"),
    "capped-tp": (dict(max_pub=20), DATA_MODEL, "tp"),
    "clip": (dict(opt=dict(OPT, grad_clip_norm=CLIP_NORM)),
             {2: ((2,), ("pod",)), **POD_MODEL_MESH}, "tp")}
# cases whose reference run is another's: the same params, batches and
# configuration on another mesh
SAME_REFERENCE = {"uneven-tp": "uneven", "capped-tp": "capped-fsdp"}


def stacked_params(cfg, n: int, seed: int = 0) -> dict:
    """``n`` clients drawn by the port (one CPU generator each), stacked."""
    bundle = build_bundle(cfg)
    draws = [bundle.init(torch.Generator().manual_seed(seed + i))
             for i in range(n)]
    return {k: torch.stack([d[k] for d in draws]) for k in draws[0]}


def batches(cfg, n: int, seed: int = 3, rows: int = B,
            pub_rows: int = B_PUB) -> list:
    rng = np.random.default_rng(seed)
    return [{"private_tokens": torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (n, rows, T)).astype(np.int32)),
             "public_tokens": torch.from_numpy(rng.integers(
                 0, cfg.vocab_size, (pub_rows, T)).astype(np.int32))}
            for _ in range(STEPS)]


def case(arch: str, exchange: str, n: int = K, neighbors=None,
         moe_impl=None, rows: int = B, pub_rows: int = B_PUB,
         max_pub: int = 0, opt: dict = OPT) -> dict:
    cfg = get_reduced(arch)
    if moe_impl:
        cfg = dataclasses.replace(cfg, moe_impl=moe_impl)
    return {"cfg": cfg, "arch": arch, "moe_impl": moe_impl, "opt": opt,
            "mhd": MHD,
            "dist": dict(num_clients=n, exchange=exchange, topk=TOPK,
                         neighbors=neighbors,
                         max_public_positions=max_pub),
            "params": stacked_params(cfg, n),
            "batches": batches(cfg, n, rows=rows, pub_rows=pub_rows),
            "mesh": MESHES}


CASES = {f"{a}-{e}": (a, e) for a in ARCHS for e in EXCHANGES}


@pytest.fixture(scope="module")
def cases():
    out = {name: case(a, e) for name, (a, e) in CASES.items()}
    out["gather"] = case("mamba2-370m", "topk", 4, GATHER)
    out["gather"]["mesh"] = {2: ((2,), ("pod",))}
    out[A2A] = case("arctic-480b", "topk", moe_impl="a2a")
    out[A2A]["mesh"] = {2: A2A_MESH}
    for name, strategy in POD_MODEL.items():
        out[name] = case("minitron-4b", "topk")
        out[name]["mesh"] = POD_MODEL_MESH
        out[name]["sharding"] = strategy
    for name, (kw, meshes, strategy) in REFUSED.items():
        out[name] = case("minitron-4b", "topk", **kw)
        out[name]["mesh"] = meshes
        out[name]["sharding"] = strategy
        out[name]["record_rows"] = True
    return out


def recording(opt):
    """The reference's optimizer, its state also keeping the norm of the
    gradient it was given (the stacked fleet's)."""
    from repro.optim.optimizers import Optimizer, _global_norm

    def update(g, s, p, t):
        params, state = opt.update(
            g, {k: v for k, v in s.items() if k != "norm"}, p, t)
        return params, {**state, "norm": _global_norm(g)}

    return Optimizer(init=lambda p: {**opt.init(p),
                                     "norm": jnp.zeros((), jnp.float32)},
                     update=update)


MESH_REFERENCE = textwrap.dedent("""
    import os, sys, json, dataclasses
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=2 "
                               "--xla_cpu_multi_thread_eigen=false")
    import jax, jax.numpy as jnp, numpy as np
    from repro.checkpoint.io import flatten_with_paths
    from repro.configs import get_reduced
    from repro.core import mhd_distributed as JMD
    from repro.core.mhd import MHDConfig
    from repro.models import moe_a2a as A
    from repro.models.zoo import build_bundle
    from repro.optim.optimizers import OptimizerConfig, make_optimizer

    # the a2a's boundary rounding the cotangent to bf16 in its own dtype
    # (as written it returns bf16, which an f32 backward refuses;
    # tests/test_torch_moe_a2a.py)
    @jax.custom_vjp
    def rounded(x):
        return x

    rounded.defvjp(lambda x: (x, None),
                   lambda _, g: (g.astype(jnp.bfloat16).astype(g.dtype),))
    A._bf16_grad_boundary = rounded

    c = json.loads(open(sys.argv[1]).read())
    inp = np.load(sys.argv[2])
    cfg = dataclasses.replace(get_reduced(c["arch"]), moe_impl=c["moe_impl"])
    opt = make_optimizer(OptimizerConfig(**c["opt"]))
    step = jax.jit(JMD.make_distributed_mhd_step(
        build_bundle(cfg), opt, MHDConfig(**c["mhd"]),
        JMD.DistributedMHDConfig(**c["dist"])))
    params = {}
    for k in inp.files:
        if k.startswith("p/"):
            node = params
            *parents, leaf = k[2:].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(inp[k])
    state = {"params": params, "opt": opt.init(params),
             "step": jnp.zeros((), jnp.int32)}
    shape, axes = c["mesh"]
    mesh = jax.make_mesh(tuple(shape), tuple(axes),
                         axis_types=(jax.sharding.AxisType.Auto,) * len(axes))
    out = {}
    with jax.set_mesh(mesh):
        for t in range(c["steps"]):
            state, m = step(state, {
                "private_tokens": jnp.asarray(inp[f"b{t}/private_tokens"]),
                "public_tokens": jnp.asarray(inp[f"b{t}/public_tokens"])})
            for k, v in m.items():
                out[f"m{t}/{k}"] = np.asarray(v)
    for k, v in flatten_with_paths(state["params"]).items():
        out["p/" + k] = np.asarray(v)
    np.savez(sys.argv[3], **out)
""")


@pytest.fixture(scope="module")
def ranked(cases, tmp_path_factory):
    """Each world size's run of every case across spawned gloo ranks, and
    the reference's run of the a2a case on its two-device mesh, started
    before the reference's in-process compiles, which run meanwhile."""
    tmp = tmp_path_factory.mktemp("pod")
    c = cases[A2A]
    arrays = {f"p/{k}": v.numpy() for k, v in c["params"].items()}
    for t, b in enumerate(c["batches"]):
        arrays.update({f"b{t}/{k}": v.numpy() for k, v in b.items()})
    np.savez(str(tmp / "mesh_in.npz"), **arrays)
    (tmp / "mesh_case.json").write_text(json.dumps({
        "arch": c["arch"], "moe_impl": c["moe_impl"], "opt": c["opt"],
        "mhd": c["mhd"], "dist": c["dist"], "steps": STEPS,
        "mesh": [list(A2A_MESH[0]), list(A2A_MESH[1])]}))
    (tmp / "mesh_ref.py").write_text(MESH_REFERENCE)
    mesh_ref = subprocess.Popen(
        [sys.executable, str(tmp / "mesh_ref.py"), str(tmp / "mesh_case.json"),
         str(tmp / "mesh_in.npz"), str(tmp / "mesh_out.npz")],
        env=dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    runs = {"mesh_ref": mesh_ref}
    for world in sorted(MESHES):
        todo = {n: c for n, c in cases.items() if world in c["mesh"]}
        torch.save(todo, str(tmp / f"in{world}.pt"))
        runs[world] = torch_ranks.start_ranks(
            torch_ranks.pod_steps, world, str(tmp),
            str(tmp / f"in{world}.pt"), str(tmp / f"out{world}"))
    return runs, tmp


@pytest.fixture(scope="module")
def reference(cases, ranked):
    """The reference's jitted step over each case's batches: (metrics a
    step, the stacked params after); under ``"<name>:norms"`` the norm of
    the gradient it clipped a step, for a clipping case."""
    out = {}
    for name, c in cases.items():
        if name == A2A:  # on its mesh in `ranked`'s subprocess
            continue
        if name in POD_MODEL:  # the same function as minitron-4b-topk's
            out[name] = out["minitron-4b-topk"]
            continue
        if name in SAME_REFERENCE:
            continue
        jopt = jax_optimizer(JOptimizerConfig(**c["opt"]))
        clip = c["opt"].get("grad_clip_norm")
        if clip:
            jopt = recording(jopt)
        jdist = JMD.DistributedMHDConfig(**c["dist"])
        step = jax.jit(JMD.make_distributed_mhd_step(
            jax_bundle(jax_reduced(c["arch"])), jopt, JMHDConfig(**c["mhd"]),
            jdist))
        jp = nested({k: jnp.asarray(v.numpy())
                     for k, v in c["params"].items()})
        state = {"params": jp, "opt": jopt.init(jp),
                 "step": jnp.zeros((), jnp.int32)}
        metrics, norms = [], []
        for b in c["batches"]:
            state, m = step(state, {k: jnp.asarray(v.numpy())
                                    for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
            if clip:
                norms.append(float(state["opt"]["norm"]))
        if clip:
            out[f"{name}:norms"] = norms
        out[name] = metrics, {k: np.asarray(v) for k, v in
                              JIO.flatten_with_paths(state["params"]).items()}
    for name, same in SAME_REFERENCE.items():
        out[name] = out[same]
    return out


@pytest.fixture(scope="module")
def ranks_done(ranked):
    """{world: {rank: {case: {"params", "metrics", "clients", "shard"}}}}
    once every rank has ended."""
    runs, tmp = ranked
    mesh_ref = runs.pop("mesh_ref")
    try:
        _, err = mesh_ref.communicate(timeout=torch_ranks.TIMEOUT_S)
    except subprocess.TimeoutExpired:
        mesh_ref.kill()
        mesh_ref.communicate()
        raise
    assert mesh_ref.returncode == 0, err[-3000:]
    with np.load(str(tmp / "mesh_out.npz")) as f:
        ref = {k: f[k] for k in f.files}
    out = {"mesh_ref": (
        [{k: float(ref[f"m{t}/{k}"]) for k in ("loss", "ce", "dist")}
         for t in range(STEPS)],
        {k[2:]: v for k, v in ref.items() if k.startswith("p/")})}
    for world, handle in runs.items():
        torch_ranks.wait_ranks(handle)
        out[world] = {r: torch.load(str(tmp / f"out{world}.{r}"),
                                    weights_only=False)
                      for r in range(world)}
    return out


def port_world1(c: dict):
    bundle = build_bundle(c["cfg"])
    opt = make_optimizer(OptimizerConfig(**c["opt"]))
    dcfg = MD.DistributedMHDConfig(**c["dist"])
    step = MD.make_distributed_mhd_step(bundle, opt, MHDConfig(**c["mhd"]),
                                        dcfg)
    params = MD.local_params(c["params"], bundle, dcfg.num_clients)
    state = {"params": params, "opt": opt.init(params), "step": 0}
    metrics = []
    for b in c["batches"]:
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state["params"]


def hold(metrics, params, ref, what: str) -> None:
    ref_metrics, ref_params = ref
    assert len(metrics) == len(ref_metrics) == STEPS
    for t, (m, r) in enumerate(zip(metrics, ref_metrics)):
        assert set(m) == set(r) == {"loss", "ce", "dist"}
        for k in r:
            np.testing.assert_allclose(m[k], r[k], rtol=RTOL_METRICS,
                                       err_msg=f"{what} step {t} {k}")
    assert set(params) == set(ref_params)
    for k, v in params.items():
        np.testing.assert_allclose(v.numpy(), ref_params[k], rtol=0,
                                   atol=ATOL_PARAMS, err_msg=f"{what} {k}")


@pytest.mark.parametrize("name", list(CASES) + ["gather"])
def test_pod_step_at_world_size_1_matches_the_reference(name, cases,
                                                        reference):
    metrics, params = port_world1(cases[name])
    hold(metrics, params, reference[name], f"{name} world 1")
    moved = [k for k in params
             if not torch.equal(params[k], cases[name]["params"][k])]
    assert moved


def assembled(ranks: dict, name: str):
    """The fleet's stacked params from the ranks' blocks (the ranks of a
    pod hold its clients: whole leaves must agree bitwise, expert shards
    are put together by their specs), and the metrics every rank reported
    (which must agree)."""
    pods, metrics = {}, None
    for r, res in ranks.items():
        res = res[name]
        pods.setdefault(tuple(res["clients"]), []).append(res)
        if metrics is None:
            metrics = res["metrics"]
        assert res["metrics"] == metrics, (name, r)
    blocks = {}
    for clients, members in pods.items():
        first = members[0]
        block = {}
        for k, v in first["params"].items():
            if k in first["specs"]:
                block[k] = unshard_leaf(
                    {m["coords"]: m["params"][k] for m in members},
                    (None,) + tuple(first["specs"][k]), first["sizes"],
                    first["inner"])
            else:
                for m in members[1:]:
                    assert torch.equal(m["params"][k], v), (name, k)
                block[k] = v
        blocks[clients] = block
    order = sorted(blocks)
    params = {k: torch.cat([blocks[c][k] for c in order])
              for k in blocks[order[0]]}
    return metrics, params


@pytest.mark.parametrize("name,world", [(n, w) for n in CASES
                                        for w in sorted(MESHES)]
                         + [("gather", 2), (A2A, 2)]
                         + [(n, 4) for n in POD_MODEL])
def test_pod_step_across_ranks_matches_the_reference(name, world, reference,
                                                     ranks_done):
    """Across ranks against the reference; the a2a case against the
    reference's step on the same (pod 1, model 2) mesh (its per-rank
    capacity and aux differ from one device's by design)."""
    metrics, params = assembled(ranks_done[world], name)
    ref = ranks_done["mesh_ref"] if name == A2A else reference[name]
    hold(metrics, params, ref, f"{name} world {world}")


def test_gather_form_moves_packs_locally_and_across_pods():
    lay0 = MD.PodLayout(4, 2, 0, (), 1, 0)
    srcs = MD._teacher_sources(MD.DistributedMHDConfig(4, neighbors=GATHER))
    local = [i for i in lay0.clients if lay0.owner(srcs[i]) == lay0.pod]
    assert local == [1] and srcs == [3, 0, 0, 2]


# ---------------------------------------------------------------------------
# the wire helpers
# ---------------------------------------------------------------------------

def _logits(shape, seed: int) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x[..., 5] = x[..., 9]  # a tie: the lower index first
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topk_helpers_match_the_reference(dtype):
    x = _logits((2, 6, 96), 0)
    xt = torch.from_numpy(x).to(dtype)
    xj = jnp.asarray(xt.float().numpy(),
                     jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    v, i = TW.topk_iterative(xt, 8)
    vj, ij = JW.topk_iterative(xj, 8)
    assert v.dtype == dtype and i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(v.float().numpy(),
                                  np.asarray(vj, np.float32))
    outs = {"embedding": torch.ones(6, 4), "logits": xt[0],
            "aux_logits": xt[1:].reshape(1, 6, 96)}
    jouts = {"embedding": jnp.ones((6, 4)), "logits": xj[0],
             "aux_logits": xj[1:].reshape(1, 6, 96)}
    pack, jpack = TW.topk_pack_outputs(outs, 8), JW.topk_pack_outputs(jouts, 8)
    for head in ("logits", "aux_logits"):
        p, q = pack[head], jpack[head]
        assert p["vals"].dtype == dtype and p["lse"].dtype == torch.float32
        np.testing.assert_array_equal(p["idx"].numpy(), np.asarray(q["idx"]))
        np.testing.assert_array_equal(p["vals"].float().numpy(),
                                      np.asarray(q["vals"], np.float32))
        lse, jlse = p["lse"].numpy(), np.asarray(q["lse"])
        assert (np.abs(lse - jlse) <= 2 * np.spacing(np.abs(jlse))).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_xent_helpers_match_the_reference(dtype):
    s = torch.from_numpy(_logits((12, 96), 1)).to(dtype)
    t = torch.from_numpy(_logits((12, 96), 2)).to(dtype)
    sj = jnp.asarray(s.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    tj = jnp.asarray(t.float().numpy()).astype(sj.dtype)
    ce, conf = TW.dense_xent_and_conf(s, t)
    jce, jconf = JW.dense_xent_and_conf(sj, tj)
    np.testing.assert_allclose(ce.numpy(), np.asarray(jce), rtol=1e-5)
    np.testing.assert_allclose(conf.numpy(), np.asarray(jconf), rtol=1e-5)
    pack = TW.topk_pack_outputs({"embedding": None, "logits": t,
                                 "aux_logits": None}, 8)["logits"]
    jpack = JW.topk_pack_outputs({"embedding": None, "logits": tj,
                                  "aux_logits": tj[None]}, 8)["logits"]
    ce, conf = TW.sparse_xent_and_conf(s, pack)
    jce, jconf = JW.sparse_xent_and_conf(sj, jpack)
    np.testing.assert_allclose(ce.numpy(), np.asarray(jce), rtol=1e-5)
    np.testing.assert_allclose(conf.numpy(), np.asarray(jconf), rtol=1e-5)
    # the dense CE's gradient is the student's only
    sg = s.float().clone().requires_grad_()
    TW.dense_xent_and_conf(sg, t)[0].sum().backward()
    g = jax.grad(lambda a: JW.dense_xent_and_conf(a, tj.astype(
        jnp.float32))[0].sum())(jnp.asarray(s.float().numpy()))
    np.testing.assert_allclose(sg.grad.numpy(), np.asarray(g), atol=1e-6)


@pytest.mark.parametrize("neighbors,match", [
    (((1,), (0,), (0,)), "3 neighbor rows for 2 clients"),
    (((1,), (0, 1)), "client 1 has 2 in-neighbors"),
    (((0,), (0,)), "client 0 names teacher 0"),
    (((2,), (0,)), "client 0 names teacher 2")])
def test_teacher_sources_refuse_what_the_reference_refuses(neighbors, match):
    for mod in (MD, JMD):
        with pytest.raises(ValueError, match=match):
            mod._teacher_sources(mod.DistributedMHDConfig(
                num_clients=2, neighbors=neighbors))
    assert MD._teacher_sources(MD.DistributedMHDConfig(3)) == [2, 0, 1]


def test_pod_step_refuses_a_batch_its_ranks_do_not_split():
    lay = MD.PodLayout(2, 1, 0, ("data",), 2, 0)
    with pytest.raises(ValueError, match="clients do not split"):
        MD.pod_layout(3, type("M", (), {
            "mesh_dim_names": ("pod",), "mesh": torch.zeros(2),
            "get_local_rank": lambda self, a: 0})())
    assert lay.per_pod == 2 and list(lay.clients) == [0, 1]


# ---------------------------------------------------------------------------
# make_mhd_train_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_mhd_train_step_matches_the_reference(arch):
    """One student, Δ = 2 teachers' params, 2 steps of the port's
    `make_mhd_train_step` against the reference's jitted one: every
    metric within 1e-4 relative, the params within 1e-5 absolute; the
    teachers' params untouched."""
    cfg = get_reduced(arch)
    jcfg = jax_reduced(arch)
    mhd = dict(MHD, delta=2)
    student = {k: v[0] for k, v in stacked_params(cfg, 1, seed=10).items()}
    teachers = stacked_params(cfg, 2, seed=20)
    frozen = {k: v.clone() for k, v in teachers.items()}
    jopt = jax_optimizer(JOptimizerConfig(**OPT))
    jstep = jax.jit(JSTEPS.make_mhd_train_step(
        jax_bundle(jcfg), jopt, JMHDConfig(**mhd)))
    jp = nested({k: jnp.asarray(v.numpy()) for k, v in student.items()})
    jt = nested({k: jnp.asarray(v.numpy()) for k, v in teachers.items()})
    jstate = {"params": jp, "opt": jopt.init(jp),
              "step": jnp.zeros((), jnp.int32)}
    opt = make_optimizer(OptimizerConfig(**OPT))
    step = TSTEPS.make_mhd_train_step(build_bundle(cfg), opt,
                                      MHDConfig(**mhd))
    state = {"params": student, "opt": opt.init(student), "step": 0}
    for t, b in enumerate(batches(cfg, 1, seed=5)):
        batch = {"private_tokens": b["private_tokens"][0],
                 "public_tokens": b["public_tokens"],
                 "teacher_params": teachers}
        jstate, jm = jstep(jstate, {
            "private_tokens": jnp.asarray(batch["private_tokens"].numpy()),
            "public_tokens": jnp.asarray(batch["public_tokens"].numpy()),
            "teacher_params": jt})
        state, m = step(state, batch)
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=RTOL_METRICS,
                                       err_msg=f"{arch} step {t} {k}")
    flat = JIO.flatten_with_paths(jstate["params"])
    for k, v in state["params"].items():
        np.testing.assert_allclose(v.numpy(), np.asarray(flat[k]), rtol=0,
                                   atol=ATOL_PARAMS, err_msg=k)
    for k, v in teachers.items():
        assert torch.equal(v, frozen[k]), k


@pytest.mark.parametrize("name,world", [(n, w) for n in REFUSED
                                        for w in sorted(REFUSED[n][1])])
def test_pod_step_runs_what_the_reference_runs(name, world, reference,
                                               ranks_done):
    """The cases the pod step once refused (uneven rows, capped public
    positions over two token shards) and clipping by the fleet's norm,
    across ranks against the reference's step on the same case. No rank
    distilled on zero rows: at 10 of 30 capped positions the second token
    shard of each pod scored no row at all. A clipping case's norm binds
    at both steps."""
    metrics, params = assembled(ranks_done[world], name)
    hold(metrics, params, reference[name], f"{name} world {world}")
    rows = {r: res[name]["distilled_rows"]
            for r, res in ranks_done[world].items()}
    assert all(n > 0 for calls in rows.values() for n in calls), rows
    if name == "capped":
        shard = {r: res[name]["coords"][0]
                 for r, res in ranks_done[world].items()}
        assert all(bool(rows[r]) == (shard[r] == 0) for r in rows), rows
    if name == "clip":
        assert min(reference["clip:norms"]) > CLIP_NORM
