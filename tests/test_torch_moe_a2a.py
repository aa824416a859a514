"""The expert-parallel MoE (`repro_torch.models.moe_a2a.moe_apply_a2a`)
against the reference's ``repro.models.moe_a2a.moe_apply_a2a`` on the
same mesh shape — never against the scatter form: capacity and the aux
loss are counted per device, so the two forms differ by design.

The reference runs in a subprocess with four forced host devices (the
device count is fixed when jax initializes; this process already has
one) and writes its outputs to an npz; the port runs across spawned gloo
ranks (`torch_ranks.a2a_cases`), 4 at ``(data 2, model 2)`` and 2 at
``(model 2)``, each on its block of the tokens and its shards of the
expert weights. Held:

  * y and the aux loss within 1e-5;
  * the gradients of Σ y·cot + c·aux with respect to the tokens, the
    router, the shared expert and the expert weights. The reference's
    custom-vjp boundary before each all-to-all returns the cotangent as
    bf16, which its f32 backward refuses (``lax.mul`` of bfloat16 and
    float32 at the dispatch's product: ``jax.grad`` of the reference's
    a2a raises for an f32 model). The reference's script here replaces
    that boundary by one that rounds the cotangent to bf16 and returns
    it in its own dtype — the values the boundary means — and the port
    does the same rounding (it sends the cotangent in bf16). Values that
    agree to f32 precision round alike except where one sits at a bf16
    rounding boundary, so the gradients behind the boundary (tokens,
    expert weights) are held within 1e-2 of the leaf's largest magnitude
    (a bf16 ulp is 2⁻⁸ of a value), the router's and the shared
    expert's, which it does not touch, within 1e-5;
  * a case whose capacity drops pairs (counted on the port's routing);
  * the scatter form where the reference takes it: E not divisible by
    |model|, at both mesh shapes (y, aux and every gradient within 1e-5:
    no boundary there).
"""
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
from repro_torch.launch.shardings import param_pspec, unshard_leaf
from repro_torch.models.config import MoEConfig
from repro_torch.models.moe import router_topk, slot_positions

test_torch_threads.share_cores()

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TOL, TOL_BF16 = 1e-5, 1e-2
N, D, F = 16, 16, 8
DM = ((2, 2), ("data", "model"))
M = ((2,), ("model",))
# name: (mesh, experts, top_k, capacity_factor, scoring, shared, form)
CASES = {
    "dm": (DM, 4, 2, 4.0, "softmax", 0, "a2a"),
    "dm_drops": (DM, 4, 2, 0.5, "softmax", 0, "a2a"),
    "dm_sigmoid_shared": (DM, 4, 2, 2.0, "sigmoid", 1, "a2a"),
    "m": (M, 4, 2, 1.25, "softmax", 0, "a2a"),
    "dm_scatter": (DM, 3, 2, 1.25, "softmax", 0, "scatter"),
    "m_scatter": (M, 3, 1, 1.0, "softmax", 0, "scatter"),
}

REFERENCE = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_cpu_multi_thread_eigen=false")
    import jax, jax.numpy as jnp, numpy as np
    from repro.models import moe_a2a as A
    from repro.models.config import MoEConfig
    from repro.models.moe_a2a import moe_apply_a2a

    # the boundary's cotangent rounded to bf16 and returned in its own
    # dtype: as written it returns a bf16 cotangent, which an f32 model's
    # backward refuses (lax.mul of bfloat16 and float32 at the dispatch)
    @jax.custom_vjp
    def rounded(x):
        return x

    rounded.defvjp(lambda x: (x, None),
                   lambda _, g: (g.astype(jnp.bfloat16).astype(g.dtype),))
    A._bf16_grad_boundary = rounded

    inp = np.load(sys.argv[1])
    spec = json.loads(open(sys.argv[2]).read())
    out = {}
    for name, c in spec.items():
        shape, axes = c["mesh"]
        n = int(np.prod(shape))
        mesh = jax.make_mesh(tuple(shape), tuple(axes),
                             devices=jax.devices()[:n],
                             axis_types=(jax.sharding.AxisType.Auto,)
                             * len(axes))
        cfg = MoEConfig(**c["moe"])
        keys = [k[len(name) + 1:] for k in inp.files
                if k.startswith(name + "/p/")]
        params = {}
        for k in keys:
            parts = k.split("/")[1:]
            node = params
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(inp[name + "/" + k])
        x = jnp.asarray(inp[name + "/x"])
        cot = jnp.asarray(inp[name + "/cot"])

        def f(params, x):
            y, aux = moe_apply_a2a(params, x, cfg, scoring=c["scoring"])
            return jnp.sum(y * cot) + c["c"] * aux, (y, aux)

        with jax.set_mesh(mesh):
            (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                f, argnums=(0, 1), has_aux=True))(params, x)
        out[name + "/y"] = np.asarray(y)
        out[name + "/aux"] = np.asarray(aux)
        out[name + "/g/x"] = np.asarray(gx)
        for k, v in jax.tree_util.tree_flatten_with_path(gp)[0]:
            path = "/".join(str(p.key) for p in k)
            out[name + "/g/" + path] = np.asarray(v)
    np.savez(sys.argv[3], **out)
""")


def make_case(name, spec, seed):
    mesh, E, K, cf, scoring, shared, _ = spec
    rng = np.random.default_rng(seed)
    cfg = MoEConfig(num_experts=E, top_k=K, d_ff_expert=F,
                    num_shared_experts=shared, capacity_factor=cf)
    params = {"router": rng.standard_normal((D, E)) / np.sqrt(D),
              "w_gate": rng.standard_normal((E, D, F)) / np.sqrt(D),
              "w_up": rng.standard_normal((E, D, F)) / np.sqrt(D),
              "w_down": rng.standard_normal((E, F, D)) / np.sqrt(F)}
    if shared:
        params.update({
            "shared/w_gate": rng.standard_normal((D, F * shared)) / 4,
            "shared/w_up": rng.standard_normal((D, F * shared)) / 4,
            "shared/w_down": rng.standard_normal((F * shared, D)) / 4})
    t = {k: torch.from_numpy(v.astype(np.float32)) for k, v in params.items()}
    return {"mesh": mesh, "cfg": cfg, "scoring": scoring, "c": 0.7,
            "params": t,
            "x": torch.from_numpy(rng.standard_normal((N, D)).astype(
                np.float32)),
            "cot": torch.from_numpy(rng.standard_normal((N, D)).astype(
                np.float32))}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(the reference's npz, {world: {rank: the port's results}}, cases):
    the reference's subprocess and both worlds' ranks run side by side."""
    tmp = tmp_path_factory.mktemp("a2a")
    cases = {n: make_case(n, s, i) for i, (n, s) in enumerate(CASES.items())}
    torch.save(cases, str(tmp / "in.pt"))
    arrays = {}
    for n, c in cases.items():
        arrays[f"{n}/x"] = c["x"].numpy()
        arrays[f"{n}/cot"] = c["cot"].numpy()
        for k, v in c["params"].items():
            arrays[f"{n}/p/{k}"] = v.numpy()
    np.savez(str(tmp / "ref_in.npz"), **arrays)
    spec = {n: {"mesh": [list(c["mesh"][0]), list(c["mesh"][1])],
                "moe": {"num_experts": c["cfg"].num_experts,
                        "top_k": c["cfg"].top_k, "d_ff_expert": F,
                        "num_shared_experts": c["cfg"].num_shared_experts,
                        "capacity_factor": c["cfg"].capacity_factor},
                "scoring": c["scoring"], "c": c["c"]}
            for n, c in cases.items()}
    (tmp / "ref_spec.json").write_text(json.dumps(spec))
    script = tmp / "ref.py"
    script.write_text(REFERENCE)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, str(script), str(tmp / "ref_in.npz"),
         str(tmp / "ref_spec.json"), str(tmp / "ref_out.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    runs = {w: torch_ranks.start_ranks(torch_ranks.a2a_cases, w, str(tmp),
                                       str(tmp / "in.pt"),
                                       str(tmp / f"out{w}"))
            for w in (4, 2)}
    try:
        _, err = ref.communicate(timeout=torch_ranks.TIMEOUT_S)
    except subprocess.TimeoutExpired:
        ref.kill()
        ref.communicate()
        raise
    assert ref.returncode == 0, err[-3000:]
    port = {}
    for w, handle in runs.items():
        torch_ranks.wait_ranks(handle)
        port[w] = {r: torch.load(str(tmp / f"out{w}.{r}"), weights_only=False)
                   for r in range(w)}
    with np.load(str(tmp / "ref_out.npz")) as f:
        reference = {k: f[k] for k in f.files}
    return reference, port, cases


def gathered(port, name, case):
    """The port's global y, aux and gradients from the ranks' blocks."""
    shape, axes = case["mesh"]
    world = int(np.prod(shape))
    ranks = [port[world][r][name] for r in range(world)]
    sizes = dict(zip(axes, shape))
    blocks = sorted(ranks, key=lambda r: r["coords"])
    y = torch.cat([r["y"] for r in blocks])
    gx = torch.cat([r["grads"]["x"] for r in blocks])
    grads = {"x": gx}
    for k in case["params"]:
        if k in ranks[0]["specs"]:
            grads[k] = unshard_leaf({r["coords"]: r["grads"][k]
                                     for r in ranks},
                                    ranks[0]["specs"][k], sizes, axes)
        else:
            for r in ranks[1:]:
                assert torch.equal(r["grads"][k], ranks[0]["grads"][k]), k
            grads[k] = ranks[0]["grads"][k]
    auxes = {r["aux"] for r in ranks}
    assert len(auxes) == 1, auxes
    return y, auxes.pop(), grads


@pytest.mark.parametrize("name", list(CASES))
def test_a2a_matches_the_reference_on_its_mesh(name, results):
    reference, port, cases = results
    case = cases[name]
    y, aux, grads = gathered(port, name, case)
    np.testing.assert_allclose(y.numpy(), reference[f"{name}/y"], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(aux, reference[f"{name}/aux"], rtol=TOL,
                               atol=TOL)
    behind = {"x", "w_gate", "w_up", "w_down"} \
        if CASES[name][-1] == "a2a" else set()
    for k, g in grads.items():
        ref = reference[f"{name}/g/{k}"]
        tol = TOL_BF16 * np.abs(ref).max() if k in behind else TOL
        np.testing.assert_allclose(g.numpy(), ref, rtol=0 if k in behind
                                   else TOL, atol=tol, err_msg=k)


def test_the_drop_case_drops_pairs_and_the_others_keep_them(results):
    """Capacity counted per rank: the drop case's cut leaves pairs out on
    some rank, the roomy case's on none."""
    _, _, cases = results

    def dropped(name):
        c = cases[name]
        world = int(np.prod(c["mesh"][0]))
        rows = N // world
        cfg = c["cfg"]
        cap = max(int(np.ceil(rows * cfg.top_k / cfg.num_experts
                              * cfg.capacity_factor)), 1)
        total = 0
        for b in range(world):
            xb = c["x"][b * rows:(b + 1) * rows]
            _, ids, _ = router_topk(xb @ c["params"]["router"], cfg.top_k,
                                    c["scoring"])
            _, keep = slot_positions(ids.reshape(-1), cfg.num_experts, cap)
            total += int((~keep).sum())
        return total

    assert dropped("dm_drops") > 0
    assert dropped("dm") == 0


def test_expert_specs_follow_the_rules():
    sizes = {"data": 2, "model": 2}
    assert param_pspec("ffn/w_gate", (4, 16, 8), sizes) == \
        ("model", "data", None)
    assert param_pspec("ffn/w_down", (4, 8, 16), sizes) == \
        ("model", None, "data")
    assert param_pspec("ffn/w_gate", (3, 16, 8), sizes) == \
        (None, "data", None)
    assert param_pspec("stage0/layer0/ffn/w_up", (2, 4, 16, 8), sizes) == \
        (None, "model", "data", None)
