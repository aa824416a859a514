"""The port's mesh and sharding rules (`repro_torch.launch.mesh`,
`repro_torch.launch.shardings`, `repro_torch.common.sharding`) and the
rest of `repro_torch.common` (`dtypes`, `pytree`) against the JAX
package's, on the CPU.

  * the mesh: `make_test_mesh` / `make_production_mesh` under a fake
    process group (axis names, shape, this rank's coordinates, the
    groups' ranks, the timeout), `required_devices`, and that importing
    the module touches no process group;
  * `param_pspec` / `params_shardings`, `batch_shardings` and
    `cache_shardings` equal to the reference's ``PartitionSpec``s (as
    tuples) for every leaf of every ``arch_ids()`` config, on meta params
    and meta caches, at the 16×16 and 2×16×16 sizes (an abstract mesh, as
    tests/test_shardings.py fakes one);
  * `shard_leaf` then `unshard_leaf` gives the leaf back bitwise;
  * `maybe_shard` and the logical roles; `use_mesh`;
  * `DtypePolicy` and every `pytree` function against the reference's.
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import test_torch_threads
from repro.common import dtypes as JDT
from repro.common import pytree as JPT
from repro.common import sharding as JSH
from repro.common.pytree import flatten_with_paths
from repro.configs import get_config as jax_config
from repro.configs import shapes as JS
from repro.launch import mesh as JMESH
from repro.launch import shardings as JSHD
from repro.models.zoo import build_bundle as jax_bundle
from repro_torch.common import dtypes as TDT
from repro_torch.common import pytree as TPT
from repro_torch.common import sharding as TSH
from repro_torch.configs import arch_ids, get_config
from repro_torch.configs import shapes as TS
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import shardings as TSHD
from repro_torch.models import build_bundle
from repro_torch.models.layers import MetaDraw

test_torch_threads.share_cores()


class _AbstractMesh:
    """An abstract mesh of the production sizes (no devices)."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.empty(shape, dtype=object)


MESHES = {"16x16": _AbstractMesh((16, 16), ("data", "model")),
          "2x16x16": _AbstractMesh((2, 16, 16), ("pod", "data", "model"))}


def _spec(p) -> tuple:
    return tuple(p)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_importing_the_mesh_module_touches_no_process_group():
    out = subprocess.run(
        [sys.executable, "-c",
         "import torch.distributed as d, repro_torch.launch.mesh, "
         "repro_torch.common.sharding; print(d.is_initialized())"],
        capture_output=True, text=True, timeout=60, check=True,
        env={"PYTHONPATH": TS.__file__.rsplit("/repro_torch/", 1)[0]})
    assert out.stdout.strip() == "False"


def test_required_devices_keeps_its_meaning():
    for mp in (False, True):
        assert TMESH.required_devices(mp) == JMESH.required_devices(mp)
    assert TMESH.SINGLE_POD == JMESH.SINGLE_POD
    assert TMESH.MULTI_POD == JMESH.MULTI_POD


@pytest.mark.parametrize("shape,axes", [((2, 2), ("data", "model")),
                                        ((2, 2, 2), ("pod", "data",
                                                     "model"))])
def test_test_mesh_under_a_fake_group(shape, axes):
    world = int(np.prod(shape))
    with DR.fake_group(world):
        mesh = TMESH.make_test_mesh(shape, axes, "cpu")
        assert tuple(mesh.mesh_dim_names) == axes
        assert tuple(mesh.mesh.shape) == shape
        assert TSH.mesh_axis_sizes(mesh) == dict(zip(axes, shape))
        assert all(mesh.get_local_rank(a) == 0 for a in axes)
        for a in axes:
            g = mesh.get_group(a)
            step = int(np.prod(shape[axes.index(a) + 1:]))
            assert dist.get_process_group_ranks(g) == \
                [i * step for i in range(shape[axes.index(a)])]
        g = TSH.group_of(mesh, axes[-2:])
        assert dist.get_process_group_ranks(g) == \
            list(range(shape[-2] * shape[-1]))
        assert TSH.group_of(mesh, axes[-2:]) is g  # made once
        with pytest.raises(ValueError, match="out of the mesh's order"):
            TSH.group_of(mesh, axes[::-1][:2])
        with TSH.use_mesh(mesh, axes[-1:]):
            assert TSH.mesh_axis_sizes() == {axes[-1]: shape[-1]}
            with TSH.use_mesh(None):
                assert TSH.mesh_axis_sizes() == {}
        assert TSH.active_mesh() == (None, ())
        with pytest.raises(ValueError, match="a \\(3,\\) mesh needs 3"):
            TMESH.make_mesh((3,), ("pod",), "cpu")


def test_production_meshes_under_a_fake_group():
    for mp in (False, True):
        with DR.fake_group(TMESH.required_devices(mp)):
            mesh = TMESH.make_production_mesh(multi_pod=mp,
                                              device_type="cpu")
            want = JMESH.MULTI_POD if mp else JMESH.SINGLE_POD
            assert tuple(mesh.mesh.shape) == want
            assert tuple(mesh.mesh_dim_names) == (
                ("pod", "data", "model") if mp else ("data", "model"))


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shapes():
    """Each arch's params (the port's on meta, the reference's from
    ``eval_shape``) and its decode caches (both packages' input specs)."""
    out = {}
    for arch in arch_ids():
        cfg, jcfg = get_config(arch), jax_config(arch)
        params = build_bundle(cfg, dtype=torch.bfloat16).init(
            MetaDraw().manual_seed(0))
        ref = jax.eval_shape(jax_bundle(jcfg, dtype=jnp.bfloat16).init,
                             jax.random.PRNGKey(0))
        caches = []
        for name, shape in TS.INPUT_SHAPES.items():
            if shape.mode == "decode" and not TS.supports_shape(
                    arch, cfg, shape):
                caches.append((TS.input_specs(cfg, name),
                               JS.input_specs(jcfg, name)))
        out[arch] = params, ref, caches
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", arch_ids())
def test_param_and_cache_rules_match_the_reference(arch, mesh, shapes):
    params, ref, caches = shapes[arch]
    m = MESHES[mesh]
    got = TSHD.params_shardings(params, m)
    want = {k: _spec(v) for k, v in flatten_with_paths(
        JSHD.params_shardings(ref, m)).items()}
    assert got == want
    assert any(any(e is not None for e in s) for s in got.values())
    for k, v in params.items():
        assert TSHD.param_pspec(k, tuple(v.shape), m) == got[k]
    for port, jref in caches:
        got = TSHD.cache_shardings(port["caches"], m)
        want = {k: _spec(v) for k, v in flatten_with_paths(
            JSHD.cache_shardings(jref["caches"], m)).items()}
        assert got == want
        tok = TSHD.batch_shardings({"t": port["token"]}, m)["t"]
        assert tok == _spec(JSHD.batch_shardings(
            {"t": jref["token"]}, m)["t"])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_rules_match_the_reference(mesh):
    m = MESHES[mesh]
    cfg, jcfg = get_config("llama-3.2-vision-90b"), \
        jax_config("llama-3.2-vision-90b")
    got = TSHD.batch_shardings(TS.input_specs(cfg, "train_4k"), m)
    want = {k: _spec(v) for k, v in JSHD.batch_shardings(
        JS.input_specs(jcfg, "train_4k"), m).items()}
    assert got == want and len(got) == 2
    odd = {"tokens": torch.empty(3, 5, device="meta")}
    assert TSHD.batch_shardings(odd, m) == {"tokens": (None, None)}
    assert TSHD.mesh_sizes({"data": 4}) == {"data": 4}


def test_rules_on_the_reference_tests_fake_mesh():
    """tests/test_shardings.py's divisibility cases, on the port's names."""
    m = {"data": 4, "model": 2}
    assert TSHD.param_pspec("embed", (512, 64), m) == ("model", "data")
    assert TSHD.param_pspec("embed", (511, 64), m) == (None, "data")
    assert TSHD.param_pspec("stage0/layer0/attn/wq", (8, 64, 32), m) == \
        (None, "data", "model")
    assert TSHD.param_pspec("final_norm/scale", (64,), m) == ()
    assert TSHD.param_pspec("stage1/layer0/ffn/w_gate", (8, 4, 64, 128),
                            m) == (None, "model", "data", None)
    roles = dict(TSHD.DEFAULT_ROLES, tp=("data", "model"))
    assert TSHD.param_pspec("lm_head", (64, 512), m, roles) == \
        ("data", ("data", "model"))


SPECS = [(), (None, "data"), ("model", "data", None),
         (None, ("data", "model"), None), (("pod", "data"), None, "model"),
         (None, None, ("model", "pod"))]


@pytest.mark.parametrize("spec", SPECS, ids=[str(s) for s in SPECS])
def test_shard_then_unshard_is_the_leaf(spec):
    sizes = {"pod": 2, "data": 2, "model": 3}
    axes = ("pod", "data", "model")
    x = torch.randn(12, 18, 6, generator=torch.Generator().manual_seed(0))
    blocks = {}
    for c in np.ndindex(2, 2, 3):
        blk = TSHD.shard_leaf(x, spec, sizes, dict(zip(axes, c)))
        used = [a for e in spec if e for a in ((e,) if isinstance(e, str)
                                               else e)]
        assert blk.numel() * int(np.prod([sizes[a] for a in used])) == \
            x.numel()
        blocks[c] = blk
    y = TSHD.unshard_leaf(blocks, spec, sizes, axes)
    assert torch.equal(x, y)


def test_shard_params_cuts_the_expert_leaves_only():
    import dataclasses

    cfg = get_config("arctic-480b")  # published with moe_impl="a2a"
    assert cfg.moe_impl == "a2a"
    params = build_bundle(cfg).init(MetaDraw().manual_seed(0))
    sizes = {"data": 2, "model": 4}
    specs = TSHD.expert_specs(params, cfg, sizes)
    assert sorted(k.rsplit("/", 1)[1] for k in specs) == \
        ["w_down", "w_gate", "w_up"]
    assert all(v[1] == "model" for v in specs.values())
    assert TSHD.expert_specs(params, dataclasses.replace(
        cfg, moe_impl="scatter"), sizes) == {}
    stacked = {k: v.unsqueeze(0) for k, v in params.items()}
    cut = TSHD.shard_params(stacked, specs, sizes, {"data": 1, "model": 3},
                            lead=1)
    for k, v in cut.items():
        if k in specs:
            assert v.shape[2] * 4 == stacked[k].shape[2], k
        else:
            assert v.shape == stacked[k].shape, k


def test_maybe_shard_returns_its_input_and_the_roles_are_the_reference():
    x = torch.ones(2, 3)
    assert TSH.maybe_shard(x, "batch", "model") is x
    for role in ("batch", "seq", "model", "expert", "fsdp_tokens", "none"):
        assert TSH.get_logical_rule(role) == JSH.get_logical_rule(role)
    TSH.set_logical_rule("seq", "data")
    try:
        assert TSH.get_logical_rule("seq") == "data"
    finally:
        TSH.set_logical_rule("seq", None)


# ---------------------------------------------------------------------------
# dtypes and pytree
# ---------------------------------------------------------------------------

def test_dtype_policy_matches_the_reference():
    names = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    for t, j in ((TDT.DtypePolicy.fp32(), JDT.DtypePolicy.fp32()),
                 (TDT.DtypePolicy.tpu_bf16(), JDT.DtypePolicy.tpu_bf16()),
                 (TDT.DtypePolicy(), JDT.DtypePolicy())):
        for f in ("param_dtype", "compute_dtype", "accum_dtype"):
            assert names[getattr(t, f)] == jnp.dtype(getattr(j, f)).name
    x = TDT.DtypePolicy.tpu_bf16().cast_compute(torch.ones(2))
    assert x.dtype == torch.bfloat16


def _trees(seed: int):
    rng = np.random.default_rng(seed)
    flat = {"a/w": rng.standard_normal((3, 4)).astype(np.float32),
            "a/b": rng.standard_normal(4).astype(np.float32),
            "c": rng.integers(0, 5, 3).astype(np.int32)}
    port = {k: torch.from_numpy(v.copy()) for k, v in flat.items()}
    ref = {"a": {"w": jnp.asarray(flat["a/w"]), "b": jnp.asarray(flat["a/b"])},
           "c": jnp.asarray(flat["c"])}
    return port, ref


def _same(port: dict, ref, exact: bool = True) -> None:
    flat = flatten_with_paths(ref)
    assert set(port) == set(flat)
    for k, v in port.items():
        r = np.asarray(flat[k])
        assert v.numpy().dtype == r.dtype, k
        if exact:
            np.testing.assert_array_equal(v.numpy(), r, err_msg=k)
        else:
            np.testing.assert_allclose(v.numpy(), r, rtol=1e-6, err_msg=k)


def test_pytree_functions_match_the_reference():
    (x, jx), (y, jy) = _trees(0), _trees(1)
    _same(TPT.tree_zeros_like(x), JPT.tree_zeros_like(jx))
    _same(TPT.tree_add(x, y), JPT.tree_add(jx, jy))
    _same(TPT.tree_sub(x, y), JPT.tree_sub(jx, jy))
    fx = {k: v for k, v in x.items() if v.is_floating_point()}
    fy = {k: v for k, v in y.items() if v.is_floating_point()}
    jfx, jfy = {"a": jx["a"]}, {"a": jy["a"]}
    _same(TPT.tree_scale(fx, 0.5), JPT.tree_scale(jfx, 0.5))
    _same(TPT.tree_axpy(0.3, fx, fy), JPT.tree_axpy(0.3, jfx, jfy), False)
    _same(TPT.tree_mean([fx, fy]), JPT.tree_mean([jfx, jfy]))
    np.testing.assert_allclose(float(TPT.tree_l2_norm(x)),
                               float(JPT.tree_l2_norm(jx)), rtol=1e-6)
    assert TPT.tree_size(x) == JPT.tree_size(jx)
    assert TPT.tree_bytes(x) == JPT.tree_bytes(jx)
    cast = TPT.tree_cast(x, torch.bfloat16)
    jcast = JPT.tree_cast(jx, jnp.bfloat16)
    assert {k: str(v.dtype).replace("torch.", "") for k, v in cast.items()
            } == {k: str(v.dtype) for k, v in
                  flatten_with_paths(jcast).items()}
    assert not bool(TPT.tree_any_nan(x)) and not bool(JPT.tree_any_nan(jx))
    x["a/b"][1] = float("nan")
    jx["a"]["b"] = jx["a"]["b"].at[1].set(jnp.nan)
    assert bool(TPT.tree_any_nan(x)) and bool(JPT.tree_any_nan(jx))
    assert not bool(TPT.tree_any_nan({"c": x["c"]}))
    nested = {"b": {"y": 1, "x": 2}, "a": [3, {"z": 4}]}
    assert TPT.flatten_with_paths(nested) == {
        k: v for k, v in JPT.flatten_with_paths(nested).items()}
