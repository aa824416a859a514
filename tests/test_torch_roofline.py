"""The port's cost counter and roofline (`repro_torch.roofline`) against
the JAX package's (`repro.roofline`), on the CPU.

  * the reference's pure-Python parts, exactly: `active_params`,
    `model_flops` for every config of ``arch_ids()``,
    `roofline_from_artifacts` on the same inputs and the same card;
  * the counter's own cases (tests/test_roofline.py's and
    test_perf_paths.py::test_hlo_cost_fusion_slice_awareness's on the
    port): a product's FLOPs exact, a loop of n layers n times, an
    elementwise op's bytes by hand, views 0, a broadcast operand once, a
    collective's bytes, each kernel's cost at the PERF.md §6 shapes;
  * one step counts the same on the CPU and on meta, exactly, for a
    reduced ResNet (its distill update: dist_ce and emb_dist), Mamba2,
    attention, MoE and MLA train step;
  * a train step's matrix-product FLOPs against the reference's
    ``analyze_to_dict`` of its jitted ``make_train_step``, with every
    difference reckoned: the kernels count the (query, key) pairs inside
    the mask where the reference's CPU form is dense, the port's dense
    loss forms the aux heads the reference's jit drops, and the
    reference's Mamba2 scan is einsums (its products taken from its own
    ``ssd_chunked``, compiled alone) where the port's is a kernel.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_threads
from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.launch.steps import make_train_step as jax_train_step
from repro.launch.steps import train_state_shapes as jax_state_shapes
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro.models.zoo import build_bundle as jax_bundle
from repro.optim.optimizers import OptimizerConfig as JaxOptConfig
from repro.optim.optimizers import make_optimizer as jax_optimizer
from repro.roofline import analysis as JRA
from repro.roofline.hlo_cost import analyze_to_dict as jax_analyze
from repro_torch.configs import arch_ids, get_config, get_reduced
from repro_torch.core.mhd import MHDConfig
from repro_torch.core.runtime import distill_update, meta_like
from repro_torch.kernels import dist_ce as DCE
from repro_torch.kernels import emb_dist as EMB
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.kernels import topk_wire as TOPK
from repro_torch.launch.steps import make_train_step, train_state_shapes
from repro_torch.models import build_bundle
from repro_torch.models.layers import MetaDraw
from repro_torch.optim.optimizers import OptimizerConfig, make_optimizer
from repro_torch.roofline import analysis as RA
from repro_torch.roofline import op_cost

test_torch_threads.share_cores()

META = torch.device("meta")


def _bound_ms(cost, hw=RA.H100):
    flops, nbytes = cost
    return max(nbytes / hw.hbm_bw, hw.compute_s(
        {f"flops_{k}": v for k, v in flops.items()})) * 1e3


# -- the reference's pure-Python parts ---------------------------------------


@pytest.mark.parametrize("arch", arch_ids())
def test_active_params_and_model_flops_match_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    n = sum(v.numel() for v in build_bundle(cfg).init(
        MetaDraw().manual_seed(0)).values())
    assert RA.active_params(cfg, n) == JRA.active_params(jcfg, n)
    for tokens, mode in ((256 * 4096, "train"), (128, "decode")):
        assert RA.model_flops(cfg, n, tokens, mode) == \
            JRA.model_flops(jcfg, n, tokens, mode)


@pytest.mark.parametrize("case", ["compute", "memory", "collective"])
def test_roofline_from_artifacts_matches_the_reference(case):
    """The same inputs and the same card (the reference's own spec's
    numbers, handed to the port's `HardwareSpec`): the same report."""
    costs = {"compute": (1e15, 1e12, 1e9), "memory": (1e12, 1e13, 0.0),
             "collective": (1e12, 1e11, 1e12)}
    flops, nbytes, coll = costs[case]
    hw = RA.HardwareSpec(**dataclasses.asdict(JRA.V5E))
    kw = dict(cost={"flops": flops, "bytes accessed": nbytes},
              collectives={"total": coll},
              memory={"argument_size_in_bytes": 1e9,
                      "temp_size_in_bytes": 2e9,
                      "output_size_in_bytes": 3e8},
              total_params=32e9, tokens=256 * 4096, mode="train")
    got = RA.roofline_from_artifacts(
        "qwen2.5-32b", "train_4k", "16x16", 256,
        cfg=get_config("qwen2.5-32b"), hw=hw, **kw)
    ref = JRA.roofline_from_artifacts(
        "qwen2.5-32b", "train_4k", "16x16", 256,
        cfg=jax_config("qwen2.5-32b"), hw=JRA.V5E, **kw)
    assert got.to_row() == ref.to_row()
    assert got.dominant == case
    assert RA.format_table([got]) == JRA.format_table([ref])


def test_typed_flops_take_their_own_peaks():
    hw = RA.H100
    cost = {"flops": 6e12, "flops_f32": 1e12, "flops_tf32x3": 2e12,
            "flops_bf16": 3e12, "bytes": 1e9}
    assert hw.compute_s(cost) == pytest.approx(
        1e12 / 67e12 + 3 * 2e12 / 495e12 + 3e12 / 989e12)
    assert hw.compute_s({"flops": 6e12}) == pytest.approx(6e12 / 67e12)
    assert hw.attainable_flops_per_s(cost) == pytest.approx(
        6e12 / hw.compute_s(cost))


# -- the counter's own cases --------------------------------------------------


def test_product_flops_exact_and_typed():
    a = torch.empty(64, 128, device=META)
    b = torch.empty(128, 32, device=META)
    _, c = op_cost.count(lambda a, b: a @ b, a, b)
    assert c.flops == {"f32": 2 * 64 * 128 * 32, "tf32x3": 0, "bf16": 0}
    _, c = op_cost.count(lambda a, b: a @ b, a.bfloat16(), b.bfloat16())
    assert c.flops["bf16"] == 2 * 64 * 128 * 32 and c.flops["f32"] == 0
    x = torch.empty(2, 3, 16, 16, device=META)
    w = torch.empty(8, 3, 3, 3, device=META)
    _, c = op_cost.count(lambda x, w: torch.nn.functional.conv2d(x, w), x, w)
    assert c.total_flops == 2 * 2 * 8 * 14 * 14 * 3 * 3 * 3


@pytest.mark.parametrize("n", [1, 10])
def test_a_loop_of_n_layers_counts_n_times(n):
    w = torch.empty(64, 64, device=META)
    x = torch.empty(64, 64, device=META)

    def f(w, x):
        for _ in range(n):
            x = torch.tanh(x @ w)
        return x

    _, c = op_cost.count(f, w, x)
    assert c.total_flops == 2 * 64 ** 3 * n
    # each layer: the product reads 2 and writes 1, the tanh 1 and 1
    assert c.bytes == n * 5 * 64 * 64 * 4


def test_elementwise_bytes_views_and_broadcasts():
    x = torch.empty(1024, 1024, device=META)
    row = torch.empty(1, 1024, device=META)
    _, c = op_cost.count(lambda x: x * 2.0 + 1.0, x)
    assert c.bytes == 2 * (4 * 2 ** 20 * 2)  # two ops, each a read + write
    _, c = op_cost.count(lambda x: x.reshape(-1)[:10].view(2, 5).t(), x)
    assert c.bytes == 0 and c.total_flops == 0
    # the broadcast row counts its 1024 elements, not 1024 × 1024
    _, c = op_cost.count(lambda x, r: x + r.expand(1024, 1024), x, row)
    assert c.bytes == 4 * (2 ** 20 + 1024 + 2 ** 20)


def test_slice_reads_count_the_slice():
    """test_hlo_cost_fusion_slice_awareness on the port: reading one layer
    of a stacked (10, 256, 256) weight moves that layer's bytes, not the
    stack's."""
    stack = torch.empty(10, 256, 256, device=META)
    x = torch.empty(8, 256, device=META)

    def f(stack, x):
        for w in stack.unbind(0):
            x = x @ w
        return x

    _, c = op_cost.count(f, stack, x)
    assert c.bytes == 10 * 4 * (256 * 256 + 2 * 8 * 256)
    assert c.total_flops == 10 * 2 * 8 * 256 * 256


def test_peak_memory_tracks_what_the_step_holds():
    x = torch.empty(1024, 1024, device=META)

    def f(x):
        a = x * 2  # 4 MiB held
        b = a + 1  # 8 MiB held
        del a
        return b * 3  # 4 MiB freed, 4 MiB made: 8 MiB

    _, c = op_cost.count(f, x)
    assert c.peak_bytes == 2 * 4 * 2 ** 20


def test_collectives_are_booked_by_kind(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                            world_size=1, rank=0)
    try:
        x = torch.ones(10)
        _, c = op_cost.count(lambda x: dist.all_reduce(x), x)
        d = c.to_dict()
        assert d["collective_all-reduce"] == 40.0
        assert d["collective_total"] == 40.0 and d["bytes"] == 0
    finally:
        dist.destroy_process_group()


# each kernel's cost at a PERF.md §6 shape: (GFLOP of the function, the
# table's bound in ms as the table writes it)
KERNEL_TABLE = [
    ("flash fwd (8, 512, 32, 112) causal", FA.cost_fwd(
        8, 512, 512, 32, 32, 112, True, 0, 4), 15.06, "0.0913"),
    ("flash bwd (8, 512, 32, 112) causal", FA.cost_bwd(
        8, 512, 512, 32, 32, 112, True, 0, 4), 37.65, "0.2282"),
    ("flash fwd arctic (8, 512, 56, 8, 128)", FA.cost_fwd(
        8, 512, 512, 56, 8, 128, True, 0, 4), 30.12, "0.1826"),
    ("flash fwd whisper encoder", FA.cost_fwd(
        4, 1500, 1500, 20, 20, 64, False, 0, 4), 46.08, "0.2793"),
    ("flash bwd whisper encoder", FA.cost_bwd(
        4, 1500, 1500, 20, 20, 64, False, 0, 4), 115.2, "0.6982"),
    ("ssd fwd (8, 512, 32, 64, N 128)", SSD.cost_fwd(8, 512, 32, 64, 128),
     4.874, "0.0295"),
    ("ssd bwd (8, 512, 32, 64, N 128)", SSD.cost_bwd(8, 512, 32, 64, 128),
     9.787, "0.0593"),
    ("ssd fwd zamba2 (8, 512, 112, 64, N 64)", SSD.cost_fwd(
        8, 512, 112, 64, 64), None, "0.0757"),
    ("topk 12,288 × 50,280 k 8", TOPK.cost(12288, 50280, 8), None, "0.738"),
    ("dist_ce fwd 2,048 × 50,280 bf16", DCE.cost_fwd(2048, 50280, 2), None,
     "0.184"),
    ("dist_ce bwd 2,048 × 50,280 bf16", DCE.cost_bwd(2048, 50280, 2), None,
     "0.246"),
    ("emb_dist fwd 32 × 512", EMB.cost_fwd(32, 512), None, "0.000039"),
    ("emb_dist bwd 32 × 512", EMB.cost_bwd(32, 512), None, "0.000059"),
]


@pytest.mark.parametrize("case", KERNEL_TABLE, ids=[c[0] for c in KERNEL_TABLE])
def test_kernel_costs_give_the_perf_table(case):
    _, cost, gflop, bound = case
    if gflop is not None:
        got = sum(cost[0].values()) / 1e9
        assert round(got, 2 if gflop < 100 else 1) == round(
            gflop, 2 if gflop < 100 else 1)
    # the bound to the digits the table writes
    digits = len(bound.split(".")[1])
    assert round(_bound_ms(cost), digits) == pytest.approx(float(bound))


# -- the same step on the CPU and on meta ------------------------------------


def _lm_step(cfg, tokens):
    """(step, args) of the launcher's train step on ``cfg``, params drawn
    on the CPU."""
    opt = make_optimizer(OptimizerConfig(name="sgd_momentum", init_lr=0.1,
                                         total_steps=10))
    bundle = build_bundle(cfg)
    params = bundle.init(torch.Generator().manual_seed(0))
    state = {"params": params, "opt": opt.init(params), "step": 0}
    batch = {"tokens": torch.from_numpy(tokens)}
    return make_train_step(bundle, opt), (state, batch)


def _resnet_distill():
    """(step, args) of a reduced ResNet client's distill update with Δ = 2
    teachers (dist_ce and emb_dist forward and backward)."""
    cfg = get_reduced("resnet18-imagenet")
    bundle = build_bundle(cfg)
    opt = make_optimizer(OptimizerConfig(name="sgd_momentum", init_lr=0.1,
                                         total_steps=10))
    params = bundle.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    B, V, E, H = 4, cfg.num_classes, cfg.embed_dim, cfg.num_aux_heads
    priv = {"images": torch.randn(B, 8, 8, 3, generator=g),
            "labels": torch.randint(0, V, (B,), generator=g)}
    pub = {"images": torch.randn(B, 8, 8, 3, generator=g)}
    teachers = {"embedding": torch.randn(2, B, E, generator=g),
                "logits": torch.randn(2, B, V, generator=g),
                "aux_logits": torch.randn(2, H, B, V, generator=g)}
    mhd = MHDConfig(nu_emb=1.0, nu_aux=1.0, num_aux_heads=H, delta=2)

    def step(params, opt_state, priv, pub, teachers):
        return distill_update(bundle, opt, mhd, params, opt_state, priv,
                              pub, teachers, 0)

    return step, (params, opt.init(params), priv, pub, teachers)


def _tokens(cfg, B=2, T=64):
    return np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)


STEPS = {
    "resnet": _resnet_distill,
    "mamba2": lambda: _lm_step(get_reduced("mamba2-370m"),
                               _tokens(get_reduced("mamba2-370m"))),
    "attention": lambda: _lm_step(get_reduced("gemma3-12b"),
                                  _tokens(get_reduced("gemma3-12b"))),
    "moe": lambda: _lm_step(get_reduced("arctic-480b"),
                            _tokens(get_reduced("arctic-480b"))),
    "mla": lambda: _lm_step(get_reduced("deepseek-v3-671b"),
                            _tokens(get_reduced("deepseek-v3-671b"))),
}


@pytest.mark.parametrize("name", sorted(STEPS))
def test_a_step_counts_the_same_on_the_cpu_and_on_meta(name):
    step, args = STEPS[name]()
    _, cpu = op_cost.count(step, *args)
    step, args = STEPS[name]()
    _, meta = op_cost.count(step, *meta_like(args))
    assert cpu.to_dict() == meta.to_dict()
    assert cpu.kernels == meta.kernels
    assert cpu.ops == meta.ops
    assert cpu.to_dict()["flops"] > 0
    # MLA is torch products, as the reference's einsums: no kernel
    assert bool(cpu.kernels) == (name != "mla")


def test_counting_leaves_the_cpu_numbers_alone():
    """A counted CPU step (its kernels on the counted route) gives the
    values of an uncounted one."""
    outs = []
    for counting in (False, True):
        step, (state, batch) = STEPS["attention"]()
        if counting:
            (new, metrics), _ = op_cost.count(step, state, batch)
        else:
            new, metrics = step(state, batch)
        outs.append((new["params"], metrics["loss"]))
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=0, atol=0)
    for k in outs[0][0]:
        torch.testing.assert_close(outs[0][0][k], outs[1][0][k], rtol=1e-6,
                                   atol=1e-7)


def test_topk_wire_counts_the_same_on_the_cpu_and_on_meta():
    x = torch.randn(48, 100, generator=torch.Generator().manual_seed(0))
    got = [op_cost.count(lambda x: ops.topk_wire(x, 5), t)[1]
           for t in (x, x.to(META))]
    assert got[0].to_dict() == got[1].to_dict()
    assert got[0].kernels == {"topk_wire": {
        "calls": 1.0, "flops": 3.0 * 48 * 100,
        "bytes": float(48 * 100 * 4 + 48 * 5 * 8 + 48 * 4)}}
    vals, idx, lse = ops.topk_wire(x.to(META), 5)
    assert (vals.shape, idx.dtype, lse.shape) == ((48, 5), torch.int32,
                                                  (48,))


# -- matrix-product FLOPs against the reference ------------------------------


def _reference_flops(arch: str, tokens: np.ndarray) -> float:
    jcfg = jax_reduced(arch)
    bundle = jax_bundle(jcfg)
    opt = jax_optimizer(JaxOptConfig(name="sgd_momentum", init_lr=0.1,
                                     total_steps=10))
    state = jax_state_shapes(bundle, opt)
    batch = {"tokens": jax.ShapeDtypeStruct(tokens.shape, jnp.int32)}
    step = jax_train_step(bundle, opt)
    hlo = jax.jit(lambda s, b: step(s, b)[0]).lower(
        state, batch).compile().as_text()
    return jax_analyze(hlo)["flops"]


def _reference_ssd_flops(Bt, T, H, P, N, L) -> float:
    """The reference's Mamba2 scan products: its ``ssd_chunked`` forward
    and the gradients of all six inputs from an upstream gradient of y,
    compiled alone (y returned, as the model reads it; the gradient an
    input, not a constant, which XLA would fold into reductions)."""
    f32 = jnp.float32
    args = [jax.ShapeDtypeStruct(s, f32) for s in
            ((Bt, T, H, P), (Bt, T, H, P), (Bt, T, H), (H,), (Bt, T, N),
             (Bt, T, N), (H,))]

    def fwd_bwd(dy, *a):
        y, vjp = jax.vjp(lambda *x: jax_ssd_chunked(*x, chunk_size=L)[0],
                         *a)
        return y, vjp(dy)

    return jax_analyze(jax.jit(fwd_bwd).lower(*args).compile().as_text()
                       )["flops"]


def _port_count(arch: str, tokens: np.ndarray):
    cfg = get_reduced(arch)
    opt = make_optimizer(OptimizerConfig(name="sgd_momentum", init_lr=0.1,
                                         total_steps=10))
    bundle = build_bundle(cfg)
    state = train_state_shapes(bundle, opt)
    batch = {"tokens": torch.from_numpy(tokens).to(META)}
    _, c = op_cost.count(make_train_step(bundle, opt), state, batch)
    return cfg, c


def _layers(cfg):
    return [(spec, st.repeats) for st in cfg.stages for spec in st.block]


@pytest.mark.parametrize("arch", ["gemma3-12b", "mamba2-370m",
                                  "arctic-480b"])
def test_matmul_flops_match_the_reference_up_to_reckoned_terms(arch):
    tokens = _tokens(get_reduced(arch))
    B, T = tokens.shape
    cfg, c = _port_count(arch, tokens)
    ref = _reference_flops(arch, tokens)
    port_products = c.flops["f32"] + c.flops["bf16"]
    D, V = cfg.d_model, cfg.vocab_size
    # the port's dense loss forms the aux heads (forward only: nothing
    # reads them); the reference's jit drops them
    port_only = 2.0 * cfg.num_aux_heads * B * T * D * V
    ref_only = 0.0
    kernel_flops = 0.0
    for spec, n in _layers(cfg):
        if spec.attn in ("full", "swa"):
            H, d = cfg.num_heads, cfg.head_dim
            window = cfg.window_size if spec.attn == "swa" else 0
            # the reference's dense scores: q·kᵀ and p·v over every
            # (query, key) entry, forward 2 products, backward 4
            ref_only += n * 12.0 * B * H * T * T * d
            pairs = FA.attn_pairs(T, T, True, window) * B * H
            kernel_flops += n * 14.0 * pairs * d
        elif spec.attn == "mamba2":
            m = cfg.mamba
            H, P = m.num_heads(D), m.head_dim
            ref_only += n * _reference_ssd_flops(B, T, H, P, m.d_state,
                                                 m.chunk_size)
            kernel_flops += n * sum(
                SSD.cost_fwd(B, T, H, P, m.d_state, True)[0].values()) + \
                n * sum(SSD.cost_bwd(B, T, H, P, m.d_state)[0].values())
    assert c.flops["tf32x3"] == pytest.approx(kernel_flops, rel=1e-12)
    remainder = ref - (port_products - port_only + ref_only)
    assert remainder == 0, (ref, port_products, port_only, ref_only)
