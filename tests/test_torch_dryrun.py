"""The port's dry run (`repro_torch.launch.dryrun`, `configs/shapes.py`,
`launch/steps.train_state_shapes`) against the JAX package's, on the CPU.

  * `supports_shape`'s skip reasons and `input_specs`' shapes and dtypes
    for every arch × shape, against the reference's ``ShapeDtypeStruct``s
    (a decode cache's ``index`` holds a position a row in the port);
  * the meta train state's parameter count against ``tree_size`` of the
    reference's ``eval_shape`` of its init, for every arch;
  * `dryrun_one` over the reference's grid at full width: ``ok`` with a
    finite count, or the reference's skip reason. It needs no card and
    allocates nothing (the meta device). The reference's
    ``repro.launch.dryrun`` is not imported: it sets ``XLA_FLAGS`` when
    imported;
  * ``main``: a record; ``--step mhd`` for both exchanges on the 2×16×16
    mesh, whose booked exchange bytes equal their closed form for rank
    0's block of the public rows; ``--multi-pod``, ``--both-meshes`` and
    ``dryrun_one(multi_pod=True)`` counting rank 0 of the reference's
    meshes (they raised naming item 15c before the sharding within a pod
    was ported): gemma3-12b cut in depth, rank 0's FLOPs times the chips
    equal to the one-card count plus the reckoned repeated compute (the
    K/V projections, which each 'model' rank computes whole where its
    block of them would split a KV group), with a remainder of 0, and
    under ``"fsdp"`` with no term at all; ``--multi-pod --sharding
    fsdp`` on train_4k, whose batch the 512 ranks do not divide, with
    rank 0's FLOPs equal to one card's (every rank computes it whole);
  * the collective bytes of a reduced qwen2.5-32b train step on a 2×2
    mesh under ``"fsdp"`` in closed form.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import test_torch_threads
from repro.common.pytree import flatten_with_paths, tree_size
from repro.configs import arch_ids as jax_arch_ids
from repro.configs import get_config as jax_config
from repro.configs import shapes as JS
from repro.models.zoo import build_bundle as jax_bundle
from repro_torch.configs import arch_ids, get_config
from repro_torch.configs import shapes as TS
from repro_torch.launch import dryrun as DR
from repro_torch.launch.steps import train_state_shapes
from repro_torch.models import build_bundle
from repro_torch.models.layers import MetaDraw
from repro_torch.optim.optimizers import OptimizerConfig, make_optimizer

test_torch_threads.share_cores()

GRID = [(a, s) for a in arch_ids() for s in TS.INPUT_SHAPES]
# uncut on one CPU (PERF.md's dry-run table) every shape of these took
# under 3.5 s; the others are cut in depth to one repeat of each stage
# (every layer kind of the block, at full width), else the file passes
# 60 s on one worker (deepseek-v3's prefill alone took 33.6 s)
UNCUT = {"mamba2-370m", "minitron-4b"}


def depth_cut(arch: str):
    """``dryrun_one``'s overrides: one repeat of each stage (and one
    encoder layer), every width as published."""
    if arch in UNCUT:
        return None
    cfg = get_config(arch)
    stages = tuple(dataclasses.replace(st, repeats=1) for st in cfg.stages)
    cut = {"stages": stages,
           "num_layers": sum(len(st.block) for st in stages)}
    if cfg.encoder is not None:
        cut["encoder"] = dataclasses.replace(cfg.encoder, num_layers=1)
    return cut


def test_the_grid_is_the_reference_grid():
    assert arch_ids() == jax_arch_ids()
    assert {k: tuple(vars(v).values()) for k, v in TS.INPUT_SHAPES.items()
            } == {k: tuple(vars(v).values())
                  for k, v in JS.INPUT_SHAPES.items()}
    assert TS.LONG_CONTEXT_ARCHS == JS.LONG_CONTEXT_ARCHS


@pytest.mark.parametrize("arch", arch_ids())
def test_supports_shape_gives_the_reference_reasons(arch):
    for name, shape in TS.INPUT_SHAPES.items():
        assert TS.supports_shape(arch, get_config(arch), shape) == \
            JS.supports_shape(arch, jax_config(arch), JS.INPUT_SHAPES[name])


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", arch_ids())
def test_input_specs_match_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    for name, shape in TS.INPUT_SHAPES.items():
        if TS.supports_shape(arch, cfg, shape):
            continue
        got = TS.input_specs(cfg, name)
        ref = JS.input_specs(jcfg, name)
        caches = got.pop("caches", None)
        ref_caches = ref.pop("caches", None)
        assert {k: (tuple(v.shape), _dtype(v), v.device.type)
                for k, v in got.items()} == \
            {k: (tuple(v.shape), _dtype(v), "meta") for k, v in ref.items()}
        if caches is None:
            continue
        ref_flat = flatten_with_paths(ref_caches)
        assert set(caches) == set(ref_flat), (arch, name)
        B = shape.global_batch
        for k, v in caches.items():
            r = ref_flat[k]
            if k.endswith("index"):
                # a position a row: (B,) at the top, (R, B) in a stage
                assert tuple(v.shape) == tuple(r.shape) + (B,), k
            else:
                assert (tuple(v.shape), _dtype(v)) == \
                    (tuple(r.shape), str(r.dtype)), k


@pytest.mark.parametrize("arch", arch_ids())
def test_meta_train_state_counts_the_reference_params(arch):
    import torch

    opt = make_optimizer(OptimizerConfig(name="sgd_momentum", init_lr=0.1,
                                         total_steps=60_000,
                                         state_dtype="bfloat16"))
    state = train_state_shapes(build_bundle(get_config(arch),
                                            dtype=torch.bfloat16), opt)
    ref = jax.eval_shape(jax_bundle(jax_config(arch)).init,
                         jax.random.PRNGKey(0))
    assert sum(v.numel() for v in state["params"].values()) == \
        tree_size(ref)
    assert {v.device.type for v in state["params"].values()} == {"meta"}
    assert {v.dtype for v in state["opt"]["momentum"].values()} == \
        {torch.bfloat16}
    assert state["step"] == 0


@pytest.mark.parametrize("arch,shape", GRID,
                         ids=[f"{a}-{s}" for a, s in GRID])
def test_dryrun_one_counts_or_skips_as_the_reference(arch, shape):
    rec = DR.dryrun_one(arch, shape, overrides=depth_cut(arch),
                        verbose=False)
    assert (rec["mesh"], rec["chips"]) == ("1", 1)
    skip = JS.supports_shape(arch, jax_config(arch), JS.INPUT_SHAPES[shape])
    if skip:
        assert rec == {**rec, "status": "skip", "skip_reason": skip}
        return
    assert rec["status"] == "ok", rec
    cost = rec["hlo_cost"]
    assert cost["flops"] > 0 and cost["bytes"] > 0
    assert cost["flops"] == pytest.approx(
        cost["flops_f32"] + cost["flops_tf32x3"] + cost["flops_bf16"])
    assert cost["collective_total"] == 0  # one card
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] > 0 and \
        mem["temp_size_in_bytes"] > 0
    # the train state's params in bf16 are among the arguments
    if rec["mode"] == "train":
        assert mem["argument_size_in_bytes"] >= 2 * 2 * rec["num_params"]
    rep = DR.report(rec)  # priced at the published config's 6·N·D
    assert rep.dominant in ("compute", "memory")
    assert np.isfinite(rep.compute_s) and rep.compute_s > 0
    json.dumps(rec)


def _exchange_bytes(cfg, exchange: str, k: int = 32) -> int:
    """The bytes rank 0 of the 2×16×16 mesh sends its partner in one pod
    step, in closed form: its block of the public rows — the B_pub·(T−1)
    positions split over 'data' (one sequence of T−1 = 4,095 rows), then
    over 'model' (the first 4,095 mod 16 = 15 blocks a row longer: 256)
    — of every head (main + aux) as bf16 logits, or their top-k values
    (bf16) and indices (int32) with an f32 lse a row and head; plus the
    rows' bf16 embeddings."""
    T = TS.INPUT_SHAPES["train_4k"].seq_len
    data, model = 16, 16
    per_data = DR.MHD_PUBLIC // data * (T - 1)
    rows = per_data // model + (1 if per_data % model else 0)
    heads = 1 + cfg.num_aux_heads
    emb = rows * cfg.d_model * 2
    if exchange == "full":
        return rows * cfg.vocab_size * heads * 2 + emb
    return rows * k * (2 + 4) * heads + rows * heads * 4 + emb


@pytest.mark.parametrize("mode", ["record", "mhd", "multi_device"])
def test_main_writes_a_record_in_each_mode(
        mode, tmp_path, monkeypatch):
    """``main`` writes a record; ``--step mhd`` writes one for each
    exchange, gemma3-12b cut in depth (the exchange does not depend on
    it), whose booked collective-permute bytes are the closed form and
    ``topk``'s the smaller; ``--multi-pod`` / ``--both-meshes`` /
    ``dryrun_one(multi_pod=True)`` count rank 0 of the reference's meshes
    (`test_mesh_counts_reckon_the_repeated_compute`)."""
    if mode == "record":
        assert DR.main(["--arch", "mamba2-370m", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
        rec = json.loads((tmp_path / "mamba2-370m__decode_32k__1.json")
                         .read_text())
        assert rec["status"] == "ok" and rec["mode"] == "decode"
    elif mode == "mhd":
        cut = dataclasses.replace(get_config("gemma3-12b"),
                                  **depth_cut("gemma3-12b"))
        monkeypatch.setattr(DR, "get_config", lambda arch: cut)
        sent = {}
        for exchange in ("full", "topk"):
            assert DR.main(["--step", "mhd", "--exchange", exchange,
                            "--out", str(tmp_path)]) == 0
            rec = json.loads((tmp_path / f"mhd_{exchange}__gemma3-12b__"
                              f"train_4k.json").read_text())
            assert rec["status"] == "ok" and rec["mode"] == "mhd_train"
            assert (rec["mesh"], rec["chips"]) == ("2x16x16-mhd", 512)
            assert rec["exchange"] == exchange and rec["topk"] == 32
            coll = rec["collective_bytes_raw"]
            sent[exchange] = coll["collective-permute"]
            assert sent[exchange] == _exchange_bytes(cut, exchange)
            # the tensor-parallel and FSDP collectives within the pod
            for kind in ("all-gather", "reduce-scatter", "all-reduce",
                         "all-to-all"):
                assert coll[kind] > 0, kind
            assert coll["total"] == sum(v for k, v in coll.items()
                                        if k != "total")
            assert rec["num_params"] == 2 * sum(
                v.numel() for v in build_bundle(cut).init(
                    MetaDraw().manual_seed(0)).values())
            for kernel in ("dist_ce_fwd", "dist_ce_bwd", "emb_dist_fwd"):
                assert rec["kernels"][kernel]["calls"] > 0, kernel
            assert ("topk_wire" in rec["kernels"]) == (exchange == "topk")
        assert sent["topk"] < sent["full"]
    else:
        cut = dataclasses.replace(get_config("gemma3-12b"),
                                  **depth_cut("gemma3-12b"))
        monkeypatch.setattr(DR, "get_config", lambda arch: cut)
        for argv, meshes in ((["--multi-pod"], ["2x16x16"]),
                             (["--both-meshes"], ["16x16", "2x16x16"])):
            assert DR.main(argv + ["--arch", "gemma3-12b", "--shape",
                                   "train_4k", "--out", str(tmp_path)]) == 0
            for mesh in meshes:
                rec = json.loads((tmp_path / f"gemma3-12b__train_4k__"
                                  f"{mesh}.json").read_text())
                assert rec["status"] == "ok" and rec["mesh"] == mesh
                assert rec["chips"] == DR.MESHES[mesh][0]
                assert rec["sharding"] == "tp"
                assert rec["collective_bytes_raw"]["total"] > 0
        rec = DR.dryrun_one("gemma3-12b", "train_4k", multi_pod=True,
                            verbose=False)
        assert (rec["mesh"], rec["chips"]) == ("2x16x16", 512)

def _kv_projection_flops(cfg, tokens: int) -> float:
    """The one-card K/V projections' products over every attention
    layer: forward 2·N·D·KV·hd each for k and v, run twice under the
    unit's remat, and the backward's two products each."""
    n_attn = sum(st.repeats * sum(sp.attn in ("full", "swa")
                                  for sp in st.block) for st in cfg.stages)
    kv = cfg.num_kv_heads * cfg.resolved_head_dim
    fwd = 2.0 * tokens * cfg.d_model * kv * 2
    return n_attn * (fwd * (2 if cfg.remat != "none" else 1) + 2 * fwd)


def test_mesh_counts_reckon_the_repeated_compute(monkeypatch):
    """Rank 0 of the 16×16 and 2×16×16 meshes against one card, gemma3-12b
    cut in depth (16 heads, 8 KV heads, d_ff 15,360 and a vocabulary of
    262,144 that 'model' divides): under ``"tp"`` every product runs on
    1/|model| of the work but the K/V projections, which each model rank
    computes whole for its query heads' groups (8 KV heads do not divide
    over 16 ranks), so rank 0's FLOPs × chips = the one-card count +
    15 × those projections; under ``"fsdp"`` every rank computes the whole
    model on its tokens, so × chips = the one-card count. Remainder 0."""
    cut = dataclasses.replace(get_config("gemma3-12b"),
                              **depth_cut("gemma3-12b"))
    monkeypatch.setattr(DR, "get_config", lambda arch: cut)
    one = DR.dryrun_one("gemma3-12b", "train_4k", verbose=False)
    shape = TS.INPUT_SHAPES["train_4k"]
    kv = _kv_projection_flops(cut, shape.global_batch * shape.seq_len)
    for mesh, sharding, repeated in (("16x16", "tp", 15 * kv),
                                     ("2x16x16", "tp", 15 * kv),
                                     ("16x16", "fsdp", 0.0)):
        rec = DR.dryrun_one("gemma3-12b", "train_4k", mesh=mesh,
                            sharding=sharding, verbose=False)
        chips = DR.MESHES[mesh][0]
        remainder = rec["hlo_cost"]["flops"] * chips - (
            one["hlo_cost"]["flops"] + repeated)
        assert remainder == 0, (mesh, sharding, remainder)
        # each rank holds its blocks: the arguments shrink
        assert rec["memory"]["argument_size_in_bytes"] < \
            one["memory"]["argument_size_in_bytes"] / 64


def test_multi_pod_fsdp_runs_a_batch_its_ranks_do_not_divide(
        monkeypatch, tmp_path):
    """``--multi-pod --sharding fsdp`` counts train_4k, whose 256
    sequences do not split over the 2×16×16 mesh's 512 token shards:
    every rank computes the whole batch, as the reference's batch
    sharding replicates it, so rank 0's FLOPs equal the one-card count
    (gemma3-12b cut in depth). The MoE archs count the same case
    (arctic-480b and deepseek-v3 cut in depth): outside the expert region
    every rank computes the whole batch, and the expert-parallel region
    takes rank 0's block of the 256 · 4,096 tokens itself, so rank 0's
    FLOPs lie below one card's, and the region's all-to-alls are
    booked."""
    cut = dataclasses.replace(get_config("gemma3-12b"),
                              **depth_cut("gemma3-12b"))
    monkeypatch.setattr(DR, "get_config", lambda arch: cut)
    one = DR.dryrun_one("gemma3-12b", "train_4k", verbose=False)
    assert DR.main(["--multi-pod", "--sharding", "fsdp", "--arch",
                    "gemma3-12b", "--shape", "train_4k", "--out",
                    str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "gemma3-12b__train_4k__2x16x16.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["sharding"] == "fsdp"
    assert (rec["mesh"], rec["chips"]) == ("2x16x16", 512)
    assert rec["hlo_cost"]["flops"] == one["hlo_cost"]["flops"]
    assert rec["collective_bytes_raw"]["total"] > 0
    for arch in ("arctic-480b", "deepseek-v3-671b"):
        moe = dataclasses.replace(get_config(arch), **depth_cut(arch))
        monkeypatch.setattr(DR, "get_config", lambda a, moe=moe: moe)
        one = DR.dryrun_one(arch, "train_4k", verbose=False)
        assert DR.main(["--multi-pod", "--sharding", "fsdp", "--arch", arch,
                        "--shape", "train_4k", "--out", str(tmp_path)]) == 0
        rec = json.loads((tmp_path / f"{arch}__train_4k__2x16x16.json")
                         .read_text())
        assert rec["status"] == "ok" and rec["sharding"] == "fsdp", arch
        assert (rec["mesh"], rec["chips"]) == ("2x16x16", 512)
        assert 0 < rec["hlo_cost"]["flops"] < one["hlo_cost"]["flops"]
        assert rec["collective_bytes_raw"]["all-to-all"] > 0, arch


def test_fsdp_collective_bytes_in_closed_form():
    """A reduced qwen2.5-32b train step (no remat, the dense loss) as rank
    0 of a 2×2 (data, model) mesh under ``"fsdp"``, counted on meta:
    every leaf cut on both axes is gathered whole where it is used, once
    (its block, S/4, along 'data', then S/2 along 'model': ¾ S all-gathered
    for its S bytes) and its gradient reduce-scattered back (S along
    'model', then S/2: 1½ S); a leaf cut on 'model' only (the q/k/v
    biases) all-gathers S/2, reduce-scatters S and all-reduces its block
    S/2 over 'data'; a whole leaf all-reduces its gradient, S, over both
    axes; the metrics (loss, ce, aux_loss in f32) all-reduce 12 bytes.
    The aux heads, which the dense loss forms and nothing reads, have no
    backward to reduce-scatter (their gradient is zero)."""
    from repro_torch.common.sharding import use_mesh
    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.shardings import (apply_sharding_strategy,
                                              partition_specs)
    from repro_torch.launch.steps import make_train_step
    from repro_torch.roofline.op_cost import OpCounter

    cfg = get_reduced("qwen2.5-32b")
    assert cfg.remat == "none" and cfg.loss_impl == "dense"
    bundle = build_bundle(cfg)
    opt = make_optimizer(OptimizerConfig(name="sgd_momentum", init_lr=0.1,
                                         total_steps=10))
    whole = bundle.init(MetaDraw().manual_seed(0))
    sizes = {"data": 2, "model": 2}
    specs = partition_specs(whole, sizes)
    want = {"all-gather": 0.0, "reduce-scatter": 0.0, "all-reduce": 12.0}
    for k, v in whole.items():
        S = v.numel() * v.element_size()
        used = [e for e in specs.get(k, ()) if e is not None]
        if len(used) == 2:
            want["all-gather"] += 0.75 * S
            want["reduce-scatter"] += 1.5 * S * (k != "aux_heads")
        elif used == ["model"]:
            want["all-gather"] += 0.5 * S
            want["reduce-scatter"] += S
            want["all-reduce"] += 0.5 * S
        else:
            assert not used, k
            want["all-reduce"] += S
    apply_sharding_strategy("fsdp")
    try:
        with DR.fake_group(4):
            mesh = make_test_mesh((2, 2), ("data", "model"), "cpu")
            with use_mesh(mesh):
                state = train_state_shapes(bundle, opt)
                batch = {"tokens": torch.empty((8, 64), dtype=torch.int32,
                                               device="meta")}
                with OpCounter(args=(state, batch)) as counter:
                    make_train_step(bundle, opt)(state, batch)
    finally:
        apply_sharding_strategy("tp")
    assert counter.coll == want
