#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one H100.

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero, printing no result, without one. Run
from the root of a checkout: it builds every kernel from the sources in
the checkout (into ``build/``), then

  1. prints the card's name and power limit and the TF32 settings (both
     off: every comparison below is in full float32);
  2. builds the CUDA kernels (one nvcc per source, started together);
  3. holds each kernel — topk_wire, dist_ce forward and backward, emb_dist
     forward and backward, ssd_scan forward and backward, flash_attention
     forward and backward — against its plain PyTorch version on the card,
     at the main paths' shapes and at edge cases, and times kernel, plain
     version and one library yardstick with CUDA events (median of
     repeated calls), and the launch floor (a one-element fill's device
     time under the profiler);
  4. checks the fused wire encodes on the card byte for byte against the
     host: the fixed top-k frame at the ResNet path's shape against the
     numpy host path, the adaptive delta-compressed frame at the LM path's
     against the same encoder on CPU tensors (the plain topk_wire there;
     its entropy and budget allocation are held against the JAX package
     by tests/test_torch_lm_wire.py) — and the Eq. 1 loss with its
     gradients on the kernels against the plain path on the CPU;
  5. drives the ResNet path through the user's entry points: K=3
     ResNet-18 clients (width 64, 1000 classes, 4 aux heads) exchanging
     top-k predictions, 12 steps and one evaluate(), then one profiled
     publish round;
  6. drives the experiment API (`repro_torch.exp`): (a) the same fleet as
     an ExperimentSpec through Experiment(spec).run(), 12 steps with a
     checkpoint every 6 (the launch counts set to 0 just before and read
     just after; topk_wire, dist_ce and emb_dist must launch); (b) step
     6's checkpoint restored into a fresh adapter, bitwise, its pools
     reseeded at step 6, then steps 6-11; (c) FedAvg, FedMD and supervised
     pooled and separate at full width, 4 steps each, FedAvg's average
     held against the float64 mean; (d) examples/port_quickstart.py's spec
     (400 steps), whose best aux head must beat the main head in β_sh;
  7. drives the LM path: K=3 full-width, full-depth mamba2-370m clients
     (48 layers, d_model 1024, vocab 50280, 2 aux heads) exchanging
     entropy-adaptive, delta-compressed next-token predictions, 12 steps
     and one evaluate(), then one profiled publish round;
  8. drives the hybrid path the same way: K=3 full-width zamba2-7b
     clients (d_model 3584, Mamba2 with the shared attention block and the
     dense FFN every 6th layer, vocab 32000) cut in depth to one period of
     six layers. Every kernel's launch count is set to 0 just before each
     path and read just after;
  9. prints one ``{"kernels": [...]}`` line and, last, the device line
     ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and never prints
the last line. The full record also goes to ``chiprun_out/chip_smoke.json``
and the profiles' tables to ``chiprun_out/profile_{resnet,lm,zamba2}.txt``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.comm import (CommConfig, LoopbackTransport, TopKCodec,  # noqa: E402
                              frame_overhead_nbytes, make_codec,
                              topk_frame_nbytes)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (DecentralizedTrainer, MHDConfig,  # noqa: E402
                              RunConfig, complete_graph, mhd_total_loss)
from repro_torch import data  # noqa: E402
from repro_torch import exp as EXP  # noqa: E402
from repro_torch import lm  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import dist_ce as DCE  # noqa: E402
from repro_torch.kernels import emb_dist as EMB  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.kernels import topk_wire as TOPK  # noqa: E402
from repro_torch.checkpoint.io import (load_pytree,  # noqa: E402
                                       params_from_jax, params_to_jax)
from repro_torch.models import build_bundle, resnet18  # noqa: E402
from repro_torch.models.config import patterned_stages  # noqa: E402
from repro_torch.optim import OptimizerConfig, make_optimizer  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, fp32 (no
# tensor cores) flop/s, TF32 tensor-core flop/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
# what mma.sync m16n8k8 reaches of TF32 on the H100 SXM at 700 W: 308.7-317.3
# TFLOP/s in scripts/flash_bwd_ablation.py's loop of independent products
MMA_SYNC_TF32 = 310e12

# the main path's run
K, NUM_LABELS, STEPS, S_P, POOL, TOPK_K = 3, 1000, 12, 4, 3, 32
BATCH = 32
CFG = get_config("resnet18-imagenet")  # ResNet-18, 1000 classes, H=5
H = CFG.num_aux_heads + 1
E = CFG.embed_dim
OPTIMIZER = dict(name="sgd_momentum", init_lr=0.1, total_steps=STEPS,
                 grad_clip_norm=1.0)
MHD = dict(delta=1, pool_size=POOL, pool_update_every=S_P)
RUN = dict(steps=STEPS, batch_size=BATCH, public_batch_size=BATCH,
           eval_every=0, eval_batch_size=256, seed=0)
COMM = dict(topk=TOPK_K, val_dtype="float16", emb_encoding="int8",
            horizon=S_P)
# which client steps distill on the main path (row = client, column =
# step). Every client distills in round 0 from its freshly seeded pool.
# Later, a pool of N_P = 3 entries fed one fresh window per round from 2
# neighbours keeps expired windows, and a step whose sampled teacher no
# longer covers it falls back to supervised. The schedule is a function of
# the numpy draws alone; tests/test_torch_schedule.py derives it on the CPU
# through the JAX package and through the port.
REFERENCE_DISTILLED = [[1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0],
                       [1, 1, 1, 1, 0, 1, 0, 0, 0, 1, 0, 0],
                       [1, 1, 1, 1, 0, 1, 0, 1, 1, 1, 0, 1]]


def path_data(D):
    """The main path's training set and partition, built with the data
    module ``D`` (this port's, or the JAX package's in a parity test)."""
    ds = D.make_synthetic_vision(num_labels=NUM_LABELS, samples_per_label=8,
                                 image_size=32, noise=1.0, seed=0)
    part = D.partition_dataset(ds.labels, D.PartitionConfig(
        num_clients=K, num_labels=NUM_LABELS, labels_per_client=250,
        skew=100.0, gamma_pub=0.1, seed=0))
    return ds, part


# the experiment path: the ResNet path's fleet, data, MHD and wire as an
# ExperimentSpec through Experiment(spec).run(), with a checkpoint every 6
# steps; then a restore, the three baselines at 4 steps each, and the
# quickstart (examples/port_quickstart.py) on the card
EXP_CKPT_EVERY, EXP_BASELINE_STEPS, FEDAVG_EVERY = 6, 4, 2
EXP_CKPT_DIR = ROOT / "build" / "exp_checkpoints"
TOL_FEDAVG = 1e-6  # |average - float64 mean| / max |float64 mean|, a leaf


def exp_spec(algo: str, params: dict, steps: int, aux_heads: int = 0,
             **train) -> "EXP.ExperimentSpec":
    """A spec at the ResNet path's settings: its data, partition,
    optimizer and batches; ResNet-18 clients (width 64) registered as
    ``resnet18``; the top-k wire for MHD and the params setting (no wire)
    for the baselines, which have none."""
    wire = EXP.WireSpec(**dict(COMM, exchange="prediction_topk")) \
        if algo == "mhd" else EXP.WireSpec()
    return EXP.ExperimentSpec(
        name=f"chip_smoke_{algo}",
        algorithm=EXP.AlgorithmSpec(algo, params),
        data=EXP.DataSpec(num_labels=NUM_LABELS, samples_per_label=8,
                          image_size=32, noise=1.0, test_samples_per_label=2,
                          seed=0),
        partition=EXP.PartitionSpec(labels_per_client=250, skew=100.0,
                                    gamma_pub=0.1),
        clients=EXP.ExperimentSpec.uniform_fleet(
            K, arch="resnet18", aux_heads=aux_heads, width=CFG.width),
        wire=wire,
        optimizer=EXP.OptimizerSpec(**{k: v for k, v in OPTIMIZER.items()
                                       if k != "total_steps"}),
        train=EXP.TrainSpec(steps=steps, batch_size=BATCH,
                            public_batch_size=BATCH,
                            eval_batch_size=RUN["eval_batch_size"], seed=0,
                            **train))


# the LM path: K=3 full-width, full-depth mamba2-370m clients (48 layers,
# d_model 1024, 32 heads x 64, d_state 128, vocab 50280, 2 aux heads, f32)
# on lm_hetero's MHD and wire (presets.py:114-145), with S_P and W cut to
# fit memory, 12 steps
LM_ARCH = "mamba2-370m"
LM_CFG = get_config(LM_ARCH)
LM_K, LM_DOMAINS, LM_STEPS, LM_S_P, LM_POOL = 3, 6, 12, 4, 2
LM_SEQS, LM_TEST_SEQS, LM_SEQ_LEN, LM_DATA_VOCAB = 64, 8, 512, 512
LM_BATCH, LM_MAX_POS, LM_POS_SEED = 8, 1024, 17
LM_H = LM_CFG.num_aux_heads + 1
LM_VOCAB = LM_CFG.vocab_size
LM_OPTIMIZER = dict(name="adamw", init_lr=1e-3, warmup_steps=2,
                    total_steps=LM_STEPS, grad_clip_norm=1.0)
LM_MHD = dict(nu_emb=0.0, nu_aux=0.5, num_aux_heads=LM_H - 1, delta=1,
              confidence="max", pool_size=LM_POOL,
              pool_update_every=LM_S_P)
LM_RUN = dict(steps=LM_STEPS, batch_size=LM_BATCH,
              public_batch_size=LM_BATCH, eval_every=0,
              eval_batch_size=LM_BATCH, seed=0)
LM_COMM = dict(topk=8, val_dtype="float16", emb_encoding="none",
               budget_bytes_per_token=24, compression="delta",
               horizon=LM_S_P)
LM_PARTITION = dict(labels_per_client=2, skew=100.0, gamma_pub=0.2, seed=0)
LM_TOPK_ROWS = LM_S_P * LM_H * LM_MAX_POS  # W·H·B' of one LM publish
LM_CE_ROWS = 2 * LM_MAX_POS  # n_cand·B' of one aux level
# which client steps distill on the LM path (row = client, column = step).
# Every client distills in round 0 from its seeded pool; later a pool of
# N_P = 2 holds the fresh window and a random older one, and a sampled
# expired window falls back to supervised. Derived on the CPU through the
# JAX package and the port by tests/test_torch_schedule.py.
REFERENCE_DISTILLED_LM = [[1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
                          [1, 1, 1, 1, 0, 1, 0, 0, 1, 0, 0, 0],
                          [1, 1, 1, 1, 0, 1, 0, 1, 1, 1, 1, 0]]


# the hybrid path: K=3 full-width zamba2-7b clients (d_model 3584; Mamba2
# d_inner 7168 = 112 heads x 64, d_state 64, chunk 256; the shared
# attention block, 32 heads x 112, and the dense SwiGLU FFN, d_ff 14336,
# every 6th layer; vocab 32000 tied, 2 aux heads, f32, remat per unit) cut
# in depth from 81 layers to one period of the 5:1 pattern, so the shared
# block is applied once; the LM path's fleet, data, wire and training
ZAMBA_ARCH = "zamba2-7b"
_ZAMBA_FULL = get_config(ZAMBA_ARCH)
ZAMBA_CFG = dataclasses.replace(
    _ZAMBA_FULL, name=f"{ZAMBA_ARCH}-one-period", num_layers=6,
    stages=patterned_stages(6, _ZAMBA_FULL.stages[0].block)).validate()
ZAMBA_VOCAB = ZAMBA_CFG.vocab_size


def lm_path_data(LM, D):
    """The LM path's train and test token arrays and its partition, built
    with the lm and data modules ``LM``, ``D`` (this port's, or the JAX
    package's in a parity test). The test split shares the domain
    languages (``table_seed``), as the reference's runner builds it."""
    arrays = LM.make_text_arrays(LM_DOMAINS, LM_SEQS, LM_SEQ_LEN,
                                 LM_DATA_VOCAB, temperature=0.5, seed=0,
                                 table_seed=0)
    test = LM.make_text_arrays(LM_DOMAINS, LM_TEST_SEQS, LM_SEQ_LEN,
                               LM_DATA_VOCAB, temperature=0.5, seed=991,
                               table_seed=0)
    part = D.partition_dataset(arrays["labels"], D.PartitionConfig(
        num_clients=LM_K, num_labels=LM_DOMAINS, **LM_PARTITION))
    return arrays, test, part


# tolerances: topk values and indices are exact; everything else in f32
# at the 1e-4 of tests/test_kernels.py (bf16 inputs at its 2e-2); the
# lse and the backward (entries ~1/V) at tighter absolute bounds. The bf16
# backward computes in f32 on both sides and differs only in its final
# rounding to bf16: one bf16 ulp, at most 2^-7 < 1e-2 relative
TOL_F32 = 1e-4
TOL_BF16 = 2e-2
TOL_LSE = 1e-6
TOL_GRAD_ABS = 1e-6
TOL_BF16_GRAD_REL = 1e-2
TOL_BF16_GRAD_ABS = 1e-4
TOL_SSD = 1e-4
TOL_SSD_DECAY = 2e-3
# ssd_scan at the LM path's shape: Bt, T, H, P, N, and mamba2-370m's chunk
# (zamba2-7b's is the same); and at the hybrid path's, where N = 64 takes
# the forward's NMAX = 64 instantiation
SSD_SHAPE = (8, 512, 32, 64, 128)
SSD_ZAMBA_SHAPE = (8, 512, 112, 64, 64)
SSD_CHUNK = 256
# flash_attention against its plain version in float64, as max|d| /
# max|plain| per array: f32 kernels sum products of f32 inputs in another
# order (the error grows with d and the band, ~1e-6 at T = 4096); bf16
# inputs differ by the output's rounding to bf16 (2^-9 relative) and, in
# the backward, by O and dO in bf16 entering D = rowsum(dO o O)
TOL_FLASH = 1e-4
TOL_FLASH_BF16 = 2e-2
# the shared attention block at the hybrid path's shape: B, T, H, d, MHA,
# causal; and at zamba2's context length
FLASH_SHAPE = (8, 512, 32, 112)
FLASH_LONG = (1, 4096, 32, 112)
# flash_attention's cases: name, (B, T, S, H, KV, d), causal, window, dtype
FLASH_CASES = [
    ("path", (8, 512, 512, 32, 32, 112), True, 0, "float32"),
    ("T=500", (2, 500, 500, 32, 32, 112), True, 0, "float32"),
    ("T=1", (2, 1, 1, 32, 32, 112), True, 0, "float32"),
    # gemma3 / qwen2.5 widths: GQA G = 2 with a 1024 sliding window
    ("GQA d=128 window", (1, 4096, 4096, 16, 8, 128), True, 1024, "float32"),
    ("d=256 window", (1, 4096, 4096, 16, 8, 256), True, 1024, "float32"),
    ("non-causal S!=T", (2, 300, 200, 8, 4, 64), False, 0, "float32"),
    # T > S + window: rows t >= S + window - 1 have no key in their band
    # and take the mean of v (masked scores -1e30, as the TPU kernel)
    ("keyless rows", (1, 300, 100, 8, 4, 64), False, 64, "float32"),
    ("keyless rows causal", (1, 260, 100, 4, 2, 128), True, 32, "float32"),
    # d % 8 != 0: a ragged last slice of the head dim, rows staged by the
    # scalar loop (d % 4 != 0), T not a multiple of the query tile
    ("d=50", (1, 130, 130, 4, 2, 50), True, 0, "float32"),
    ("bf16", (8, 512, 512, 32, 32, 112), True, 0, "bfloat16")]
# the kernels each path runs, and must have launched
RESNET_KERNELS = ("topk_wire", "dist_ce_fwd", "dist_ce_bwd", "emb_dist_fwd",
                  "emb_dist_bwd")
LM_KERNELS = ("topk_wire", "dist_ce_fwd", "dist_ce_bwd", "ssd_scan_fwd",
              "ssd_scan_bwd")
ZAMBA_KERNELS = LM_KERNELS + ("flash_attention_fwd", "flash_attention_bwd")
# kernels that several wrappers launch, once a call each: ssd_scan's prep
# kernel (C·Bᵀ and the cumsums) runs in the forward and in the backward
SHARED_KERNELS = {"ssd_scan_prep_kernel": ("ssd_scan_fwd", "ssd_scan_bwd")}

RECORD: dict = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"check failed: {what}")


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Median of per-call CUDA-event times (ms)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def bound(nbytes: float, flops: float, peak: float = PEAK_F32):
    """The least time of the work, ms: its bytes over the card's memory
    rate or its operations over the peak rate of their type, the larger."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def maxerr(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b|, where equal entries (equal infinities too) count 0."""
    a, b = a.float(), b.float()
    d = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
    return float(d.max()) if a.numel() else 0.0


def close(a, b, rtol, atol) -> bool:
    return bool(torch.allclose(a.float(), b.float(), rtol=rtol, atol=atol))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} | "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return {"nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda}


def phase_build() -> None:
    t0 = time.perf_counter()
    build.build_cuda(["topk_wire", "ssd_scan", "flash_attention"])
    RECORD["build_s"] = time.perf_counter() - t0
    log(f"build: nvcc {RECORD['build_s']:.2f} s")
    for name in ("topk_wire", "ssd_scan", "flash_attention"):
        fn = name
        for line in (build.BUILD_DIR / f"{name}.log").read_text().splitlines():
            # the kernel's name and template arguments, still mangled
            entry = re.search(r"_cu_\w{8}\d+(\w+?_kernel)(I\w+?E)?E", line)
            if "entry function" in line and entry:
                fn = entry.group(1) + (entry.group(2) or "")
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  ptxas {fn}: {line.strip()}")


def _topk_timing(x: torch.Tensor, k: int, iters: int) -> dict:
    B, V = x.shape
    b_ms, b_by = bound(B * V * 4 + B * k * 8 + B * 4, 3 * B * V)
    return {"shape": [B, V, k],
            "ms": time_ms(lambda: TOPK.topk_wire_kernel(x, k), iters=iters),
            "plain_ms": time_ms(lambda: TOPK.topk_wire_plain(x, k),
                                iters=iters),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lambda: (torch.topk(x, k, dim=-1),
                                           torch.logsumexp(x, dim=-1)),
                                  iters=iters)}


def phase_topk(dev) -> dict:
    """topk_wire against its plain version (values and indices exact, lse
    within TOL_LSE), at the three paths' shapes and at the edges (rows off
    16 bytes, ties, -inf, k up to V and past the one-pass kernel's 256);
    timed at the LM path's publish shape, with the hybrid and ResNet
    paths' beside it; then the launch floor."""
    g = torch.Generator(device=dev).manual_seed(0)
    rows = 4 * H * BATCH  # W·H·B of one ResNet publish
    err = 0.0
    cases = [("slice", torch.randn(rows, NUM_LABELS, generator=g,
                                   device=dev) * 3, TOPK_K),
             ("lm", torch.randn(LM_TOPK_ROWS, LM_VOCAB, generator=g,
                                device=dev) * 3, LM_COMM["topk"]),
             # the hybrid path's publish: 128 KB rows, streamed once from
             # device memory as the LM path's 201 KB rows are
             ("zamba2", torch.randn(LM_TOPK_ROWS, ZAMBA_VOCAB, generator=g,
                                    device=dev) * 3, LM_COMM["topk"]),
             ("large", torch.randn(rows, 32768, generator=g, device=dev) * 3,
              TOPK_K),
             # 12,000 and 12,288 columns, named for the shared-memory
             # staging an earlier kernel had: 12,288 fills every group of
             # float4s a warp loads at once, 12,000 ends in a masked one
             ("smem row", torch.randn(64, 12000, generator=g, device=dev),
              TOPK_K),
             ("48 KB row", torch.randn(64, 12288, generator=g, device=dev),
              TOPK_K),
             ("ties", torch.randint(-3, 3, (64, NUM_LABELS), generator=g,
                                    device=dev).float(), TOPK_K),
             ("k=V", torch.randn(8, 40, generator=g, device=dev), 40),
             # GPT-2's vocabulary: every row but the first starts off a
             # 16-byte boundary (a scalar head and tail around the float4s)
             ("V=50,257", torch.randn(512, 50257, generator=g, device=dev)
              * 3, LM_COMM["topk"]),
             ("k=32 at 50,280", torch.randn(512, LM_VOCAB, generator=g,
                                            device=dev) * 3, 32),
             # above the paths' k: a warp's list of k + 256 entries
             ("k=64", torch.randn(512, ZAMBA_VOCAB, generator=g, device=dev)
              * 3, 64),
             # above the one-pass kernel's largest k (256): the rank kernel
             ("k=512", torch.randn(16, ZAMBA_VOCAB, generator=g, device=dev)
              * 3, 512),
             ("ties at 50,280", torch.randint(-3, 3, (64, LM_VOCAB),
                                              generator=g,
                                              device=dev).float(),
              LM_COMM["topk"]),
             ("-inf columns", _with_neg_inf(torch.randn(
                 64, LM_VOCAB, generator=g, device=dev) * 3),
              LM_COMM["topk"])]
    for name, x, k in cases:
        v, i, lse = TOPK.topk_wire_kernel(x, k)
        pv, pi, plse = TOPK.topk_wire_plain(x, k)
        torch.cuda.synchronize()
        check(torch.equal(v, pv), f"topk_wire {name}: values exact")
        check(torch.equal(i, pi), f"topk_wire {name}: indices exact")
        check(close(lse, plse, TOL_LSE, TOL_LSE), f"topk_wire {name}: lse")
        err = max(err, maxerr(v, pv), maxerr(lse, plse))
        log(f"topk_wire {name} {tuple(x.shape)} k={k}: idx/vals exact, "
            f"lse max|d|={maxerr(lse, plse):.3g}")
    lm = _topk_timing(cases[1][1], LM_COMM["topk"], iters=20)
    zamba = _topk_timing(cases[2][1], LM_COMM["topk"], iters=20)
    resnet = _topk_timing(cases[0][1], TOPK_K, iters=50)
    log(f"topk_wire timing: LM shape {lm['ms']:.3f} ms (plain "
        f"{lm['plain_ms']:.3f}, library {lm['library_ms']:.3f}, bound "
        f"{lm['bound_ms']:.4f}); zamba2 shape {zamba['ms']:.3f} ms (plain "
        f"{zamba['plain_ms']:.3f}, library {zamba['library_ms']:.3f}, bound "
        f"{zamba['bound_ms']:.4f}); ResNet shape {resnet['ms']:.3f} ms")
    RECORD["launch_floor"] = floor = _launch_floor(dev)
    log(f"launch floor: a one-element fill takes {floor['device_us']:.2f} us "
        f"of device time under the profiler ({floor['launches']} launches), "
        f"{floor['ms'] * 1e3:.2f} us a call by CUDA events")
    return {**TOPK.INFO, **lm, "max_abs_err": err,
            "at_zamba2_shape": zamba, "at_resnet_shape": resnet}


def _with_neg_inf(x: torch.Tensor) -> torch.Tensor:
    """Every 7th column -inf; row 1 all -inf (lse -inf, the k lowest
    columns); row 2 -inf from column 3 on, so two finite values and then
    -inf entries, lowest columns first, fill its top k."""
    x[:, ::7] = -math.inf
    x[1] = -math.inf
    x[2, 3:] = -math.inf
    return x


def _launch_floor(dev) -> dict:
    """The least device time of a launch: a one-element fill, 100 times
    under torch.profiler as the path rounds are profiled (device us a
    call), and its CUDA-event median a call beside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t = torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(100):
            t.fill_(1.0)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    n = sum(e.count for e in rows)
    us = sum(e.self_device_time_total for e in rows)
    return {"device_us": us / n, "launches": n,
            "ms": time_ms(lambda: t.fill_(1.0), iters=200)}

def _ssd_inputs(dev, g, Bt, T, H, P, N, kind):
    """Inputs of one ssd_scan case: the model's A = -(1..H); dt around
    0.05 (softplus of N(-3, 0.5)); "decay": dt·A = -10 every step, where
    exp underflows inside a chunk; "s=0": A = 0, no decay at all."""
    x = torch.randn(Bt, T, H, P, generator=g, device=dev)
    dt = F.softplus(torch.randn(Bt, T, H, generator=g, device=dev) * 0.5
                    - 3.0)
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=dev)
    if kind == "decay":
        dt = (10.0 / -A)[None, None, :].expand(Bt, T, H).contiguous()
    if kind == "s=0":
        A = torch.zeros_like(A)
    B = torch.randn(Bt, T, N, generator=g, device=dev)
    C = torch.randn(Bt, T, N, generator=g, device=dev)
    D = torch.ones(H, device=dev)
    return x, dt, A, B, C, D


def _relerr(a, b) -> float:
    return maxerr(a, b) / max(float(b.float().abs().max()), 1e-30)


def phase_ssd(dev) -> list:
    """ssd_scan forward and backward kernels against ssd_scan_plain on the
    card: y, the final state and all six gradients (of a random linear
    function of y and the final state), each as max|d| over max|plain|,
    and the chunk-start states the forward saves for the backward.
    The plain version runs in float64 on the same inputs (the model's
    chunk, 256, or the sequential recurrence when T is not a multiple):
    at dt·A = -10 a step a float32 autograd of the chunked math cancels
    O(1) diagonal gate terms against each other in dA and is itself off by
    percents. Tolerances: TOL_SSD for float32 sums in another
    order and chunking; TOL_SSD_DECAY at dt·A = -10, where the kernel's
    own cumsum over a 64-chunk reaches -640, so s_t - s_u carries ~4e-5
    of absolute rounding into every e^-10(t-u) term. The cases: both LM
    paths' shapes (N = 128, and the hybrid path's N = 64, which takes the
    forward's NMAX = 64 instantiation), ragged T, strong decay, no
    decay."""
    g = torch.Generator(device=dev).manual_seed(5)
    Bt, T, H, P, N = SSD_SHAPE
    cases = [("path", (Bt, T, H, P, N), "model", SSD_CHUNK),
             ("zamba2 N=64", SSD_ZAMBA_SHAPE, "model", SSD_CHUNK),
             ("T=500", (2, 500, 4, P, N), "model", SSD_CHUNK),
             ("T=1", (2, 1, 4, P, N), "model", SSD_CHUNK),
             ("decay", (2, 512, H, P, N), "decay", SSD_CHUNK),
             ("s=0", (2, 512, 4, P, N), "s=0", SSD_CHUNK)]
    err_f, err_b = 0.0, 0.0  # max absolute differences, for the record
    record = []
    names = ("dx", "ddt", "dA", "dB", "dC", "dD")
    for name, shape, kind, chunk in cases:
        ins = _ssd_inputs(dev, g, *shape, kind)
        gy = torch.randn(ins[0].shape, generator=g, device=dev)
        gf = torch.randn(shape[0], shape[2], shape[3], shape[4],
                         generator=g, device=dev)
        res = []
        for use_kernel in (True, False):
            if use_kernel:
                leaves = [t.clone().requires_grad_() for t in ins]
                y, fin = SSD.SSDScan.apply(*leaves)
            else:  # the oracle: the plain version in float64
                leaves = [t.double().requires_grad_() for t in ins]
                y, fin = SSD.ssd_scan_plain(*leaves, chunk)
            grads = torch.autograd.grad(
                (y * gy.to(y.dtype)).sum() + (fin * gf.to(y.dtype)).sum(),
                leaves)
            res.append((y.detach(), fin.detach(), grads))
        torch.cuda.synchronize()
        tol = TOL_SSD_DECAY if kind == "decay" else TOL_SSD
        (y1, f1, g1), (y2, f2, g2) = res
        # the chunk-start states the forward saves for the backward, against
        # the plain state after each prefix of 64·c steps
        st1 = SSD.ssd_scan_fwd_kernel(*ins, save_states=True)[2]
        st2 = SSD.ssd_chunk_states_plain(*(t.double() for t in ins),
                                         SSD.kernel_chunk())
        ey, ef, es = _relerr(y1, y2), _relerr(f1, f2), _relerr(st1, st2)
        check(torch.isfinite(y1).all() and torch.isfinite(f1).all()
              and torch.isfinite(st1).all(), f"ssd_scan {name}: finite")
        check(ey <= tol and ef <= tol and es <= tol,
              f"ssd_scan {name}: y {ey:.3g}, final state {ef:.3g}, chunk "
              f"states {es:.3g} > {tol}")
        errs, abs_errs = [], []
        scale = max(float(b.abs().max()) for b in g2)
        for nm, a, b in zip(names, g1, g2):
            # a gradient that is exactly zero on the plain side (dA at
            # T = 1: no decay acts within one step) is held absolutely, at
            # the tolerance times the case's largest gradient entry
            e = _relerr(a, b) if float(b.abs().max()) > 0 else \
                maxerr(a, b) / scale
            errs.append(e)
            abs_errs.append(maxerr(a, b))
            check(torch.isfinite(a).all(), f"ssd_scan {name}: {nm} finite")
            check(e <= tol, f"ssd_scan {name}: {nm} {e:.3g} > {tol}")
        err_f = max(err_f, maxerr(y1, y2), maxerr(f1, f2), maxerr(st1, st2))
        err_b = max(err_b, *abs_errs)
        log(f"ssd_scan {name} {shape}: y {ey:.3g} state {ef:.3g} chunk "
            f"states {es:.3g} | "
            + " ".join(f"{nm} {e:.3g}" for nm, e in zip(names, errs))
            + f" (max|d| / max|plain|, tolerance {tol})")
        log(f"ssd_scan {name}: max|d| y {maxerr(y1, y2):.3g} state "
            f"{maxerr(f1, f2):.3g} | "
            + " ".join(f"{nm} {e:.3g}" for nm, e in zip(names, abs_errs))
            + " | max|plain| "
            + " ".join(f"{nm} {float(b.abs().max()):.3g}"
                       for nm, b in zip(names, g2)))
        record.append({
            "case": name, "shape": list(shape), "tol": tol,
            "rel": {"y": ey, "state": ef, "chunk_states": es,
                    **dict(zip(names, errs))},
            "abs": {"y": maxerr(y1, y2), "state": maxerr(f1, f2),
                    "chunk_states": maxerr(st1, st2),
                    **dict(zip(names, abs_errs))},
            "plain_max": {"y": float(y2.abs().max()),
                          "state": float(f2.abs().max()),
                          **{nm: float(b.abs().max())
                             for nm, b in zip(names, g2)}}})
    RECORD["ssd_scan_cases"] = record
    fwd, bwd = _ssd_timing(dev, g, SSD_SHAPE)
    fwd_z, bwd_z = _ssd_timing(dev, g, SSD_ZAMBA_SHAPE)
    for nm, x, y in (("fwd", fwd, fwd_z), ("bwd", bwd, bwd_z)):
        extra = [f", 3xTF32 ops {v['tf32x3_bound_ms']:.4f}, f32 FMAs "
                 f"{v['f32_bound_ms']:.4f}" for v in (x, y)]
        if nm == "fwd":
            extra = [e + f", saving states {v['ms_saving_states']:.3f} ms "
                     f"against bound {v['bound_ms_saving_states']:.4f}"
                     for e, v in zip(extra, (x, y))]
        log(f"ssd_scan timing {nm}: LM shape {x['ms']:.3f} ms (plain "
            f"{x['plain_ms']:.3f}, bound {x['bound_ms']:.4f} "
            f"{x['bound_by']}{extra[0]}, {x['gflop']:.3f} GFLOP); zamba2 "
            f"shape {y['ms']:.3f} ms (plain {y['plain_ms']:.3f}, bound "
            f"{y['bound_ms']:.4f} {y['bound_by']}{extra[1]}, "
            f"{y['gflop']:.3f} GFLOP)")
    log(f"ssd_scan timing: einsum at L={SSD.kernel_chunk()} "
        f"{fwd['library_ms']:.3f} ms (LM), {fwd_z['library_ms']:.3f} ms "
        f"(zamba2)")
    return [{**SSD.INFO_FWD, **fwd, "max_abs_err": err_f,
             "at_zamba2_shape": fwd_z},
            {**SSD.INFO_BWD, **bwd, "max_abs_err": err_b,
             "at_zamba2_shape": bwd_z}]


def _ssd_timing(dev, g, shape) -> tuple:
    """Kernel, plain and library times of the forward and of the backward
    alone at ``shape`` = (Bt, T, H, P, N), with the function's bounds."""
    Bt, T, H, P, N = shape
    x, dt, A, B, C, D = _ssd_inputs(dev, g, Bt, T, H, P, N, "model")
    L = SSD.kernel_chunk()
    nc = -(-T // L)
    _, _, states = SSD.ssd_scan_fwd_kernel(x, dt, A, B, C, D,
                                           save_states=True)
    dy = torch.randn_like(x)
    # bytes: every input read once, every output written once; operations:
    # the products the function needs at the kernel's chunk length L, per
    # (row b, chunk): B and C are shared by the heads, so C·Bᵀ (tri·N
    # multiply-adds) is needed once, not once per head; per head the
    # masked product with x (tri·P), C·h and the state update (L·N·P
    # each). Backward: C·Bᵀ again, and dC = dCB·B and dB = dCBᵀ·C once on
    # the head-summed dCB (its tri·H additions); per head dx and dCB from
    # the masked product (2·tri·P) and the four state products
    # (4·L·N·P). What the backward kernel does beyond that (dB and dC per
    # head) belongs to its design, not to the function. Both directions
    # compute by 3xTF32, three TF32 products for each f32 one, so each
    # bound is those at 495 TFLOP/s or its bytes, the larger (the
    # forward's with and without the chunk states the training call
    # saves); the f32 FMA figure stands beside it.
    io_in = 4 * (2 * Bt * T * N + Bt * T * H * P + Bt * T * H + 2 * H)
    state_b = 4 * Bt * H * P * N
    tri = L * (L + 1) / 2
    rows, heads = Bt * nc, Bt * nc * H
    fl_fwd = 2 * rows * tri * N + 2 * heads * (tri * P + 2 * L * N * P)
    fwd_bytes = io_in + 4 * Bt * T * H * P + state_b
    fb, fby = bound(fwd_bytes, 3 * fl_fwd, PEAK_TF32)
    fb_states, _ = bound(fwd_bytes + nc * state_b, 3 * fl_fwd, PEAK_TF32)
    fl_bwd = (2 * rows * 3 * tri * N + rows * tri * H
              + 2 * heads * (2 * tri * P + 4 * L * N * P))
    # backward: dy and the chunk states (the wrapper's inputs) read; dx,
    # ddt, dB, dC, dA and dD written
    bb, bby = bound(io_in + 4 * Bt * T * H * P + nc * state_b
                    + 4 * (Bt * T * H * P + Bt * T * H + 2 * Bt * T * N
                           + 2 * H), 3 * fl_bwd, PEAK_TF32)
    fwd = {"shape": [Bt, T, H, P, N], "gflop": fl_fwd / 1e9,
           "tf32x3_bound_ms": 3 * fl_fwd / PEAK_TF32 * 1e3,
           "f32_bound_ms": fl_fwd / PEAK_F32 * 1e3,
           "bound_ms_saving_states": fb_states,
           "ms": time_ms(lambda: SSD.ssd_scan_fwd_kernel(
               x, dt, A, B, C, D), iters=20),
           "ms_saving_states": time_ms(lambda: SSD.ssd_scan_fwd_kernel(
               x, dt, A, B, C, D, save_states=True), iters=20),
           "plain_ms": time_ms(lambda: SSD.ssd_scan_plain(
               x, dt, A, B, C, D, SSD_CHUNK), iters=10, warmup=2),
           "bound_ms": fb, "bound_by": fby,
           "library_ms": time_ms(lambda: SSD.ssd_chunked_plain(
               x, dt, A, B, C, D, L), iters=10, warmup=2)}

    # the plain backward alone: autograd through one saved graph of the
    # plain forward, as the kernel's backward reads its saved states
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, B, C, D)]
    y_plain, _ = SSD.ssd_scan_plain(*leaves, SSD_CHUNK)

    def plain_bwd():
        torch.autograd.grad(y_plain, leaves, dy, retain_graph=True)

    bwd = {"shape": [Bt, T, H, P, N], "gflop": fl_bwd / 1e9,
           "tf32x3_bound_ms": 3 * fl_bwd / PEAK_TF32 * 1e3,
           "f32_bound_ms": fl_bwd / PEAK_F32 * 1e3,
           "ms": time_ms(lambda: SSD.ssd_scan_bwd_kernel(
               x, dt, A, B, C, D, states, dy), iters=20),
           "plain_ms": time_ms(plain_bwd, iters=10, warmup=2),
           "bound_ms": bb, "bound_by": bby, "library_ms": None}
    del y_plain, leaves
    return fwd, bwd


def attn_pairs(T: int, S: int, causal: bool, window: int) -> int:
    """The (query, key) pairs inside the mask: the work of one (b, h)."""
    t = np.arange(T)
    hi = np.minimum(t + 1, S) if causal else np.full(T, S)
    lo = np.maximum(t - window + 1, 0) if window else np.zeros(T, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def _flash_bounds(B, T, S, H, KV, d, causal, window, elem):
    """(forward, backward) bounds: bytes with every input read once and
    every output written once, over 3.35 TB/s; operations over 495 TFLOP/s
    of TF32, the type both kernels compute in: three TF32 products (3xTF32)
    for each f32 one, counting the pairs inside the mask only — 2 d
    multiply-adds a pair forward (q·k, p·v), 5 backward (s again, dP, dV,
    dS·K, dSᵀ·Q). Also the f32 operations of each."""
    pairs = attn_pairs(T, S, causal, window) * B * H
    qo, kv, rows = B * T * H * d * elem, B * S * KV * d * elem, B * H * T * 4
    fl_f, fl_b = 4 * pairs * d, 10 * pairs * d
    fwd = bound(2 * qo + 2 * kv + rows, 3 * fl_f, PEAK_TF32)
    bwd = bound(3 * qo + 2 * kv + rows + qo + 2 * kv, 3 * fl_b, PEAK_TF32)
    return fwd, bwd, fl_f, fl_b


def fwd_tile_pairs(T: int, S: int, causal: bool, window: int, d: int) -> int:
    """The (query, key) pairs of the whole tiles the forward kernel computes
    for one (b, h): each query tile times the key tiles its band reaches
    (all of them if a row has no key), at the tiles the kernel reports."""
    rows, keys = FA.flash_attention_fwd_tile(d)
    pairs = 0
    for t0 in range(0, T, rows):
        if window and t0 + rows - 1 >= S + window - 1:
            lo, hi = 0, S
        else:
            lo = max(0, t0 - window + 1) if window else 0
            hi = min(S, t0 + rows) if causal else S
        pairs += rows * keys * -(-(hi - lo // keys * keys) // keys)
    return pairs


def _sdpa(q, k, v):
    """The library yardstick: one causal scaled_dot_product_attention call
    on the same tensors, viewed (B, H, T, d)."""
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True)


def _flash_timing(dev, g, B, T, H, d, iters: int) -> tuple:
    """Kernel, plain and library times of the forward and of the backward
    alone at (B, T, H, d), MHA, causal, f32."""
    q, k, v, do = (torch.randn(B, T, H, d, generator=g, device=dev)
                   for _ in range(4))
    o, lse = FA.flash_attention_fwd_kernel(q, k, v, causal=True)
    (fb, fby), (bb, bby), fl_f, fl_b = _flash_bounds(B, T, T, H, H, d, True,
                                                     0, 4)
    # the plain and library backward alone: autograd on one saved graph
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o_plain = FA.flash_attention_plain(*leaves, causal=True)
    o_lib = _sdpa(*leaves)

    def plain_bwd():
        torch.autograd.grad(o_plain, leaves, do, retain_graph=True)

    def lib_bwd():
        torch.autograd.grad(o_lib, leaves, do.transpose(1, 2),
                            retain_graph=True)

    # the forward computes whole tiles, at mma.sync's rate at best
    tiles = 4 * B * H * d * fwd_tile_pairs(T, T, True, 0, d)
    fwd = {"shape": [B, T, H, d], "gflop": fl_f / 1e9,
           "mma_sync_floor_ms": 3 * tiles / MMA_SYNC_TF32 * 1e3,
           "ms": time_ms(lambda: FA.flash_attention_fwd_kernel(
               q, k, v, causal=True), iters=iters),
           "plain_ms": time_ms(lambda: FA.flash_attention_plain(
               q, k, v, causal=True), iters=iters, warmup=2),
           "bound_ms": fb, "bound_by": fby,
           "library_ms": time_ms(lambda: _sdpa(q, k, v), iters=iters)}
    bwd = {"shape": [B, T, H, d], "gflop": fl_b / 1e9,
           "ms": time_ms(lambda: FA.flash_attention_bwd_kernel(
               q, k, v, o, lse, do, causal=True, window=0), iters=iters),
           "plain_ms": time_ms(plain_bwd, iters=iters, warmup=2),
           "bound_ms": bb, "bound_by": bby,
           "library_ms": time_ms(lib_bwd, iters=iters)}
    del leaves, o_plain, o_lib
    return fwd, bwd


def _sdpa_kernels(dev, g) -> list:
    """The names of the device kernels that one _sdpa call runs at the
    path's shape, from a profiler pass: what the library yardstick is."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    q, k, v = (torch.randn(*FLASH_SHAPE, generator=g, device=dev)
               for _ in range(3))
    _sdpa(q, k, v)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _sdpa(q, k, v)
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA})


def _flash_lse_plain(q, k, causal: bool, window: int) -> torch.Tensor:
    """Each row's logsumexp of the masked scaled scores, (B, H, T): the
    oracle of the forward kernel's second output. Masked scores are -1e30,
    so a row with no key in its band has lse -1e30."""
    B, T, H, d = q.shape
    S, KV = k.shape[1], k.shape[2]
    s = torch.einsum("btkgd,bskd->bkgts", q.reshape(B, T, KV, H // KV, d),
                     k) / math.sqrt(d)
    t = torch.arange(T, device=q.device)[:, None]
    u = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= u <= t
    if window:
        mask &= u > t - window
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    return torch.logsumexp(s, dim=-1).reshape(B, H, T)


def phase_flash(dev) -> list:
    """flash_attention forward and backward kernels against
    flash_attention_plain on the card: o, each row's logsumexp and dq, dk,
    dv (of a random linear function of o), each as max|d| over
    max|plain|, with the plain version in float64 on the same inputs. A
    gradient that is zero but for rounding (dq and dk at T = S = 1: one
    key, so dS = P(dP - D) = 0) is held absolutely, at the tolerance times
    the case's largest gradient entry. The logsumexp is compared on the
    rows with a key in their band; a row with none must give -1e30 (or
    below). Cases: the hybrid path's shared block, ragged T, GQA with a
    sliding window at gemma3 / qwen2.5 widths and T = 4096, d = 256,
    non-causal S != T, rows with no key in their band (T > S + window),
    bf16 inputs. Timed at the path's shape and at zamba2's context,
    T = 4096."""
    g = torch.Generator(device=dev).manual_seed(7)
    names = ("o", "lse", "dq", "dk", "dv")
    record, err_f, err_b = [], 0.0, 0.0
    for name, (b, t, s_, h, kv, dd), causal, window, dt_name in FLASH_CASES:
        dt = getattr(torch, dt_name)
        q = torch.randn(b, t, h, dd, generator=g, device=dev).to(dt)
        k = torch.randn(b, s_, kv, dd, generator=g, device=dev).to(dt)
        v = torch.randn(b, s_, kv, dd, generator=g, device=dev).to(dt)
        do = torch.randn(b, t, h, dd, generator=g, device=dev).to(dt)
        o, lse = FA.flash_attention_fwd_kernel(q, k, v, causal=causal,
                                               window=window)
        grads = FA.flash_attention_bwd_kernel(q, k, v, o, lse, do,
                                              causal=causal, window=window)
        torch.cuda.synchronize()
        leaves = [x.double().requires_grad_() for x in (q, k, v)]
        o2 = FA.flash_attention_plain(*leaves, causal=causal, window=window)
        grads2 = torch.autograd.grad(o2, leaves, do.double())
        lse2 = _flash_lse_plain(leaves[0].detach(), leaves[1].detach(),
                                causal, window)
        live = lse2 > -1e29
        check(bool((lse[~live] <= -1e29).all()),
              f"flash {name}: lse of the rows with no key")
        tol = TOL_FLASH if dt == torch.float32 else TOL_FLASH_BF16
        scale = max(float(x.abs().max()) for x in grads2)
        # one key: dS = P(dP - D) = 0, so dq = dk = 0 up to rounding
        zero = ("dq", "dk") if s_ == 1 else ()
        errs, abs_errs = [], []
        for nm, a, r in zip(names, (o, lse[live], *grads),
                            (o2.detach(), lse2[live], *grads2)):
            e = maxerr(a, r) / scale if nm in zero else _relerr(a, r)
            check(bool(torch.isfinite(a).all()), f"flash {name}: {nm} finite")
            check(e <= tol, f"flash {name}: {nm} {e:.3g} > {tol}")
            errs.append(e)
            abs_errs.append(maxerr(a, r))
        if dt == torch.float32:
            err_f = max(err_f, *abs_errs[:2])
            err_b = max(err_b, *abs_errs[2:])
        log(f"flash_attention {name} (B, T, S, H, KV, d) = "
            f"{(b, t, s_, h, kv, dd)} causal={causal} window={window} {dt}: "
            + " ".join(f"{nm} {e:.3g}" for nm, e in zip(names, errs))
            + f" (max|d| / max|plain|, tolerance {tol})")
        record.append({"case": name, "shape": [b, t, s_, h, kv, dd],
                       "causal": causal, "window": window, "dtype": str(dt),
                       "tol": tol, "rel": dict(zip(names, errs)),
                       "abs": dict(zip(names, abs_errs))})
        del q, k, v, do, o, lse, grads, leaves, o2, lse2, grads2
        torch.cuda.empty_cache()
    RECORD["flash_attention_cases"] = record
    fwd, bwd = _flash_timing(dev, g, *FLASH_SHAPE, iters=20)
    fwd_l, bwd_l = _flash_timing(dev, g, *FLASH_LONG, iters=10)
    torch.cuda.empty_cache()
    for nm, x, y in (("fwd", fwd, fwd_l), ("bwd", bwd, bwd_l)):
        tc = (f", whole-tile mma.sync floor {x['mma_sync_floor_ms']:.4f}"
              if "mma_sync_floor_ms" in x else "")
        log(f"flash_attention timing {nm}: path shape {x['ms']:.3f} ms "
            f"(plain {x['plain_ms']:.3f}, library {x['library_ms']:.3f}, "
            f"3xTF32 bound {x['bound_ms']:.4f} {x['bound_by']}{tc}, "
            f"{x['gflop']:.2f} GFLOP); T={FLASH_LONG[1]} {y['ms']:.3f} ms "
            f"(plain {y['plain_ms']:.3f}, library {y['library_ms']:.3f}, "
            f"bound {y['bound_ms']:.4f})")
    RECORD["sdpa_kernels"] = _sdpa_kernels(dev, g)
    log(f"flash_attention library yardstick: scaled_dot_product_attention "
        f"at {FLASH_SHAPE} causal f32 runs {RECORD['sdpa_kernels']}")
    return [{**FA.INFO_FWD, **fwd, "max_abs_err": err_f,
             "at_T4096": fwd_l},
            {**FA.INFO_BWD, **bwd, "max_abs_err": err_b,
             "at_T4096": bwd_l}]


def _dist_ce_library(s, t):
    logp = F.log_softmax(s, dim=-1)
    p_t = F.softmax(t, dim=-1)
    return -(p_t * logp).sum(-1), p_t.amax(-1), logp.amax(-1).exp()


def _dist_ce_timing(dev, g, B, V, s_dt, iters: int) -> tuple:
    s = (torch.randn(B, V, generator=g, device=dev) * 3).to(s_dt)
    t = torch.randn(B, V, generator=g, device=dev) * 3
    gce = torch.randn(B, generator=g, device=dev)
    stats = DCE.dist_ce_fwd_kernel(s, t)[3]
    sb = s.element_size()
    fb, fby = bound(B * V * (sb + 4) + 7 * B * 4, 8 * B * V)
    bb, bby = bound(B * V * (2 * sb + 4) + 5 * B * 4, 6 * B * V)
    fwd = {"shape": [B, V], "student_dtype": str(s_dt),
           "ms": time_ms(lambda: DCE.dist_ce_fwd_kernel(s, t), iters=iters),
           "plain_ms": time_ms(lambda: DCE.dist_ce_fwd_plain(s, t),
                               iters=iters),
           "bound_ms": fb, "bound_by": fby,
           "library_ms": time_ms(lambda: _dist_ce_library(s, t),
                                 iters=iters)}
    bwd = {"shape": [B, V], "student_dtype": str(s_dt),
           "ms": time_ms(lambda: DCE.dist_ce_bwd_kernel(s, t, stats, gce),
                         iters=iters),
           "plain_ms": time_ms(
               lambda: DCE.dist_ce_bwd_plain(s, t, stats, gce), iters=iters),
           "bound_ms": bb, "bound_by": bby, "library_ms": None}
    return fwd, bwd


def phase_dist_ce(dev) -> list:
    """dist_ce forward and backward against the plain versions: f32, bf16,
    ties, a large V, and the LM path's rows (bf16 student logits against
    f32 decoded teacher rows, V = 50280); timed at the LM path's shape,
    with the ResNet path's beside it."""
    g = torch.Generator(device=dev).manual_seed(1)
    rows = 2 * BATCH  # n_cand·B of one aux level
    err_f, err_b = 0.0, 0.0
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("slice", rows, NUM_LABELS, f32, f32, 3.0),
             ("large", rows, 32768, f32, f32, 3.0),
             ("bf16", rows, NUM_LABELS, bf16, bf16, 3.0),
             ("ties", rows, NUM_LABELS, f32, f32, 0.0),
             ("lm", LM_CE_ROWS, LM_VOCAB, bf16, f32, 3.0)]
    for name, B, V, s_dt, t_dt, scale in cases:
        s = (torch.randn(B, V, generator=g, device=dev) * 3).to(s_dt)
        t = (torch.randn(B, V, generator=g, device=dev) * scale).to(t_dt)
        gce = torch.randn(B, generator=g, device=dev)
        out = DCE.dist_ce_fwd_kernel(s, t)
        ref = DCE.dist_ce_fwd_plain(s, t)
        gs = DCE.dist_ce_bwd_kernel(s, t, out[3], gce)
        gs_ref = DCE.dist_ce_bwd_plain(s, t, ref[3], gce)
        torch.cuda.synchronize()
        both_f32 = s_dt == f32 and t_dt == f32
        tol = TOL_F32 if both_f32 else TOL_BF16
        for a, b, nm in zip(out[:3], ref[:3], ("ce", "t_conf", "s_conf")):
            check(close(a, b, tol, tol), f"dist_ce {name}: {nm}")
            if both_f32:
                err_f = max(err_f, maxerr(a, b))
        if s_dt == f32:
            check(close(gs, gs_ref, TOL_F32, TOL_GRAD_ABS),
                  f"dist_ce bwd {name}")
            err_b = max(err_b, maxerr(gs, gs_ref))
        else:
            check(close(gs, gs_ref, TOL_BF16_GRAD_REL, TOL_BF16_GRAD_ABS),
                  f"dist_ce bwd {name}")
        log(f"dist_ce {name} ({B}, {V}) {s_dt}/{t_dt}: fwd max|d|="
            f"{max(maxerr(a, b) for a, b in zip(out[:3], ref[:3])):.3g} "
            f"bwd max|d|={maxerr(gs, gs_ref):.3g}")
    lm_f, lm_b = _dist_ce_timing(dev, g, LM_CE_ROWS, LM_VOCAB, bf16, 20)
    rn_f, rn_b = _dist_ce_timing(dev, g, rows, NUM_LABELS, f32, 50)
    log(f"dist_ce timing: LM shape fwd {lm_f['ms']:.3f} ms bwd "
        f"{lm_b['ms']:.3f} ms (plain {lm_f['plain_ms']:.3f} / "
        f"{lm_b['plain_ms']:.3f}); ResNet shape fwd {rn_f['ms']:.3f} bwd "
        f"{rn_b['ms']:.3f}")
    return [{**DCE.INFO_FWD, **lm_f, "max_abs_err": err_f,
             "at_resnet_shape": rn_f},
            {**DCE.INFO_BWD, **lm_b, "max_abs_err": err_b,
             "at_resnet_shape": rn_b}]

def _emb_library(s, t):
    return (F.normalize(s, dim=-1) - F.normalize(t, dim=-1)).square().sum(-1)


def phase_emb_dist(dev) -> list:
    g = torch.Generator(device=dev).manual_seed(2)
    rows = BATCH  # Δ·B
    err_f, err_b = 0.0, 0.0
    for name, B, D in (("slice", rows, E), ("large", 256, 8192),
                       ("s==t", rows, E)):
        s = torch.randn(B, D, generator=g, device=dev)
        t = s.clone() if name == "s==t" else torch.randn(
            B, D, generator=g, device=dev)
        gd = torch.randn(B, generator=g, device=dev)
        o, o_ref = EMB.emb_dist_fwd_kernel(s, t), EMB.emb_dist_plain(s, t)
        gs = EMB.emb_dist_bwd_kernel(s, t, gd)
        gs_ref = EMB.emb_dist_bwd_plain(s, t, gd)
        torch.cuda.synchronize()
        check(close(o, o_ref, TOL_F32, TOL_F32), f"emb_dist {name}")
        check(close(gs, gs_ref, TOL_F32, TOL_GRAD_ABS),
              f"emb_dist bwd {name}")
        err_f, err_b = max(err_f, maxerr(o, o_ref)), max(err_b,
                                                         maxerr(gs, gs_ref))
        log(f"emb_dist {name} ({B}, {D}): fwd max|d|={maxerr(o, o_ref):.3g}"
            f" bwd max|d|={maxerr(gs, gs_ref):.3g}")
    B = rows
    s = torch.randn(B, E, generator=g, device=dev)
    t = torch.randn(B, E, generator=g, device=dev)
    gd = torch.randn(B, generator=g, device=dev)
    fb, fby = bound(2 * B * E * 4 + B * 4, 8 * B * E)
    bb, bby = bound(3 * B * E * 4 + B * 4, 14 * B * E)
    fwd = {**EMB.INFO_FWD, "shape": [B, E], "max_abs_err": err_f,
           "ms": time_ms(lambda: EMB.emb_dist_fwd_kernel(s, t)),
           "plain_ms": time_ms(lambda: EMB.emb_dist_plain(s, t)),
           "bound_ms": fb, "bound_by": fby,
           "library_ms": time_ms(lambda: _emb_library(s, t))}
    bwd = {**EMB.INFO_BWD, "shape": [B, E], "max_abs_err": err_b,
           "ms": time_ms(lambda: EMB.emb_dist_bwd_kernel(s, t, gd)),
           "plain_ms": time_ms(lambda: EMB.emb_dist_bwd_plain(s, t, gd)),
           "bound_ms": bb, "bound_by": bby, "library_ms": None}
    return [fwd, bwd]


def phase_wire(dev) -> None:
    """The fused device encode (topk_wire kernel + epilogue) against the
    numpy host path: every lane byte-identical except the lse, which
    differs only through the order of the sum."""
    rng = np.random.default_rng(3)
    W = S_P
    outs = {"embedding": rng.normal(size=(W, BATCH, E)),
            "logits": rng.normal(size=(W, BATCH, NUM_LABELS)) * 3,
            "aux_logits": rng.normal(size=(W, H - 1, BATCH, NUM_LABELS)) * 3}
    outs = {k: v.astype(np.float32) for k, v in outs.items()}
    ids = rng.integers(0, 2 ** 63, size=(W, BATCH), dtype=np.uint64)
    codec = TopKCodec(TOPK_K)
    host = codec.decode(codec.encode(0, 0, 0, ids, outs))
    on_card = codec.encode(0, 0, 0, ids, {k: torch.from_numpy(v).to(dev)
                                          for k, v in outs.items()})
    card = codec.decode(on_card)
    check(list(card.arrays) == list(host.arrays), "wire: array order")
    for name, a in host.arrays.items():
        b = card.arrays[name]
        check(a.dtype == b.dtype and a.shape == b.shape, f"wire: {name}")
        if name == "lse":
            check(np.allclose(a, b, rtol=TOL_LSE, atol=TOL_LSE), "wire: lse")
        else:
            check(a.tobytes() == b.tobytes(), f"wire: {name} bytes")
    log(f"wire: device frame ({len(on_card)} B) byte-identical to the host "
        f"path outside the lse lane; lse max|d|="
        f"{np.abs(card.arrays['lse'] - host.arrays['lse']).max():.3g}")


def phase_loss(dev) -> None:
    """Eq. 1 at full width on the kernels (CUDA) against the plain path
    (CPU): loss, every metric and every input gradient."""
    rng = np.random.default_rng(4)
    m = H - 1

    def draw(*shape):
        return rng.normal(size=shape).astype(np.float32)

    student = {"embedding": draw(BATCH, E), "logits": draw(BATCH, NUM_LABELS),
               "aux_logits": draw(m, BATCH, NUM_LABELS)}
    priv = {"logits": draw(BATCH, NUM_LABELS)}
    teachers = {"embedding": draw(1, BATCH, E),
                "logits": draw(1, BATCH, NUM_LABELS) * 3,
                "aux_logits": draw(1, m, BATCH, NUM_LABELS) * 3}
    labels = rng.integers(0, NUM_LABELS, size=BATCH)
    cfg = MHDConfig(num_aux_heads=m, skip_when_student_confident=True)
    res = []
    for d in (dev, torch.device("cpu")):
        st = {k: torch.tensor(v, device=d, requires_grad=True)
              for k, v in student.items()}
        pr = {k: torch.tensor(v, device=d, requires_grad=True)
              for k, v in priv.items()}
        te = {k: torch.tensor(v, device=d) for k, v in teachers.items()}
        loss, metrics = mhd_total_loss(pr, torch.tensor(labels, device=d),
                                       st, te, cfg)
        grads = torch.autograd.grad(
            loss, [st["embedding"], st["aux_logits"], pr["logits"]])
        res.append((loss.item(), {k: v.item() for k, v in metrics.items()},
                    [x.cpu() for x in grads]))
    (l1, m1, g1), (l2, m2, g2) = res
    check(math.isclose(l1, l2, rel_tol=TOL_F32), "loss: total")
    for k in m2:
        check(math.isclose(m1[k], m2[k], rel_tol=TOL_F32, abs_tol=TOL_F32),
              f"loss: {k}")
    for a, b in zip(g1, g2):
        check(close(a, b, TOL_F32, TOL_GRAD_ABS), "loss: gradient")
    log(f"loss: Eq. 1 on the kernels = {l1:.6f}, plain on the CPU = {l2:.6f}"
        f"; metrics and gradients agree")


class RecordingTransport(LoopbackTransport):
    """Loopback that keeps every frame it carries, to decode them after
    the run."""

    def __init__(self):
        super().__init__()
        self.frames = []

    def send(self, src, dst, payload, step):
        self.frames.append(payload)
        super().send(src, dst, payload, step)


def phase_resnet_path(dev) -> tuple:
    t0 = time.perf_counter()
    ds, part = path_data(data)
    test = data.make_synthetic_vision(
        num_labels=NUM_LABELS, samples_per_label=2, image_size=32, noise=1.0,
        seed=1, prototype_seed=0)
    transport = RecordingTransport()
    trainer = DecentralizedTrainer(
        [build_bundle(CFG) for _ in range(K)],
        make_optimizer(OptimizerConfig(**OPTIMIZER)),
        MHDConfig(num_aux_heads=H - 1, **MHD), RunConfig(**RUN),
        {"images": ds.images, "labels": ds.labels}, part.client_indices,
        part.public_indices, complete_graph(K), NUM_LABELS,
        exchange="prediction_topk", comm=CommConfig(**COMM),
        transport=transport)
    torch.cuda.synchronize()
    log(f"resnet path: data + {K} x {CFG.name} init + seed publish "
        f"{time.perf_counter() - t0:.2f} s")
    step_s, history = [], []
    for t in range(STEPS):
        a = time.perf_counter()
        history.append(trainer.step(t))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - a)
    a = time.perf_counter()
    ev = trainer.evaluate({"images": test.images, "labels": test.labels})
    eval_s = time.perf_counter() - a
    counts = ops.launch_counts()

    distilled = [[int(mt[f"c{i}/distill_active"]) for mt in history]
                 for i in range(K)]
    for t, mt in enumerate(history):
        for i in range(K):
            check(math.isfinite(mt[f"c{i}/loss"]),
                  f"resnet path: c{i} loss at {t}")
    check(distilled == REFERENCE_DISTILLED,
          f"resnet path: distilled {distilled} != the reference's schedule "
          f"{REFERENCE_DISTILLED}")
    for name in RESNET_KERNELS:
        check(counts[name] > 0, f"resnet path: kernel {name} launched "
                                f"({counts[name]})")
    W = S_P
    expect = W * topk_frame_nbytes(
        BATCH, TOPK_K, num_heads=H, emb_dim=E, val_bytes=2, idx_bytes=2,
        lse_bytes=4, emb_bytes_per_dim=1, emb_scale_bytes=4, hash_bytes=8) \
        + frame_overhead_nbytes({"sample_ids": 2, "vals": 4, "idx": 4,
                                 "lse": 3, "emb_q": 3, "emb_scale": 2})
    check(len(transport.frames) > 0, "resnet path: frames published")
    for payload in transport.frames:
        msg = trainer.codec.decode(payload)
        check(len(payload) == expect,
              f"resnet path: frame {len(payload)} B != {expect} B")
        check(msg.arrays["vals"].shape == (W, H, BATCH, TOPK_K),
              "resnet path: frame shape")
    meter = trainer.meter
    check(dict(meter.by_edge) == dict(meter.by_edge_delivered),
          "resnet path: delivered == offered on every edge")
    for k, v in ev.items():
        check(math.isfinite(v), f"resnet path: {k} finite")
    med = statistics.median(step_s[1:])
    log(f"resnet path: {STEPS} steps, step time median {med * 1e3:.1f} ms "
        f"(first {step_s[0] * 1e3:.1f} ms; publish steps "
        f"{[round(step_s[t] * 1e3, 1) for t in range(S_P - 1, STEPS, S_P)]}"
        f" ms), evaluate {eval_s:.2f} s")
    log(f"resnet path: distill_active per client and step {distilled}")
    log(f"resnet path: {len(transport.frames)} frames of {expect} B; "
        f"launches {counts}")
    log(f"resnet path: mean/main/beta_sh={ev['mean/main/beta_sh']:.4f} "
        f"mean/aux4/beta_sh={ev['mean/aux4/beta_sh']:.4f} final loss "
        f"{[round(history[-1][f'c{i}/loss'], 4) for i in range(K)]}")
    return trainer, {"counts": counts, "step_s": step_s, "eval_s": eval_s,
            "frame_bytes": expect, "frames": len(transport.frames),
            "distilled": distilled,
            "beta": {k: v for k, v in ev.items() if k.startswith("mean/")},
            "final_loss": [history[-1][f"c{i}/loss"] for i in range(K)]}


def phase_profile(trainer, first: int, steps: int, name: str) -> dict:
    """One more publish round (``steps`` steps from ``first``) of a path
    under torch.profiler — device busy share of the wall time and device
    time by kernel — and under the port's tracer, whose spans give the
    host's time by span name (``wire/decode`` includes the host densify and
    the copy of the dense window to the card; spans nest, and the forward
    spans end when the work is queued, not done). The table goes to
    chiprun_out/profile_<name>.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import tracer

    torch.cuda.synchronize()
    spans = tracer.enable()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(first, first + steps):
            trainer.step(t)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    tracer.disable()
    host: dict = {}
    for ev in spans.events():
        if ev["ph"] == "X":
            row = host.setdefault(ev["name"], {"count": 0, "ms": 0.0})
            row["count"] += 1
            row["ms"] += ev["dur"] * 1e3
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in kernels)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"profile_{name}.txt").write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=60))
    top = [{"kernel": e.key[:90], "calls": e.count,
            "device_us": e.self_device_time_total} for e in kernels[:15]]
    ours = {}
    for info, _ in ops.KERNELS:
        # a wrapper's call launches its CUDA kernel (<name>_kernel) or each
        # of its kernels (<name>_<part>_kernel) once, and once each kernel
        # of SHARED_KERNELS that names it, whose time a launch is its mean
        rows = [e for e in kernels if f"{info['name']}_" in e.key]
        n = max((e.count for e in rows), default=0)
        total = sum(e.self_device_time_total for e in rows) + sum(
            n * e.self_device_time_total / e.count for e in kernels
            for key, users in SHARED_KERNELS.items()
            if key in e.key and info["name"] in users)
        ours[info["name"]] = {"calls": n, "device_us": total,
                              "us_per_call": total / n if n else None}
    log(f"profile {name}: {steps} steps, wall {wall_us / 1e3:.1f} ms, "
        f"device busy {busy_us / 1e3:.1f} ms "
        f"({100 * busy_us / wall_us:.1f} %), "
        f"{sum(e.count for e in kernels)} kernel launches")
    for row in top:
        log(f"  {row['device_us'] / 1e3:8.2f} ms {row['calls']:6d}x "
            f"{row['kernel']}")
    log(f"profile {name}: the port's kernels on the card {ours}")
    log(f"profile {name}: host spans " + ", ".join(
        f"{k} {v['count']}x {v['ms']:.1f} ms"
        for k, v in sorted(host.items(), key=lambda kv: -kv[1]["ms"])))
    return {"wall_us": wall_us, "busy_us": busy_us, "top": top,
            "ours_us_per_call": ours, "host_spans": host,
            "launches": sum(e.count for e in kernels)}


def _finite(metrics: dict, what: str) -> None:
    for k, v in metrics.items():
        check(math.isfinite(v), f"{what}: {k} finite ({v})")


def _timed_run(exp, **kw) -> tuple:
    """``exp.run()`` with the host time between consecutive steps' metrics
    (each step reads its metrics back, so the card is done with it)."""
    stamps, steps = [time.perf_counter()], []

    def on_step(t, m):
        stamps.append(time.perf_counter())
        steps.append(m)

    res = exp.run(on_step=on_step, **kw)
    return res, steps, [b - a for a, b in zip(stamps, stamps[1:])]


def _exp_mhd(dev, triple, resnet_med: float) -> dict:
    """(a) MHD through Experiment(spec).run() at the ResNet path's
    settings, a checkpoint every 6 steps; every launch count set to 0
    just before and read just after."""
    spec = exp_spec("mhd", MHD, STEPS, aux_heads=H - 1,
                    checkpoint_dir=str(EXP_CKPT_DIR),
                    checkpoint_every=EXP_CKPT_EVERY)
    ops.reset_launch_counts()
    res, steps, step_s = _timed_run(EXP.Experiment(spec, data=triple,
                                                   device=dev))
    counts = ops.launch_counts()
    check(len(steps) == STEPS, "exp path: one metrics dict a step")
    for t, m in enumerate(steps):
        _finite(m, f"exp path: step {t}")
    distilled = [[int(m[f"c{i}/distill_active"]) for m in steps]
                 for i in range(K)]
    check(distilled == REFERENCE_DISTILLED,
          f"exp path: distilled {distilled} != the ResNet path's schedule")
    heads = ["main"] + [f"aux{h}" for h in range(1, H)]
    for head in heads:
        for b in ("beta_sh", "beta_priv"):
            check(f"mean/{head}/{b}" in res.metrics,
                  f"exp path: final mean/{head}/{b}")
    _finite(res.metrics, "exp path: final metrics")
    for name in RESNET_KERNELS:
        check(counts[name] > 0, f"exp path: kernel {name} launched "
                                f"({counts[name]})")
    for step in (EXP_CKPT_EVERY, STEPS):
        for i in range(K):
            check((EXP_CKPT_DIR / f"client_{i}" / f"step_{step:010d}" /
                   "state.npz").is_file(), f"exp path: checkpoint {i}@{step}")
    med = statistics.median(step_s[1:])
    log(f"exp path: Experiment(spec).run(), {STEPS} steps, step time median "
        f"{med * 1e3:.1f} ms (the ResNet path's direct trainer "
        f"{resnet_med * 1e3:.1f} ms; runner over direct "
        f"{(med - resnet_med) * 1e3:+.1f} ms; first "
        f"{step_s[0] * 1e3:.1f} ms; the checkpoint step "
        f"{step_s[EXP_CKPT_EVERY] * 1e3:.1f} ms); runner's us_per_step "
        f"{res.us_per_step:.0f}; launches {counts}")
    log(f"exp path: distill_active {distilled}; " + ", ".join(
        f"mean/{h}/beta_sh={res.metrics[f'mean/{h}/beta_sh']:.4f}"
        for h in heads))
    return {"counts": counts, "step_s": step_s,
            "us_per_step": res.us_per_step, "distilled": distilled,
            "beta": {k: v for k, v in res.metrics.items()
                     if k.startswith("mean/")}}


def _exp_restore(dev, triple) -> dict:
    """(b) step 6's checkpoint restored into a freshly set-up adapter:
    params and optimizer state bitwise equal to the files (in the port's
    layout on the card, and in the reference's after params_to_jax), the
    pools reseeded at step 6; then steps 6-11."""
    spec = exp_spec("mhd", MHD, STEPS, aux_heads=H - 1)
    algo = EXP.make_algorithm(spec)
    algo.setup(EXP.Experiment(spec, data=triple,
                              device=dev).build_bindings())
    t0 = time.perf_counter()
    check(algo.restore(str(EXP_CKPT_DIR), EXP_CKPT_EVERY) == EXP_CKPT_EVERY,
          "exp restore: step")
    restore_s = time.perf_counter() - t0
    n_leaves = 0
    for c in algo.trainer.clients:
        saved = load_pytree(str(
            EXP_CKPT_DIR / f"client_{c.client_id}" /
            f"step_{EXP_CKPT_EVERY:010d}" / "state.npz"))
        for prefix, tree in (("params", c.params),
                             ("opt/momentum", c.opt_state["momentum"])):
            want = {k[len(prefix) + 1:]: v for k, v in saved.items()
                    if k.startswith(prefix + "/")}
            check(want.keys() == tree.keys(), f"exp restore: {prefix} keys")
            on_card = params_from_jax(want, device=dev)
            for k, v in params_to_jax(tree).items():
                check(tree[k].device == dev and tree[k].dtype == torch.float32
                      and torch.equal(tree[k], on_card[k])
                      and np.array_equal(v, want[k]),
                      f"exp restore: client {c.client_id} {prefix}/{k} "
                      f"bitwise")
                n_leaves += 1
        check(len(c.pool) > 0 and all(e.step == EXP_CKPT_EVERY
                                      for e in c.pool.entries),
              f"exp restore: client {c.client_id} pool reseeded at step "
              f"{EXP_CKPT_EVERY} ({[e.step for e in c.pool.entries]})")
    steps = [algo.step(t) for t in range(EXP_CKPT_EVERY, STEPS)]
    for t, m in zip(range(EXP_CKPT_EVERY, STEPS), steps):
        _finite(m, f"exp restore: step {t}")
    log(f"exp restore: step {EXP_CKPT_EVERY} into a fresh adapter in "
        f"{restore_s:.2f} s (reseed publish included); {n_leaves} leaves "
        f"bitwise equal to the files; pools reseeded at step "
        f"{EXP_CKPT_EVERY}; steps {EXP_CKPT_EVERY}-{STEPS - 1} finite, "
        f"losses {[round(steps[-1][f'c{i}/loss'], 4) for i in range(K)]}")
    return {"restore_s": restore_s, "leaves": n_leaves}


def _exp_baselines(dev, triple) -> dict:
    """(c) FedAvg (averaging every 2 steps), FedMD, and supervised pooled
    and separate at full width through Experiment(spec).run(). FedAvg's
    average is held against the float64 mean of the params the clients
    held just before it, computed on the card."""
    import repro_torch.core.fedavg as FA

    tree_mean, means = FA.tree_mean, []

    def recording_mean(trees):
        means.append({k: sum(t[k].double() for t in trees) / len(trees)
                      for k in trees[0]})
        return tree_mean(trees)

    out = {}
    cases = [("fedavg", {"average_every": FEDAVG_EVERY}),
             ("fedmd", {}), ("supervised", {"scope": "pooled"}),
             ("supervised", {"scope": "separate"})]
    for algo, params in cases:
        label = params.get("scope", algo)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        FA.tree_mean = recording_mean
        try:
            res, steps, step_s = _timed_run(EXP.Experiment(
                exp_spec(algo, params, EXP_BASELINE_STEPS), data=triple,
                device=dev))
        finally:
            FA.tree_mean = tree_mean
        peak = torch.cuda.max_memory_allocated() / 2**30
        for t, m in enumerate(steps):
            _finite(m, f"{label}: step {t}")
        check("mean/main/beta_sh" in res.metrics, f"{label}: β metrics")
        _finite(res.metrics, f"{label}: final metrics")
        rel = None
        if algo == "fedavg":
            # one mean a step that averages, and one for the final
            # evaluate() (of the global model, the last step's average)
            rounds = EXP_BASELINE_STEPS // FEDAVG_EVERY
            check(len(means) == rounds + 1,
                  f"fedavg: {len(means)} means for {rounds} averages")
            rel = 0.0
            for p in res.trainer.client_params:
                for k, want in means[rounds - 1].items():
                    d = (p[k].double() - want).abs().max()
                    rel = max(rel, float(d / want.abs().max().clamp_min(
                        1e-30)))
            check(rel <= TOL_FEDAVG, f"fedavg: average vs the float64 mean "
                                     f"{rel:.3g} > {TOL_FEDAVG}")
        med = statistics.median(step_s[1:])
        log(f"{label}: {EXP_BASELINE_STEPS} steps, {med * 1e3:.1f} ms a "
            f"step (median; first {step_s[0] * 1e3:.1f} ms), card memory "
            f"peak {peak:.2f} GiB; mean/main/beta_sh="
            f"{res.metrics['mean/main/beta_sh']:.4f}"
            + ("" if rel is None else
               f"; average vs float64 mean max rel {rel:.3g}"))
        out[label] = {"step_s": step_s, "peak_gib": peak,
                      "fedavg_rel": rel,
                      "beta_sh": res.metrics["mean/main/beta_sh"]}
        del res
    return out


def _exp_quickstart(dev) -> dict:
    """(d) examples/port_quickstart.py's spec on the card: the best aux
    head's β_sh must beat the main head's (the paper's claim)."""
    path = ROOT / "examples" / "port_quickstart.py"
    mod_spec = importlib.util.spec_from_file_location("port_quickstart",
                                                      path)
    qs = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(qs)
    t0 = time.perf_counter()
    res = EXP.Experiment(qs.build_spec(), device=dev).run()
    wall = time.perf_counter() - t0
    ev = res.metrics
    _finite(ev, "quickstart")
    aux = max((h for h in qs.HEADS if h != "main"),
              key=lambda h: ev[f"mean/{h}/beta_sh"])
    log(f"quickstart: {res.spec.train.steps} steps in {wall:.1f} s "
        f"({res.us_per_step / 1e3:.1f} ms a step by the runner)\n"
        + qs.beta_table(ev))
    check(ev[f"mean/{aux}/beta_sh"] > ev["mean/main/beta_sh"],
          f"quickstart: {aux} β_sh {ev[f'mean/{aux}/beta_sh']:.3f} does not "
          f"beat main {ev['mean/main/beta_sh']:.3f}")
    return {"wall_s": wall, "us_per_step": res.us_per_step,
            "beta": {k: v for k, v in ev.items() if k.startswith("mean/")}}


def phase_exp_path(dev, resnet_med: float) -> dict:
    """The experiment API on the card: (a) MHD through
    Experiment(spec).run() at the ResNet path's settings, (b) a restore of
    its step-6 checkpoint, (c) the three baselines, (d) the quickstart."""
    if "resnet18" not in EXP.CLIENT_ARCHS:
        EXP.CLIENT_ARCHS.register("resnet18")(
            lambda num_labels, aux_heads, width: resnet18(
                num_labels, num_aux_heads=aux_heads, width=width))
    shutil.rmtree(EXP_CKPT_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    spec = exp_spec("mhd", MHD, STEPS)
    triple = EXP.materialize_data(spec.data, spec.partition, K)
    out = {"mhd": _exp_mhd(dev, triple, resnet_med)}
    torch.cuda.empty_cache()
    out["restore"] = _exp_restore(dev, triple)
    shutil.rmtree(EXP_CKPT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    out["baselines"] = _exp_baselines(dev, triple)
    out["quickstart"] = _exp_quickstart(dev)
    out["seconds"] = time.perf_counter() - t0
    log(f"exp phase: {out['seconds']:.1f} s")
    return out


def phase_adaptive_wire(dev) -> None:
    """The adaptive, delta-compressed wire at the LM path's frame shape
    (W=4 windows, H=3 heads, 1024 positions, V=50280): the frame encoded
    on the card against the same encoder on CPU tensors, where topk_wire
    takes its plain version. Both sides share the entropy and budget
    allocation code, so this holds the kernel and the card's float32
    arithmetic against the CPU's; that allocation is held against the JAX
    package on the CPU (tests/test_torch_lm_wire.py). The decoded arrays
    are byte-identical outside the lse lane (lse within TOL_LSE: the order
    of the sum), k_per_token identical, and the (val, idx) entry streams
    stay within budget·N."""
    g = torch.Generator(device=dev).manual_seed(6)
    W, N = LM_S_P, LM_MAX_POS
    heads = torch.randn(W, LM_H, N, LM_VOCAB, generator=g, device=dev) * 2
    heads[:, :, :N // 4, 7] += 25.0  # a quarter of the tokens near-certain
    outs = {"logits": heads[:, 0], "aux_logits": heads[:, 1:]}
    ids = np.arange(W * LM_BATCH, dtype=np.uint64).reshape(W, LM_BATCH)
    codec = make_codec("prediction_adaptive", CommConfig(**LM_COMM))
    t0 = time.perf_counter()
    on_card = codec.encode(0, 0, 0, ids, outs)
    t_card = time.perf_counter() - t0
    outs_np = {k: v.cpu().numpy() for k, v in outs.items()}
    del heads, outs
    t0 = time.perf_counter()
    on_cpu = codec.encode(0, 0, 0, ids, outs_np)
    t_cpu = time.perf_counter() - t0
    a, b = codec.decode(on_cpu).arrays, codec.decode(on_card).arrays
    check(list(a) == list(b), "adaptive wire: array order")
    for name, x in a.items():
        y = b[name]
        check(x.dtype == y.dtype and x.shape == y.shape,
              f"adaptive wire: {name} shape")
        if name == "lse":
            check(np.allclose(x, y, rtol=TOL_LSE, atol=TOL_LSE),
                  "adaptive wire: lse")
        else:
            check(x.tobytes() == y.tobytes(), f"adaptive wire: {name} bytes")
    kt = b["k_per_token"].astype(np.int64)
    entry_bytes = b["vals"].nbytes + b["idx"].nbytes
    budget = LM_COMM["budget_bytes_per_token"] * W * N
    check(entry_bytes <= budget,
          f"adaptive wire: entries {entry_bytes} B > budget {budget} B")
    log(f"adaptive wire: device frame ({len(on_card)} B, {t_card:.2f} s) "
        f"identical to the same encoder on CPU tensors ({t_cpu:.2f} s) "
        f"outside the lse lane "
        f"(lse max|d|={np.abs(a['lse'] - b['lse']).max():.3g}); k per token "
        f"{kt.min()}..{kt.max()}, mean {kt.mean():.3f}; entries "
        f"{entry_bytes} B <= budget {budget} B")
    RECORD["adaptive_wire"] = {"frame_bytes": len(on_card),
                               "entry_bytes": entry_bytes,
                               "budget_bytes": budget, "card_s": t_card,
                               "cpu_tensors_s": t_cpu}


def phase_lm_path(dev, cfg, label: str, kernels) -> tuple:
    """An LM slice through the user's entry points: three clients of
    ``cfg`` (full-width, full-depth mamba2-370m on the LM path; full-width
    zamba2-7b cut to one period on the hybrid path), MHD over the adaptive
    delta-compressed wire, 12 steps and one evaluate(), with every
    kernel's launch count set to 0 just before (by the caller) and read
    just after; each of ``kernels`` must have launched."""
    t0 = time.perf_counter()
    arrays, test, part = lm_path_data(lm, data)
    transport = RecordingTransport()
    trainer = DecentralizedTrainer(
        [lm.lm_client_bundle(build_bundle(cfg), LM_MAX_POS, LM_POS_SEED)
         for _ in range(LM_K)],
        make_optimizer(OptimizerConfig(**LM_OPTIMIZER)),
        MHDConfig(**LM_MHD), RunConfig(**LM_RUN), arrays,
        part.client_indices, part.public_indices, complete_graph(LM_K),
        LM_DOMAINS, exchange="prediction_adaptive",
        comm=CommConfig(**LM_COMM), transport=transport)
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in trainer.clients[0].params.values())
    log(f"{label} path: data + {LM_K} x {cfg.name} ({n_params / 1e6:.1f} M "
        f"params each) init + seed publish {time.perf_counter() - t0:.2f} s;"
        f" card memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    step_s, history = [], []
    for t in range(LM_STEPS):
        a = time.perf_counter()
        history.append(trainer.step(t))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - a)
    a = time.perf_counter()
    ev = trainer.evaluate(test)
    eval_s = time.perf_counter() - a
    counts = ops.launch_counts()

    distilled = [[int(mt[f"c{i}/distill_active"]) for mt in history]
                 for i in range(LM_K)]
    for t, mt in enumerate(history):
        for i in range(LM_K):
            check(math.isfinite(mt[f"c{i}/loss"]),
                  f"{label} path: c{i} loss at {t}")
    check(distilled == REFERENCE_DISTILLED_LM,
          f"{label} path: distilled {distilled} != the reference's schedule "
          f"{REFERENCE_DISTILLED_LM}")
    for name in kernels:
        check(counts[name] > 0, f"{label} path: kernel {name} launched "
                                f"({counts[name]})")
    check(len(transport.frames) > 0, f"{label} path: frames published")
    W, N = LM_S_P, LM_MAX_POS
    budget = LM_COMM["budget_bytes_per_token"] * W * N
    entry_bytes = []
    for payload in transport.frames:
        arr = trainer.codec.decode(payload).arrays
        check(arr["k_per_token"].shape == (W, N), f"{label} path: frame plan")
        entry_bytes.append(arr["vals"].nbytes + arr["idx"].nbytes)
        check(entry_bytes[-1] <= budget, f"{label} path: frame within budget")
    meter = trainer.meter
    check(dict(meter.by_edge) == dict(meter.by_edge_delivered),
          f"{label} path: delivered == offered on every edge")
    for k, v in ev.items():
        check(math.isfinite(v), f"{label} path: {k} finite")
    med = statistics.median(step_s[1:])
    publish = [round(step_s[t] * 1e3, 1)
               for t in range(LM_S_P - 1, LM_STEPS, LM_S_P)]
    log(f"{label} path: {LM_STEPS} steps, step time median {med * 1e3:.1f} ms "
        f"(first {step_s[0] * 1e3:.1f} ms; publish steps {publish} ms), "
        f"evaluate {eval_s:.2f} s; card memory peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    log(f"{label} path: distill_active per client and step {distilled}")
    log(f"{label} path: {len(transport.frames)} frames, "
        f"{statistics.mean(len(p) for p in transport.frames):.0f} B mean "
        f"({statistics.mean(entry_bytes) / (W * N):.2f} entry B/token, "
        f"budget {LM_COMM['budget_bytes_per_token']}); launches {counts}")
    ends = [[round(mt[f"c{i}/loss"], 4) for i in range(LM_K)]
            for mt in (history[0], history[-1])]
    log(f"{label} path: mean/main/beta_sh={ev['mean/main/beta_sh']:.4f} "
        f"mean/aux2/beta_sh={ev['mean/aux2/beta_sh']:.4f} first and last "
        f"losses {ends}")
    return trainer, {
        "counts": counts, "step_s": step_s, "eval_s": eval_s,
        "frames": len(transport.frames),
        "frame_bytes_mean": statistics.mean(len(p) for p in transport.frames),
        "entry_bytes_per_token": statistics.mean(entry_bytes) / (W * N),
        "distilled": distilled, "params_per_client": n_params,
        "max_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "beta": {k: v for k, v in ev.items() if k.startswith("mean/")},
        "loss": [[mt[f"c{i}/loss"] for i in range(LM_K)] for mt in history]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs on the "
              "GPU only", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    RECORD["device"] = phase_device()
    phase_build()
    kernels = [phase_topk(dev), *phase_dist_ce(dev), *phase_emb_dist(dev),
               *phase_ssd(dev), *phase_flash(dev)]
    phase_wire(dev)
    phase_adaptive_wire(dev)
    phase_loss(dev)
    torch.cuda.empty_cache()
    # each path: every count set to 0 just before it, read just after
    ops.reset_launch_counts()
    trainer, resnet = phase_resnet_path(dev)
    RECORD["profile_resnet"] = phase_profile(trainer, STEPS, S_P, "resnet")
    del trainer
    torch.cuda.empty_cache()
    exp_path = phase_exp_path(dev, statistics.median(resnet["step_s"][1:]))
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    trainer, lm_path = phase_lm_path(dev, LM_CFG, "lm", LM_KERNELS)
    RECORD["profile_lm"] = phase_profile(trainer, LM_STEPS, LM_S_P, "lm")
    del trainer
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    block = ZAMBA_CFG.stages[0].block
    log(f"zamba2 path: {ZAMBA_ARCH} at full width, cut in depth from "
        f"{_ZAMBA_FULL.num_layers} to {ZAMBA_CFG.num_layers} layers (one "
        f"period: {[(sp.attn, sp.ffn, sp.shared_attn) for sp in block]}), "
        f"d_model {ZAMBA_CFG.d_model}, vocab {ZAMBA_VOCAB}")
    ops.reset_launch_counts()
    trainer, zamba_path = phase_lm_path(dev, ZAMBA_CFG, "zamba2",
                                        ZAMBA_KERNELS)
    RECORD["profile_zamba2"] = phase_profile(trainer, LM_STEPS, LM_S_P,
                                             "zamba2")
    del trainer
    paths = {"resnet": resnet, "exp": exp_path["mhd"], "lm": lm_path,
             "zamba2": zamba_path}
    for k in kernels:
        k["launches_by_path"] = {p: r["counts"][k["name"]]
                                 for p, r in paths.items()}
        k["launches"] = sum(k["launches_by_path"].values())
    RECORD.update(kernels=kernels, resnet_path=resnet, exp_path=exp_path,
                  lm_path=lm_path,
                  zamba2_path=zamba_path,
                  seconds=time.perf_counter() - t_start)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(RECORD, indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "launches_by_path")
    print(json.dumps({"kernels": [{k: x[k] for k in keys}
                                  for x in kernels]}))
    log(RECORD["device"]["nvidia_smi"])
    log(f"total {RECORD['seconds']:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
