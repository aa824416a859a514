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
     forward and backward (at arctic-480b's GQA with G = 7 and at
     whisper-large-v3's and llama-3.2-vision-90b's bidirectional, cross
     and causal shapes among its cases; topk_wire and dist_ce also at
     deepseek-v3's 129,280-word vocabulary) — against its plain PyTorch
     version on the card,
     at the main paths' shapes and at edge cases, and times kernel, plain
     version and one library yardstick with CUDA events (median of
     repeated calls), and the launch floor (a one-element fill's device
     time under the profiler); emb_dist, whose launch costs the host more
     than its work costs the card, by a CUDA graph of launches over
     inputs rotated past the L2 (device time) and by the host's clock
     (host time a call);
  4. checks the fused wire encodes on the card byte for byte against the
     host: the fixed top-k frame at the ResNet path's shape against the
     numpy host path, the adaptive delta-compressed frame at the LM path's
     against the same encoder on CPU tensors, and a small one at
     deepseek-v3's vocabulary whose indices travel as u32 (the plain
     topk_wire there;
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
  7. drives the fleet layers (`phase_fleet_path`, on the experiment
     path's ``resnet18`` and the ResNet path's data): (a) the `gossip`
     preset with 4 ResNet-18 clients, 40 wall ticks under lockstep and
     under the scoreboard, client 3 paced at 4x a measured client step;
     (b) lockstep == scoreboard == sync, every param leaf bitwise, K=3
     over 8 steps; (c) a fleet snapshot at wall 6 under rates (1, 1, 4),
     restored into a fresh adapter and continued bitwise, both policies;
     (d) the `churn_ring` preset with 5 clients (join, two kills, a
     restart from a snapshot and a fresh one, the rewire) with a trace,
     whose host time is split by phase. (b) and (c) run cuDNN in its
     deterministic mode, for their own runs only;
  8. drives the socket transport and the gossip launcher
     (`phase_socket_path`, on the same ResNet-18 and data): (a) the
     `gossip_socket` preset (4 clients on a cycle, 40 steps) through
     Experiment(spec).run() over the socket transport and over loopback,
     bitwise equal in cuDNN's deterministic mode; (b) the same spec as 4
     OS processes through launch_gossip, each its own CUDA context on
     this card: 40 steps a rank, every rank distilling and launching
     topk_wire, dist_ce and emb_dist, delivered == offered on every edge;
     (c) scripts/port_gossip_procs.py's churn smoke (rank 1 crashed and
     reaped promptly, the fleet resumed from per-rank snapshots, rank 1
     from step 3). The path's launches are this process's plus those
     every child reports;
  9. drives the LM path: K=3 full-width mamba2-370m clients cut in depth
     to 16 of 48 layers (d_model 1024, vocab 50280, 2 aux heads) exchanging
     entropy-adaptive, delta-compressed next-token predictions, 12 steps
     and one evaluate(), then one profiled publish round;
  10. drives the hybrid path the same way: K=3 full-width zamba2-7b
     clients (d_model 3584, Mamba2 with the shared attention block and the
     dense FFN every 6th layer, vocab 32000) cut in depth to one period of
     six layers;
  11. drives the MoE path (`phase_moe_path`): (a) the `lm_hetero` preset
     (a Mamba2 SSM, a dense transformer and an MoE transformer on the
     adaptive delta wire) through Experiment(spec).run() for its 30 steps
     over its in-process socket transport; (b) the same spec as 3 OS
     processes through launch_gossip (scripts/port_gossip_procs.py's
     --lm-smoke body): in both every client distills, delivered ==
     offered on every edge, the mean frame stays under the budget's
     ceiling, and topk_wire, dist_ce, ssd_scan and flash_attention
     launch; (c) K=2 full-width arctic-480b clients (d_model 7168, 56
     query and 8 KV heads, the dense SwiGLU beside a top-2 MoE, vocab
     32000) cut to one layer of 4 experts, through the LM path's run, each
     step's expert load and dropped share logged, then a profiled publish
     round; (d) one full-width arctic MoE block with all 128 experts (53.55
     GB of f32 weights drawn on the card), forward only, held against a
     float64 evaluation of the experts of 64 sampled tokens and of every
     token with a dropped pair, and timed against its bound. (a)'s
     teacher schedule is held against the one derived on the CPU, and
     every kernel also runs, against its plain version in step 3, at
     lm_hetero's own shapes. Every kernel's launch count is set to 0
     just before each path and read just after;
  12. drives the DeepSeek path (`phase_deepseek_path`): (a) K=2
     full-width deepseek-v3-671b clients (d_model 7168, MLA with 128
     heads, sigmoid top-8 routing with a shared expert) cut to one MoE
     layer of 12 experts at a 32,000-word vocabulary and without MTP,
     through the LM path's run, each step's expert load logged, then a
     profiled publish round; (b) the model bundle's loss with MTP at the
     full 129,280-word vocabulary (one dense and one MoE layer, 3,706.6 M
     params), 3 AdamW steps on one batch, its ce, aux_loss and mtp_ce
     finite and the loss falling; (c) one full-width deepseek MoE block
     with all 256 experts and the shared expert (45.3 GB of f32 weights),
     forward only, held against float64 and timed against its bound;
  13. drives the cross-attention path (`phase_xattn_path`) through the
     training launcher's train state and step (`launch.train`'s
     supervised mode, AdamW, f32): (a) whisper-large-v3 at its published
     widths cut to 16 encoder and 16 decoder layers of 32 + 32 (4 clips of
     1,500 frames under 448 tokens) and
     (b) llama-3.2-vision-90b at its published widths cut to its gated
     cross layer and one self-attention layer at a 32,000-word vocabulary
     (4 x 512 tokens, 1,600 patch embeddings each), a warm-up, 4 timed
     and one profiled step each: losses finite, flash_attention launched
     twice a call forward (remat) and once backward at shapes
     `phase_flash` held, the front ends live (llama-vision's cross gate
     moved from 0, then gradients reaching vision_proj and the cross
     layer's wk; other embeddings or frames change the logits);
  14. drives the serve path (`phase_serve_path`, `repro_torch.serve`):
     (a) the `serve_loop` preset exactly as it is defined, through
     `run_serve_scenario` (4 resnet_tiny clients trained 30 steps on the
     top-k wire, a snapshot, 24 classify and teacher requests against it
     and a generate stream on the reduced minitron-4b engine, 2 feedback
     steps on the served traffic): every request answered, each teacher
     cache hit byte for byte its window's recompute, the front's params
     bitwise the snapshot, the feedback moving every client and metering
     wire bytes, each generated sequence equal to `solo_generate`'s, and
     topk_wire, dist_ce and emb_dist launched at held shapes; (b)
     minitron-4b at its published width and depth (32 layers, d_model
     3,072, 5.76 B f32 params drawn on the card), 16 requests of 16-64
     prompt and 8-32 new tokens on 8 slots under continuous and then
     static admission, and (c) mamba2-370m uncut (48 layers), 8 requests
     on 4 slots: the two admissions' tokens equal, requests equal to
     `solo_generate`'s (a token that differs allowed only where both
     rows' top-2 logits lie within 1e-5, a near-tie, recorded), logits
     finite; tokens a second, the median decode tick against its byte
     bound, prefill ms a prompt token, occupancy and the card's peak;
  15. drives the pod path (`phase_pod_path`, `core.mhd_distributed`):
     K = 2 mamba2-370m clients at full width and depth (48 layers, 471.3 M
     params each, f32) on the paper's fused pod step, SGD momentum, 4 + 4
     sequences of 512 a client, the ring, in an NCCL process group of
     world size 1 (a FileStore under chiprun_out/) with a ("pod", "data",
     "model") mesh of (1, 1, 1) holding both clients: 2 top-k steps first
     run with no group,
     whose params the group's must equal bitwise, then 4 top-k (k = 32)
     and 2 full-exchange steps (losses finite, every client's params
     moved); then `make_mhd_train_step` for 2 steps on one student with
     Δ = 2 teachers' params (the teachers unchanged) (a profiled step of
     each exchange: ablations/pod_step.py). topk_wire, dist_ce,
     emb_dist and ssd_scan must launch, at shapes the kernel phases held.
     World sizes above 1 need a card a rank and run on the CPU only;
  16. drives the tp path (`phase_tp_path`, `launch.steps.make_train_step`
     under `use_mesh`): minitron-4b at its published width (3,072, 24
     heads, 8 KV heads, d_ff 9,216, vocabulary 256,000) cut to TP_DEPTH
     layers, SGD momentum, 2 steps with no mesh, then on a (data, model)
     mesh of (1, 1) in an NCCL group of world size 1 (bitwise equal),
     then on a (1, 2) mesh across two processes on the card over gloo
     (NCCL refuses two ranks on one card), each rank first checking every
     collective the step runs and then holding its half of each cut leaf,
     held against the no-mesh run (metrics 1e-4 relative, params 1e-5);
     flash_attention must launch, at shapes the kernel phase held;
  17. puts each path's step against the H100's roofline
     (`roofline_row`): its FLOPs by type and bytes counted on the meta
     device at the path's own configuration (`repro_torch.roofline`; each
     kernel an entry of its own cost), the compute and memory terms, the
     bound beside the measured median step, model_flops / counted FLOPs,
     and the counted peak beside max_memory_allocated. The MHD paths
     (ResNet, LM, hybrid, MoE, DeepSeek) through collect_obs(trainer,
     tracer=..., with_roofline=True) after their profiled round; the two
     supervised steps of (13) and the decode ticks of (14). One whisper
     step is also counted on the card, real tensors and the kernels
     launching, and must equal its meta count; minitron-4b's counted tick
     bytes must lie in TICK_BYTES_BAND of the hand reckoning; the pod
     path's top-k step and the tp path's step counted on meta. The rows
     go to the record's ``roofline``;
  18. prints one ``{"kernels": [...]}`` line and, last, the device line
     ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and never prints
the last line. The full record also goes to ``chiprun_out/chip_smoke.json``
and the profiles' tables to ``chiprun_out/profile_{resnet,lm,zamba2,moe,
deepseek,whisper,llama-vision}.txt``.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
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
from repro_torch.models import layers as LAYERS  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.config import (Stage, patterned_stages,  # noqa: E402
                                       uniform_stages)
from repro_torch.launch.steps import (init_train_state,  # noqa: E402
                                      make_train_step, train_state_shapes)
from repro_torch.launch.train import supervised_batch  # noqa: E402
from repro_torch.optim import (Optimizer, OptimizerConfig,  # noqa: E402
                               make_optimizer)
from repro_torch.optim.optimizers import global_norm  # noqa: E402
from repro_torch import serve as SERVE  # noqa: E402
from repro_torch.core.runtime import batch_to_device, meta_like  # noqa: E402
from repro_torch.fleet import load_client_params  # noqa: E402
from repro_torch.roofline import op_cost  # noqa: E402
from repro_torch.roofline.analysis import H100, model_flops  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense; `roofline.analysis.H100`):
# HBM3 bytes/s, fp32 (no tensor cores) flop/s, TF32 tensor-core flop/s
HW = H100
PEAK_BYTES, PEAK_F32, PEAK_TF32 = HW.hbm_bw, HW.peak_flops, HW.peak_tf32
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


# the LM path: K=3 full-width mamba2-370m clients (d_model 1024, 32 heads x
# 64, d_state 128, vocab 50280, 2 aux heads, f32) cut in depth from 48
# layers to 24 for margin under the smoke's time limit (with 48 the whole
# smoke took 1,022.7 s of its 1,200 s on a slow host), then to 16 when the
# tp phase brought it to 1,100 s (every layer runs the same kernels at the
# same shapes), on
# lm_hetero's MHD and wire (presets.py:114-145), with S_P and W cut to fit
# memory, 12 steps
LM_ARCH = "mamba2-370m"
_LM_FULL = get_config(LM_ARCH)
LM_DEPTH = 16
LM_CFG = dataclasses.replace(
    _LM_FULL, name=f"{LM_ARCH}-{LM_DEPTH}-layers", num_layers=LM_DEPTH,
    stages=uniform_stages(LM_DEPTH, _LM_FULL.stages[0].block[0])).validate()
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
# an LM client's tokens a step, private and public, for model_flops
LM_TOKENS = (LM_RUN["batch_size"] + LM_RUN["public_batch_size"]) * LM_SEQ_LEN
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


# the MoE path: K=2 full-width arctic-480b clients (d_model 7168; 56
# query heads and 8 KV heads x 128, RoPE, RMSNorm; the dense residual
# SwiGLU, d_ff 4864, beside the MoE on one ffn_norm output: top-2 softmax
# routing, capacity 1.25, router aux 0.01, experts of d_ff 4864; vocab
# 32000, 2 aux heads, f32, remat per unit) cut in depth from 35 layers to
# 1 and in experts from 128 to 4 (the expert work a token is the same:
# E·C = N·k·1.25 whatever E), on the LM path's data, wire and training
# split over 2 clients. moe_impl "a2a" runs the scatter form on one card
MOE_ARCH = "arctic-480b"
_MOE_FULL = get_config(MOE_ARCH)
MOE_K = 2
MOE_CFG = dataclasses.replace(
    _MOE_FULL, name=f"{MOE_ARCH}-1-layer-4-experts", num_layers=1,
    stages=uniform_stages(1, _MOE_FULL.stages[0].block[0]),
    moe=dataclasses.replace(_MOE_FULL.moe, num_experts=4)).validate()
# which client steps distill on the MoE path (K=2): derived on the CPU
# through the JAX package and the port by tests/test_torch_schedule.py
REFERENCE_DISTILLED_MOE = [[1, 1, 1, 1, 1, 1, 1, 0, 1, 1, 1, 1],
                           [1, 1, 1, 1, 0, 1, 1, 0, 0, 1, 0, 0]]
# one arctic MoE block at full width with all 128 experts, forward only:
# 8 x 512 tokens (C = 80), the weights drawn on the card; the kept pairs
# of 64 sampled tokens and of every token with a dropped pair against a
# float64 evaluation of their experts
MOE_BLOCK_TOKENS = (8, 512)
MOE_BLOCK_SAMPLES = 64
# the DeepSeek path: (a) K=2 full-width deepseek-v3-671b clients (d_model
# 7168; MLA with 128 heads, q_lora 1536, kv_lora 512, qk 128 + 64 roped,
# v 128; sigmoid top-8 routing over experts of d_ff 2048 beside one shared
# expert, capacity 1.25, router aux 1e-4; 2 aux heads, f32, remat per
# unit) cut in depth from 61 layers to one MoE layer, in experts from 256
# to 12 (E·C = N·k·1.25 whatever E; at E <= 10 every expert holds every
# token, so top-8 needs E >= 11 for the router to choose and a pair to be
# dropped; 12 adds 176.2 M params a client to 8's), in vocabulary from
# 129,280 to 32,000 (four vocabulary matrices a client at the full one are
# 3.7 G params, 59.3 GB under AdamW: two clients do not fit the card) and
# without MTP (the MHD loss reads no MTP; its leaves would add 8.2 GB of
# AdamW state a client): 1,677.2 M params a client, on the LM path's data,
# wire and training
DS_ARCH = "deepseek-v3-671b"
_DS_FULL = get_config(DS_ARCH)
DS_K = 2
_DS_DENSE, _DS_MOE = (st.block[0] for st in _DS_FULL.stages)
DS_CFG = dataclasses.replace(
    _DS_FULL, name=f"{DS_ARCH}-1-moe-layer-12-experts-32k", num_layers=1,
    stages=uniform_stages(1, _DS_MOE), vocab_size=32_000, mtp=False,
    moe=dataclasses.replace(_DS_FULL.moe, num_experts=12)).validate()
# which client steps distill on the DeepSeek path (K=2): derived on the CPU
# through the JAX package and the port by tests/test_torch_schedule.py
REFERENCE_DISTILLED_DEEPSEEK = [[1, 1, 1, 1, 1, 1, 1, 0, 1, 1, 1, 1],
                                [1, 1, 1, 1, 0, 1, 1, 0, 0, 1, 0, 0]]
# (b) the model bundle's loss with MTP at the full vocabulary: one client
# (129,280 words, one dense and one MoE layer of 8 experts, the MTP block,
# no aux heads, which lm_loss does not read): 3,706.6 M params, 3 AdamW
# steps on one batch of 2 x 512 tokens. Its peak is reckoned at 69.0 GiB;
# (a)'s 12 experts would add 2.6 GiB, so (b) keeps 8 ((a) and (c) route)
DS_LOSS_CFG = dataclasses.replace(
    _DS_FULL, name=f"{DS_ARCH}-2-layers-8-experts-mtp", num_layers=2,
    stages=(Stage(block=(_DS_DENSE,), repeats=1),
            Stage(block=(_DS_MOE,), repeats=1)),
    moe=dataclasses.replace(_DS_FULL.moe, num_experts=8),
    num_aux_heads=0).validate()
DS_LOSS_TOKENS, DS_LOSS_STEPS = (2, 512), 3
DS_LOSS_OPTIMIZER = dict(name="adamw", init_lr=1e-4,
                         total_steps=DS_LOSS_STEPS, grad_clip_norm=1.0)
# (c) one full-width deepseek MoE block, all 256 experts: 8 x 512 tokens
# (C = 160)
DS_BLOCK_TOKENS = (8, 512)
DS_VOCAB = _DS_FULL.vocab_size
# deepseek's vocabulary in the kernel phases, which (a) does not reach:
# one publish of the LM path's rows (topk_wire), one aux level's rows
# (dist_ce), and a small adaptive frame (W = 1, 3 heads, 256 positions)
# whose indices travel as u32
DS_TOPK_ROWS, DS_CE_ROWS, DS_FRAME = LM_TOPK_ROWS, LM_CE_ROWS, (1, 256)
# which client steps distill in lm_hetero's 30 in-process steps (its SSM,
# transformer and MoE clients): derived on the CPU through the JAX package
# and the port by tests/test_torch_exp.py
REFERENCE_DISTILLED_HETERO = [
    [1] * 30,
    [1] * 20 + [0, 0, 1, 0, 1, 1, 1, 1, 0, 0],
    [1] * 30]

# the cross-attention path: supervised training through the launcher's
# train step (`launch.train`), f32, AdamW at lr 1e-4 (its `--optimizer
# adamw`), one warm-up step, XATTN_STEPS timed steps and one profiled step,
# B = 4, each step a fresh batch of the launcher's draws.
# (a) whisper-large-v3 (arXiv:2212.04356) uncut: 32 encoder and 32 decoder
# layers, d_model 1,280, 20 x 64 heads, GELU d_ff 5,120, LayerNorm, tied
# vocabulary of 51,866, 448 learned positions, the encoder's sinusoidal
# ones; 1,500 frames of 1,280 (30 s) under 448 decoder tokens a clip.
# (b) llama-3.2-vision-90b at its published widths (d_model 8,192, 64 query
# and 8 KV heads x 128, SwiGLU d_ff 28,672, RoPE 500,000, vision_proj 7,680
# -> 8,192, 2 aux heads), cut to the first two layers of its five-layer unit
# (the gated cross layer and one self-attention layer, 2 of 100) and to
# vocabulary 32,000 (its four 128,256 x 8,192 matrices alone are 67.2 GB
# under f32 AdamW): 2,822.8 M params; 512 tokens and 1,600 patch
# embeddings of 7,680 a sequence
XATTN_BATCH, XATTN_STEPS, XATTN_SEED = 4, 4, 25
XATTN_OPTIMIZER = dict(name="adamw", init_lr=1e-4,
                       total_steps=XATTN_STEPS + 2)
WHISPER_ARCH = "whisper-large-v3"
_WHISPER_FULL = get_config(WHISPER_ARCH)
# cut to 16 + 16 of its 32 + 32 layers: with the serve phase the whole
# smoke passed the 1,050 s at which this cut was planned (1,065.8 s)
WHISPER_CFG = dataclasses.replace(
    _WHISPER_FULL, name=f"{WHISPER_ARCH}-16+16-layers", num_layers=16,
    stages=uniform_stages(16, _WHISPER_FULL.stages[0].block[0]),
    encoder=dataclasses.replace(_WHISPER_FULL.encoder,
                                num_layers=16)).validate()
WHISPER_FRAMES = 1500
LLAMA_V_ARCH = "llama-3.2-vision-90b"
_LLAMA_V_FULL = get_config(LLAMA_V_ARCH)
LLAMA_V_CFG = dataclasses.replace(
    _LLAMA_V_FULL, name=f"{LLAMA_V_ARCH}-2-layers-32k", num_layers=2,
    stages=patterned_stages(2, _LLAMA_V_FULL.stages[0].block),
    vocab_size=32_000).validate()
LLAMA_V_TOKENS = 512
XATTN_KERNELS = ("flash_attention_fwd", "flash_attention_bwd")
# the serve path: (a) serve_loop as the preset defines it; (b) minitron-4b
# at its published width and depth, 16 requests on 8 slots, prompts of
# 16-64 tokens, 8-32 new tokens, under continuous and static admission;
# (c) mamba2-370m uncut, 8 requests on 4 slots
SERVE_DIR = ROOT / "build" / "serve"
# (label, config, slots, requests, prompt lengths, new tokens, cache_len,
# requests held against solo_generate)
SERVE_LM = [("minitron-4b", get_config("minitron-4b"), 8, 16, (16, 64),
             (8, 32), 96, 2),
            ("mamba2-370m", get_config("mamba2-370m"), 4, 8, (8, 24),
             (4, 16), 40, 8)]
SERVE_SEED = 0
# a token that differs between two decodes of one request is a near-tie
# when, at the first difference, both rows' top-2 logits lie within this
# of each other (relative); a larger gap fails the path
TOL_TIE = 1e-5


# the pod path: the paper's fused pod step (`core.mhd_distributed`) on K=2
# mamba2-370m clients at full width and depth (48 layers, d_model 1,024,
# vocab 50,280, 2 aux heads, f32), SGD momentum at lr 0.01,
# MHDConfig(nu_emb=1, nu_aux=3, 2 aux heads, Δ=1), B = 4 private and
# B_pub = 4 public sequences of 512 a client, the ring; POD_TOPK_STEPS
# steps of the top-k exchange (k = 32), then POD_FULL_STEPS of the full
# one, in an NCCL process group of world size 1 with a ("pod", "data",
# "model") mesh of (1, 1, 1) holding both clients; then
# make_mhd_train_step for POD_MHD_STEPS
# steps on one student with Δ = 2 teachers' params. World sizes above 1
# need a card a rank (NCCL refuses two ranks on one card); they run on
# the CPU over gloo (tests/test_torch_mhd_distributed.py)
POD_CFG = _LM_FULL
POD_K, POD_B, POD_B_PUB, POD_SEQ, POD_TOPK = 2, 4, 4, 512, 32
POD_TOPK_STEPS, POD_FULL_STEPS, POD_MHD_STEPS, POD_SEED = 4, 2, 2, 31
POD_OPTIMIZER = dict(name="sgd_momentum", init_lr=0.01, total_steps=8)
POD_MHD = dict(nu_emb=1.0, nu_aux=3.0, num_aux_heads=2, delta=1)
POD_ROWS = POD_B_PUB * (POD_SEQ - 1)  # B' a client: the public positions
POD_HEADS = POD_MHD["num_aux_heads"] + 1
POD_KERNELS = ("topk_wire", "dist_ce_fwd", "dist_ce_bwd", "emb_dist_fwd",
               "emb_dist_bwd", "ssd_scan_fwd", "ssd_scan_bwd")

# the tp path: `launch.steps.make_train_step` under an active mesh on
# minitron-4b at its published width (d_model 3,072, 24 heads, 8 KV heads
# of 128, d_ff 9,216, vocabulary 256,000, 2 aux heads), cut in depth from
# 32 to TP_DEPTH layers (3.47 B params, 3.15 B of them in the three
# heads), f32, SGD momentum at lr 0.01, TP_B sequences of TP_SEQ a step:
# (1) TP_STEPS steps with no mesh; (2) the same on a (data, model) mesh of
# (1, 1) in an NCCL group of world size 1, bitwise equal to (1); (3) where
# two processes on the one card can run the collectives over gloo (CUDA
# tensors; NCCL refuses two ranks on one card), the same steps on a
# (1, 2) mesh, each rank holding its half of every cut leaf (attention on
# 12 of the 24 heads and 4 of the 8 KV heads, the MLP on 4,608 of the
# 9,216 columns, the heads on 128,000 of the vocabulary), held against (1)
# within the CPU tests' tolerances (metrics 1e-4 relative, params 1e-5).
# Memory (f32): 13.9 GB of params, as much again of gradients and of
# momentum, the optimizer's transient a leaf (the aux heads' 6.3 GB) and
# ~4 GB of activations: ~52 GB for (1) and (2), with (1)'s params kept on
# the host; ~27 GB a rank for (3)
TP_ARCH = "minitron-4b"
_TP_FULL = get_config(TP_ARCH)
TP_DEPTH = 4
TP_CFG = dataclasses.replace(
    _TP_FULL, name=f"{TP_ARCH}-{TP_DEPTH}-layers", num_layers=TP_DEPTH,
    stages=uniform_stages(TP_DEPTH, _TP_FULL.stages[0].block[0])).validate()
TP_B, TP_SEQ, TP_STEPS, TP_SEED, TP_MODEL = 2, 512, 2, 41, 2
# clipping by the global norm at 1.0 (every exp preset's and AdamW's
# default), which the step's gradient norm exceeds: each rank of (3) clips
# its blocks by the whole gradient's norm
TP_OPTIMIZER = dict(name="sgd_momentum", init_lr=0.01, total_steps=8,
                    grad_clip_norm=1.0)
TP_RTOL, TP_ATOL = 1e-4, 1e-5
TP_KERNELS = ("flash_attention_fwd", "flash_attention_bwd")
TP_TIMEOUT = 300.0  # (3): the ranks' hard cap, seconds

def lm_path_data(LM, D, k: int = LM_K):
    """The LM path's train and test token arrays and its partition over
    ``k`` clients, built with the lm and data modules ``LM``, ``D`` (this
    port's, or the JAX package's in a parity test). The test split shares
    the domain languages (``table_seed``), as the reference's runner
    builds it."""
    arrays = LM.make_text_arrays(LM_DOMAINS, LM_SEQS, LM_SEQ_LEN,
                                 LM_DATA_VOCAB, temperature=0.5, seed=0,
                                 table_seed=0)
    test = LM.make_text_arrays(LM_DOMAINS, LM_TEST_SEQS, LM_SEQ_LEN,
                               LM_DATA_VOCAB, temperature=0.5, seed=991,
                               table_seed=0)
    part = D.partition_dataset(arrays["labels"], D.PartitionConfig(
        num_clients=k, num_labels=LM_DOMAINS, **LM_PARTITION))
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
# arctic-480b's attention on the MoE path: B, T, H, KV, d; GQA with a group
# of G = 7 query heads a KV head, the first group size that is not a power
# of two
FLASH_ARCTIC = (8, 512, 56, 8, 128)
# the shapes the cross-attention path launches flash_attention at: whisper
# -large-v3's 1,500-frame encoder (bidirectional), its decoder's cross
# attention over the encoder and its causal self-attention at 448 tokens,
# MHA 20 x 64, B = 4 clips; llama-3.2-vision-90b's gated cross attention
# over 1,600 patches and its causal self-attention, 64 query and 8 KV
# heads x 128 (G = 8), B = 4 sequences of 512 tokens. Each is also timed
# against SDPA with its own causality (``enable_gqa`` at G = 8)
XATTN_FLASH = [("whisper encoder", (4, 1500, 1500, 20, 20, 64), False),
               ("whisper cross", (4, 448, 1500, 20, 20, 64), False),
               ("whisper decoder self", (4, 448, 448, 20, 20, 64), True),
               ("llama-vision cross", (4, 512, 1600, 64, 8, 128), False),
               ("llama-vision self", (4, 512, 512, 64, 8, 128), True)]
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
    ("bf16", (8, 512, 512, 32, 32, 112), True, 0, "bfloat16"),
    ("arctic GQA G=7", (8, 512, 512, 56, 8, 128), True, 0, "float32"),
    # the tp path's minitron-4b: every head on one rank, and a model rank's
    # 12 query and 4 KV heads at model = 2 (G = 3)
    ("minitron-4b", (TP_B, TP_SEQ, TP_SEQ, 24, 8, 128), True, 0, "float32"),
    ("minitron-4b model rank", (TP_B, TP_SEQ, TP_SEQ, 24 // TP_MODEL,
                                8 // TP_MODEL, 128), True, 0, "float32"),
    *[(f"{name}", shape, causal, 0, "float32")
      for name, shape, causal in XATTN_FLASH]]
# the logit softcap c (Gemma 2's attn_logit_softcapping is 50.0): the tp
# path's minitron-4b shape at c = 50 and at c = 5, where tanh saturates
# and its derivative matters, and a sliding-window GQA case; name, shape,
# causal, window, dtype, c. Their q is scaled by SOFTCAP_Q_SCALE so that
# the scores reach the cap
SOFTCAP = 50.0
SOFTCAP_Q_SCALE = 4.0
SOFTCAP_FLASH_CASES = [
    ("minitron-4b softcap 50", (TP_B, TP_SEQ, TP_SEQ, 24, 8, 128), True, 0,
     "float32", SOFTCAP),
    ("minitron-4b softcap 5", (TP_B, TP_SEQ, TP_SEQ, 24, 8, 128), True, 0,
     "float32", 5.0),
    ("GQA d=128 window softcap 50", (1, 2048, 2048, 16, 8, 128), True, 1024,
     "float32", SOFTCAP)]
# the kernels each path runs, and must have launched
RESNET_KERNELS = ("topk_wire", "dist_ce_fwd", "dist_ce_bwd", "emb_dist_fwd",
                  "emb_dist_bwd")
LM_KERNELS = ("topk_wire", "dist_ce_fwd", "dist_ce_bwd", "ssd_scan_fwd",
              "ssd_scan_bwd")
ZAMBA_KERNELS = LM_KERNELS + ("flash_attention_fwd", "flash_attention_bwd")
MOE_KERNELS = ("topk_wire", "dist_ce_fwd", "dist_ce_bwd",
               "flash_attention_fwd", "flash_attention_bwd")
# the serve path's fleet is the ResNet path's kernels; its decode reaches
# no kernel (the reference decodes through einsums)
SERVE_KERNELS = RESNET_KERNELS
# deepseek's MLA is torch matmuls (the reference's einsums), so its path
# runs the wire and distillation kernels only
DS_KERNELS = ("topk_wire", "dist_ce_fwd", "dist_ce_bwd")
# lm_hetero: its SSM client runs ssd_scan, its two transformers attention
HETERO_KERNELS = ZAMBA_KERNELS
HETERO_RANK_KERNELS = {0: LM_KERNELS, 1: MOE_KERNELS, 2: MOE_KERNELS}
# kernels that several wrappers launch, once a call each: ssd_scan's prep
# kernel (C·Bᵀ and the cumsums) runs in the forward and in the backward
SHARED_KERNELS = {"ssd_scan_prep_kernel": ("ssd_scan_fwd", "ssd_scan_bwd")}
# the shapes at which the kernel phases held topk_wire ((rows, V, k)),
# dist_ce ((rows, V, student dtype, teacher dtype)), emb_dist ((rows, D))
# and flash_attention ((B, T, S, H, KV, d, causal, window, dtype, softcap))
# against
# their plain
# versions; each path that launches them checks (KernelShapes) that every
# shape its run launched is one
SHAPES_HELD: dict = {"topk_wire": set(), "dist_ce": set(),
                     "flash_attention": set(), "emb_dist": set()}

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


# inputs rotated over copies that hold at least this many bytes, more
# than the H100's 50 MB L2: each launch finds its inputs in device memory,
# as a path's would after a model step
COLD_BYTES = 64 * 2**20


def cold_copies(make, nbytes: int) -> list:
    """``make()`` (a call's arguments, ``nbytes`` of them) as many times as
    the cold rotation needs, one more than fill COLD_BYTES."""
    return [make() for _ in range(-(-COLD_BYTES // max(nbytes, 1)) + 1)]


def graph_ms(fn, copies: list) -> float:
    """Device ms a call of ``fn``: one round of calls over the rotated
    ``copies`` of its arguments (at least 20 calls), captured in one CUDA
    graph; CUDA events around each replay, the median of 5 over the
    calls. The host's launch cost is left out."""
    launches = max(len(copies), 20)
    for args in copies[:2]:
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    # a graph collected during this capture would invalidate it
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            for i in range(launches):
                fn(*copies[i % len(copies)])
    finally:
        gc.enable()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / launches)
    del graph
    return statistics.median(times)


def host_ms(fn, copies: list, calls: int = 200) -> float:
    """Host ms a call of ``fn``: ``calls`` calls over the rotated copies on
    the host's clock with no synchronise among them (the enqueue rate)."""
    for args in copies[:2]:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(calls):
        fn(*copies[i % len(copies)])
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e3


def bound(nbytes: float, flops: float) -> tuple:
    """The least time of the work, ms: its bytes over the card's memory
    rate or its f32 operations over the f32 peak, the larger."""
    return kernel_bound(({"f32": flops}, nbytes))


def kernel_bound(cost) -> tuple:
    """`bound` of a kernel's own cost, (FLOPs by type, bytes) from its
    module's ``cost`` functions (the roofline's counts of a step book the
    same): the operations' term is Σ flops_type / peak_type."""
    flops, nbytes = cost
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = HW.compute_s({f"flops_{k}": v for k, v in flops.items()}) * 1e3
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


CUDA_SOURCES = ("topk_wire", "emb_dist", "ssd_scan", "flash_attention")


def phase_build() -> None:
    t0 = time.perf_counter()
    build.build_cuda(CUDA_SOURCES)
    RECORD["build_s"] = time.perf_counter() - t0
    log(f"build: nvcc {RECORD['build_s']:.2f} s")
    for name in CUDA_SOURCES:
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
    b_ms, b_by = kernel_bound(TOPK.cost(B, V, k))
    return {"shape": [B, V, k],
            "ms": time_ms(lambda: TOPK.topk_wire_kernel(x, k), iters=iters),
            "plain_ms": time_ms(lambda: TOPK.topk_wire_plain(x, k),
                                iters=iters),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lambda: (torch.topk(x, k, dim=-1),
                                           torch.logsumexp(x, dim=-1)),
                                  iters=iters)}


def preset_shapes(name: str) -> tuple:
    """A fleet or socket path preset's kernel shapes at full ResNet-18
    width: one publish's top-k rows (W·H·B), its k, and the batch B."""
    spec = fleet_preset(name, 1)
    heads = spec.clients[0].aux_heads + 1
    return (spec.wire.horizon * heads * spec.train.public_batch_size,
            spec.wire.topk, spec.train.batch_size)


def hetero_shapes() -> dict:
    """The lm_hetero preset's kernel shapes, from its spec and its
    clients' configs: ssd_scan's (Bt, T, H, P, N) and chunk for each SSM
    client; flash_attention's (B, T, S, H, KV, d) and window for each
    attention layer kind; one publish's top-k rows (W·H·B'), columns and
    k; dist_ce's rows (n_cand·B') and columns."""
    spec = EXP.get_preset("lm_hetero")
    d, tr = spec.data, spec.train
    B, T, V = tr.batch_size, d.seq_len, d.vocab_size
    ssd, flash = [], []
    for c in spec.clients:
        cfg = EXP.CLIENT_ARCHS.get(c.arch)(V, c.aux_heads, c.width)
        kinds = {sp.attn for st in cfg.stages for sp in st.block}
        if "mamba2" in kinds:
            m = cfg.mamba
            ssd.append(((B, T, m.expand * cfg.d_model // m.head_dim,
                         m.head_dim, m.d_state), m.chunk_size))
        for kind in sorted(kinds & {"full", "swa"}):
            case = ((B, T, T, cfg.num_heads, cfg.num_kv_heads,
                     cfg.head_dim), cfg.window_size if kind == "swa" else 0)
            if case not in flash:
                flash.append(case)
    positions = lm.lm_wire_tokens(tr.public_batch_size, T, d.max_positions)
    heads = spec.clients[0].aux_heads + 1
    return {"ssd": ssd, "flash": flash,
            "topk": (spec.wire.horizon * heads * positions, V,
                     spec.wire.topk),
            "dist_ce": (spec.algorithm.params["pool_size"] * positions, V)}


def serve_shapes() -> dict:
    """The serve_loop preset's kernel shapes, from its spec and its
    clients' config: one publish's top-k rows (W·H·B), columns and k;
    dist_ce's rows (pool_size·B) and columns; emb_dist's rows (Δ·B) and
    the clients' embedding width."""
    spec = EXP.get_preset("serve_loop")
    p, B, V = spec.algorithm.params, spec.train.public_batch_size, \
        spec.data.num_labels
    c = spec.clients[0]
    emb = EXP.CLIENT_ARCHS.get(c.arch)(V, c.aux_heads, c.width).embed_dim
    return {"topk": (spec.wire.horizon * (c.aux_heads + 1) * B, V,
                     spec.wire.topk),
            "dist_ce": (p["pool_size"] * B, V),
            "emb_dist": (p["delta"] * B, emb)}


def phase_topk(dev) -> dict:
    """topk_wire against its plain version (values and indices exact, lse
    within TOL_LSE), at the paths' shapes (the fleet and socket paths'
    k=5 publishes, lm_hetero's and serve_loop's among them), at
    deepseek-v3's vocabulary
    (129,280) and at the edges (rows off 16 bytes, ties, -inf, k up to V
    and past the one-pass kernel's 256); timed at the LM path's publish
    shape, with the hybrid, deepseek and ResNet paths' beside it; then the
    launch floor."""
    g = torch.Generator(device=dev).manual_seed(0)
    rows = 4 * H * BATCH  # W·H·B of one ResNet publish
    err = 0.0
    # the fleet path's gossip and the socket path's gossip_socket publish
    fleet = [(name, torch.randn(n, NUM_LABELS, generator=g, device=dev) * 3,
              k) for name in ("gossip", "gossip_socket")
             for n, k, _ in [preset_shapes(name)]]
    # the MoE path's lm_hetero publish, the serve path's serve_loop one
    n_het, v_het, k_het = hetero_shapes()["topk"]
    n_srv, v_srv, k_srv = serve_shapes()["topk"]
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
              LM_COMM["topk"]), *fleet, ("lm_hetero", torch.randn(
                  n_het, v_het, generator=g, device=dev) * 3, k_het),
             ("serve_loop", torch.randn(n_srv, v_srv, generator=g,
                                        device=dev) * 3, k_srv),
             # deepseek-v3's vocabulary: one LM publish's rows of 505 KB
             ("deepseek", torch.randn(DS_TOPK_ROWS, DS_VOCAB, generator=g,
                                      device=dev) * 3, LM_COMM["topk"]),
             # the pod path's top-k pack: a client's heads' public rows
             ("pod", torch.randn(POD_HEADS * POD_ROWS, POD_CFG.vocab_size,
                                 generator=g, device=dev) * 3, POD_TOPK)]
    for name, x, k in cases:
        v, i, lse = TOPK.topk_wire_kernel(x, k)
        pv, pi, plse = TOPK.topk_wire_plain(x, k)
        torch.cuda.synchronize()
        check(torch.equal(v, pv), f"topk_wire {name}: values exact")
        check(torch.equal(i, pi), f"topk_wire {name}: indices exact")
        check(close(lse, plse, TOL_LSE, TOL_LSE), f"topk_wire {name}: lse")
        err = max(err, maxerr(v, pv), maxerr(lse, plse))
        SHAPES_HELD["topk_wire"].add((*x.shape, k))
        log(f"topk_wire {name} {tuple(x.shape)} k={k}: idx/vals exact, "
            f"lse max|d|={maxerr(lse, plse):.3g}")
    lm = _topk_timing(cases[1][1], LM_COMM["topk"], iters=20)
    zamba = _topk_timing(cases[2][1], LM_COMM["topk"], iters=20)
    deepseek = _topk_timing(cases[-1][1], LM_COMM["topk"], iters=10)
    resnet = _topk_timing(cases[0][1], TOPK_K, iters=50)
    pod = _topk_timing(cases[-1][1], POD_TOPK, iters=10)
    log(f"topk_wire timing at the pod path's {pod['shape']}: "
        f"{pod['ms']:.3f} ms (plain {pod['plain_ms']:.3f}, library "
        f"{pod['library_ms']:.3f}, bound {pod['bound_ms']:.4f})")
    log(f"topk_wire timing: LM shape {lm['ms']:.3f} ms (plain "
        f"{lm['plain_ms']:.3f}, library {lm['library_ms']:.3f}, bound "
        f"{lm['bound_ms']:.4f}); zamba2 shape {zamba['ms']:.3f} ms (plain "
        f"{zamba['plain_ms']:.3f}, library {zamba['library_ms']:.3f}, bound "
        f"{zamba['bound_ms']:.4f}); deepseek shape {deepseek['ms']:.3f} ms "
        f"(plain {deepseek['plain_ms']:.3f}, library "
        f"{deepseek['library_ms']:.3f}, bound {deepseek['bound_ms']:.4f}); "
        f"ResNet shape {resnet['ms']:.3f} ms")
    RECORD["launch_floor"] = floor = _launch_floor(dev)
    log(f"launch floor: a one-element fill takes {floor['device_us']:.2f} us "
        f"of device time under the profiler ({floor['launches']} launches), "
        f"{floor['ms'] * 1e3:.2f} us a call by CUDA events")
    return {**TOPK.INFO, **lm, "max_abs_err": err,
            "at_zamba2_shape": zamba, "at_deepseek_shape": deepseek,
            "at_resnet_shape": resnet, "at_pod_shape": pod}


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
    decay, and lm_hetero's SSM client (N = 16, T = 12 within one
    chunk)."""
    g = torch.Generator(device=dev).manual_seed(5)
    Bt, T, H, P, N = SSD_SHAPE
    cases = [("path", (Bt, T, H, P, N), "model", SSD_CHUNK),
             ("zamba2 N=64", SSD_ZAMBA_SHAPE, "model", SSD_CHUNK),
             ("T=500", (2, 500, 4, P, N), "model", SSD_CHUNK),
             ("T=1", (2, 1, 4, P, N), "model", SSD_CHUNK),
             ("decay", (2, 512, H, P, N), "decay", SSD_CHUNK),
             ("s=0", (2, 512, 4, P, N), "s=0", SSD_CHUNK),
             *(("lm_hetero", shape, "model", chunk)
               for shape, chunk in hetero_shapes()["ssd"])]
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
    _, _, states = SSD.ssd_scan_fwd_kernel(x, dt, A, B, C, D,
                                           save_states=True)
    dy = torch.randn_like(x)
    # the function's bounds from the kernels' own costs (`ssd_scan.cost_fwd`,
    # `cost_bwd`): every input read once, every output written once, and
    # the products the function needs at the kernel's chunk length, by
    # 3xTF32 (the forward's with and without the chunk states the training
    # call saves); the f32 FMA figure stands beside it
    check(L == SSD.CHUNK, f"ssd_scan chunk {L} == SSD.CHUNK {SSD.CHUNK}")
    fwd_c, bwd_c = SSD.cost_fwd(*shape), SSD.cost_bwd(*shape)
    fl_fwd, fl_bwd = fwd_c[0]["tf32x3"], bwd_c[0]["tf32x3"]
    fb, fby = kernel_bound(fwd_c)
    fb_states, _ = kernel_bound(SSD.cost_fwd(*shape, save_states=True))
    bb, bby = kernel_bound(bwd_c)
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


def _flash_bounds(B, T, S, H, KV, d, causal, window, elem):
    """(forward, backward) bounds from the kernels' own costs
    (`flash_attention.cost_fwd`, `cost_bwd`): bytes with every input read
    once and every output written once, over 3.35 TB/s; operations over
    495 TFLOP/s of TF32, the type both kernels compute in (3xTF32),
    counting the pairs inside the mask only. Also the f32 operations of
    each."""
    args = (B, T, S, H, KV, d, causal, window, elem)
    fwd, bwd = FA.cost_fwd(*args), FA.cost_bwd(*args)
    return (kernel_bound(fwd), kernel_bound(bwd), fwd[0]["tf32x3"],
            bwd[0]["tf32x3"])


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


def _sdpa(q, k, v, causal: bool = True):
    """The library yardstick: one scaled_dot_product_attention call on the
    same tensors, viewed (B, H, T, d), causal or not as the case; GQA
    (fewer KV heads) through ``enable_gqa``."""
    gqa = {"enable_gqa": True} if k.shape[2] != q.shape[2] else {}
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=causal, **gqa)


def _flash_timing(dev, g, B, T, H, d, iters: int, KV: int = 0, S: int = 0,
                  causal: bool = True, softcap: float = 0.0) -> tuple:
    """Kernel, plain and library times of the forward and of the backward
    alone at (B, T, S, H, d), f32, causal unless asked; MHA, or GQA with
    ``KV`` heads; S = T unless given; under a ``softcap`` (q scaled by
    SOFTCAP_Q_SCALE, as the checks have it), where SDPA has no call that
    computes the function: library_ms None."""
    KV, S = KV or H, S or T
    q, do = (torch.randn(B, T, H, d, generator=g, device=dev)
             for _ in range(2))
    if softcap:
        q = q * SOFTCAP_Q_SCALE
    k, v = (torch.randn(B, S, KV, d, generator=g, device=dev)
            for _ in range(2))
    o, lse = FA.flash_attention_fwd_kernel(q, k, v, causal=causal,
                                           softcap=softcap)
    (fb, fby), (bb, bby), fl_f, fl_b = _flash_bounds(B, T, S, H, KV, d,
                                                     causal, 0, 4)
    # the plain and library backward alone: autograd on one saved graph
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o_plain = FA.flash_attention_plain(*leaves, causal=causal,
                                       softcap=softcap)
    o_lib = None if softcap else _sdpa(*leaves, causal=causal)

    def plain_bwd():
        torch.autograd.grad(o_plain, leaves, do, retain_graph=True)

    def lib_bwd():
        torch.autograd.grad(o_lib, leaves, do.transpose(1, 2),
                            retain_graph=True)

    # the forward computes whole tiles, at mma.sync's rate at best
    tiles = 4 * B * H * d * fwd_tile_pairs(T, S, causal, 0, d)
    shape = [B, T, S, H, KV, d, causal]
    fwd = {"shape": shape, "gflop": fl_f / 1e9,
           "mma_sync_floor_ms": 3 * tiles / MMA_SYNC_TF32 * 1e3,
           "ms": time_ms(lambda: FA.flash_attention_fwd_kernel(
               q, k, v, causal=causal, softcap=softcap), iters=iters),
           "plain_ms": time_ms(lambda: FA.flash_attention_plain(
               q, k, v, causal=causal, softcap=softcap), iters=iters,
               warmup=2),
           "bound_ms": fb, "bound_by": fby,
           "library_ms": None if softcap else time_ms(
               lambda: _sdpa(q, k, v, causal), iters=iters)}
    bwd = {"shape": shape, "gflop": fl_b / 1e9,
           "ms": time_ms(lambda: FA.flash_attention_bwd_kernel(
               q, k, v, o, lse, do, causal=causal, window=0,
               softcap=softcap), iters=iters),
           "plain_ms": time_ms(plain_bwd, iters=iters, warmup=2),
           "bound_ms": bb, "bound_by": bby,
           "library_ms": None if softcap else time_ms(lib_bwd, iters=iters)}
    if softcap:
        fwd["softcap"] = bwd["softcap"] = softcap
    del leaves, o_plain, o_lib
    return fwd, bwd


def _sdpa_kernels(dev, g, B, T, H, d, KV: int = 0) -> list:
    """The names of the device kernels that one _sdpa call runs at (B, T,
    H, d) with ``KV`` heads (MHA if 0), from a profiler pass: what the
    library yardstick is."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    q = torch.randn(B, T, H, d, generator=g, device=dev)
    k, v = (torch.randn(B, T, KV or H, d, generator=g, device=dev)
            for _ in range(2))
    _sdpa(q, k, v)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _sdpa(q, k, v)
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA})


def _flash_lse_plain(q, k, causal: bool, window: int,
                     softcap: float = 0.0) -> torch.Tensor:
    """Each row's logsumexp of the masked scaled scores (capped to c
    tanh(s / c) under a softcap c), (B, H, T): the oracle of the forward
    kernel's second output. Masked scores are -1e30, so a row with no key
    in its band has lse -1e30."""
    B, T, H, d = q.shape
    S, KV = k.shape[1], k.shape[2]
    s = torch.einsum("btkgd,bskd->bkgts", q.reshape(B, T, KV, H // KV, d),
                     k) / math.sqrt(d)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
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
    bf16 inputs, arctic-480b's GQA with G = 7, the cross-attention
    path's five shapes (XATTN_FLASH), lm_hetero's two transformers (d
    = 32, GQA G = 2, T = 12, with and without its sliding window) and the
    logit softcap (SOFTCAP_FLASH_CASES); each case's shape (and cap) goes
    into SHAPES_HELD. Timed at the path's shape, at zamba2's context, T =
    4096, at arctic's shape against SDPA with ``enable_gqa``, at
    XATTN_FLASH's shapes against SDPA with each case's causality, and at
    the tp path's shapes with and without the softcap (SDPA has none)."""
    g = torch.Generator(device=dev).manual_seed(7)
    names = ("o", "lse", "dq", "dk", "dv")
    record, err_f, err_b = [], 0.0, 0.0
    hetero = [(f"lm_hetero window={w}", shape, True, w, "float32", 0.0)
              for shape, w in hetero_shapes()["flash"]]
    for name, (b, t, s_, h, kv, dd), causal, window, dt_name, cap in [
            *[(*c, 0.0) for c in FLASH_CASES], *hetero,
            *SOFTCAP_FLASH_CASES]:
        dt = getattr(torch, dt_name)
        q = torch.randn(b, t, h, dd, generator=g, device=dev).to(dt)
        if cap:
            q = q * SOFTCAP_Q_SCALE
        k = torch.randn(b, s_, kv, dd, generator=g, device=dev).to(dt)
        v = torch.randn(b, s_, kv, dd, generator=g, device=dev).to(dt)
        do = torch.randn(b, t, h, dd, generator=g, device=dev).to(dt)
        o, lse = FA.flash_attention_fwd_kernel(q, k, v, causal=causal,
                                               window=window, softcap=cap)
        grads = FA.flash_attention_bwd_kernel(q, k, v, o, lse, do,
                                              causal=causal, window=window,
                                              softcap=cap)
        torch.cuda.synchronize()
        SHAPES_HELD["flash_attention"].add(flash_key(q, k, v, causal,
                                                     window, cap))
        leaves = [x.double().requires_grad_() for x in (q, k, v)]
        o2 = FA.flash_attention_plain(*leaves, causal=causal, window=window,
                                      softcap=cap)
        grads2 = torch.autograd.grad(o2, leaves, do.double())
        lse2 = _flash_lse_plain(leaves[0].detach(), leaves[1].detach(),
                                causal, window, cap)
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
            f"{(b, t, s_, h, kv, dd)} causal={causal} window={window} "
            f"softcap={cap} {dt}: "
            + " ".join(f"{nm} {e:.3g}" for nm, e in zip(names, errs))
            + f" (max|d| / max|plain|, tolerance {tol})")
        record.append({"case": name, "shape": [b, t, s_, h, kv, dd],
                       "causal": causal, "window": window, "softcap": cap,
                       "dtype": str(dt),
                       "tol": tol, "rel": dict(zip(names, errs)),
                       "abs": dict(zip(names, abs_errs))})
        del q, k, v, do, o, lse, grads, leaves, o2, lse2, grads2
        torch.cuda.empty_cache()
    RECORD["flash_attention_cases"] = record
    fwd, bwd = _flash_timing(dev, g, *FLASH_SHAPE, iters=20)
    fwd_l, bwd_l = _flash_timing(dev, g, *FLASH_LONG, iters=10)
    B, T, H, KV, d = FLASH_ARCTIC
    fwd_a, bwd_a = _flash_timing(dev, g, B, T, H, d, iters=20, KV=KV)
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
    for nm, x in (("fwd", fwd_a), ("bwd", bwd_a)):
        log(f"flash_attention timing {nm} at arctic's (B, T, H, KV, d) = "
            f"{FLASH_ARCTIC}: {x['ms']:.3f} ms (plain {x['plain_ms']:.3f}, "
            f"library (SDPA, enable_gqa) {x['library_ms']:.3f}, 3xTF32 "
            f"bound {x['bound_ms']:.4f} {x['bound_by']}, "
            f"{x['gflop']:.2f} GFLOP)")
    at_x = {"fwd": {}, "bwd": {}}
    for name, (b, t, s_, h, kv, dd), causal in XATTN_FLASH:
        xf, xb = _flash_timing(dev, g, b, t, h, dd, iters=10, KV=kv, S=s_,
                               causal=causal)
        at_x["fwd"][name], at_x["bwd"][name] = xf, xb
        torch.cuda.empty_cache()
        for nm, x in (("fwd", xf), ("bwd", xb)):
            log(f"flash_attention timing {nm} at {name} (B, T, S, H, KV, d) "
                f"= {(b, t, s_, h, kv, dd)} causal={causal}: "
                f"{x['ms']:.3f} ms (plain {x['plain_ms']:.3f}, library "
                f"(SDPA{', enable_gqa' if kv != h else ''}) "
                f"{x['library_ms']:.3f}, 3xTF32 bound {x['bound_ms']:.4f} "
                f"{x['bound_by']}, {x['gflop']:.2f} GFLOP)")
    at_tp = {"fwd": {}, "bwd": {}}
    for name, h, kv, cap in (
            ("minitron-4b", 24, 8, 0.0),
            (f"minitron-4b softcap {SOFTCAP:g}", 24, 8, SOFTCAP),
            ("minitron-4b model rank", 24 // TP_MODEL, 8 // TP_MODEL, 0.0)):
        xf, xb = _flash_timing(dev, g, TP_B, TP_SEQ, h, 128, iters=20, KV=kv,
                               softcap=cap)
        at_tp["fwd"][name], at_tp["bwd"][name] = xf, xb
        for nm, x in (("fwd", xf), ("bwd", xb)):
            lib = ("none (SDPA applies no softcap)" if cap else
                   f"{x['library_ms']:.3f}")
            log(f"flash_attention timing {nm} at {name} (B, T, H, KV, d) = "
                f"{(TP_B, TP_SEQ, h, kv, 128)}: {x['ms']:.3f} ms (plain "
                f"{x['plain_ms']:.3f}, library (SDPA, enable_gqa) {lib}, "
                f"3xTF32 bound {x['bound_ms']:.4f} {x['bound_by']}, "
                f"{x['gflop']:.2f} GFLOP)")
    RECORD["sdpa_kernels"] = _sdpa_kernels(dev, g, *FLASH_SHAPE)
    RECORD["sdpa_kernels_arctic"] = _sdpa_kernels(dev, g, B, T, H, d, KV)
    log(f"flash_attention library yardstick: scaled_dot_product_attention "
        f"at {FLASH_SHAPE} causal f32 runs {RECORD['sdpa_kernels']}; at "
        f"arctic's {FLASH_ARCTIC} it runs {RECORD['sdpa_kernels_arctic']}")
    return [{**FA.INFO_FWD, **fwd, "max_abs_err": err_f,
             "at_T4096": fwd_l, "at_arctic": fwd_a, "at_xattn": at_x["fwd"],
             "at_tp": at_tp["fwd"]},
            {**FA.INFO_BWD, **bwd, "max_abs_err": err_b,
             "at_T4096": bwd_l, "at_arctic": bwd_a,
             "at_xattn": at_x["bwd"], "at_tp": at_tp["bwd"]}]


def _dist_ce_library(s, t):
    logp = F.log_softmax(s, dim=-1)
    p_t = F.softmax(t, dim=-1)
    return -(p_t * logp).sum(-1), p_t.amax(-1), logp.amax(-1).exp()


def _dist_ce_timing(dev, g, B, V, s_dt, iters: int,
                    t_dt=torch.float32) -> tuple:
    s = (torch.randn(B, V, generator=g, device=dev) * 3).to(s_dt)
    t = (torch.randn(B, V, generator=g, device=dev) * 3).to(t_dt)
    gce = torch.randn(B, generator=g, device=dev)
    stats = DCE.dist_ce_fwd_kernel(s, t)[3]
    sb, tb = s.element_size(), t.element_size()
    fb, fby = kernel_bound(DCE.cost_fwd(B, V, sb, tb))
    bb, bby = kernel_bound(DCE.cost_bwd(B, V, sb, tb))
    fwd = {"shape": [B, V], "student_dtype": str(s_dt),
           "teacher_dtype": str(t_dt),
           "ms": time_ms(lambda: DCE.dist_ce_fwd_kernel(s, t), iters=iters),
           "plain_ms": time_ms(lambda: DCE.dist_ce_fwd_plain(s, t),
                               iters=iters),
           "bound_ms": fb, "bound_by": fby,
           "library_ms": time_ms(lambda: _dist_ce_library(s, t),
                                 iters=iters)}
    bwd = {"shape": [B, V], "student_dtype": str(s_dt),
           "teacher_dtype": str(t_dt),
           "ms": time_ms(lambda: DCE.dist_ce_bwd_kernel(s, t, stats, gce),
                         iters=iters),
           "plain_ms": time_ms(
               lambda: DCE.dist_ce_bwd_plain(s, t, stats, gce), iters=iters),
           "bound_ms": bb, "bound_by": bby, "library_ms": None}
    return fwd, bwd


def phase_dist_ce(dev) -> list:
    """dist_ce forward and backward against the plain versions: f32, bf16,
    ties, a large V, the socket and serve paths' rows, and the LM path's,
    lm_hetero's, the V = 32,000 paths' and deepseek-v3's rows (bf16
    student logits against f32 decoded teacher rows, V = 50280, 64, 32,000
    and 129,280); timed at the LM path's shape, with the V = 32,000
    paths', deepseek's and the ResNet path's beside it."""
    g = torch.Generator(device=dev).manual_seed(1)
    rows = 2 * BATCH  # n_cand·B of one aux level
    socket_rows = 2 * preset_shapes("gossip_socket")[2]
    err_f, err_b = 0.0, 0.0
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("slice", rows, NUM_LABELS, f32, f32, 3.0),
             ("gossip_socket", socket_rows, NUM_LABELS, f32, f32, 3.0),
             ("large", rows, 32768, f32, f32, 3.0),
             ("bf16", rows, NUM_LABELS, bf16, bf16, 3.0),
             ("ties", rows, NUM_LABELS, f32, f32, 0.0),
             ("lm", LM_CE_ROWS, LM_VOCAB, bf16, f32, 3.0),
             ("lm_hetero", *hetero_shapes()["dist_ce"], bf16, f32, 3.0),
             ("serve_loop", *serve_shapes()["dist_ce"], f32, f32, 3.0),
             # the hybrid, MoE and DeepSeek paths' rows at V = 32,000
             ("zamba2, arctic, deepseek (a)", LM_CE_ROWS, ZAMBA_VOCAB, bf16,
              f32, 3.0),
             ("deepseek", DS_CE_ROWS, DS_VOCAB, bf16, f32, 3.0),
             # the pod step's rows (a client's public positions, the
             # teacher or self bf16 logits) and make_mhd_train_step's
             # (Δ + 1 = 3 candidates' decoded f32 rows)
             ("pod", POD_ROWS, POD_CFG.vocab_size, bf16, bf16, 3.0),
             ("pod mhd_train_step", 3 * POD_ROWS, POD_CFG.vocab_size, bf16,
              f32, 3.0)]
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
        SHAPES_HELD["dist_ce"].add((B, V, str(s_dt), str(t_dt)))
        log(f"dist_ce {name} ({B}, {V}) {s_dt}/{t_dt}: fwd max|d|="
            f"{max(maxerr(a, b) for a, b in zip(out[:3], ref[:3])):.3g} "
            f"bwd max|d|={maxerr(gs, gs_ref):.3g}")
    lm_f, lm_b = _dist_ce_timing(dev, g, LM_CE_ROWS, LM_VOCAB, bf16, 20)
    v32_f, v32_b = _dist_ce_timing(dev, g, LM_CE_ROWS, ZAMBA_VOCAB, bf16, 20)
    ds_f, ds_b = _dist_ce_timing(dev, g, DS_CE_ROWS, DS_VOCAB, bf16, 20)
    rn_f, rn_b = _dist_ce_timing(dev, g, rows, NUM_LABELS, f32, 50)
    # the pod path's two shapes (the pod step's bf16 teacher rows,
    # make_mhd_train_step's Δ + 1 = 3 candidates' f32 rows)
    pod = {name: _dist_ce_timing(dev, g, B, POD_CFG.vocab_size, bf16, 10,
                                 t_dt)
           for name, B, t_dt in (("pod", POD_ROWS, bf16),
                                 ("pod mhd_train_step", 3 * POD_ROWS, f32))}
    for name, (x, y) in pod.items():
        log(f"dist_ce timing at {name} {x['shape']} {x['student_dtype']} / "
            f"{x['teacher_dtype']}: fwd {x['ms']:.3f} ms, bwd "
            f"{y['ms']:.3f} ms (plain {x['plain_ms']:.3f} / "
            f"{y['plain_ms']:.3f}, library {x['library_ms']:.3f}, bounds "
            f"{x['bound_ms']:.4f} / {y['bound_ms']:.4f})")
    log(f"dist_ce timing: LM shape fwd {lm_f['ms']:.3f} ms bwd "
        f"{lm_b['ms']:.3f} ms (plain {lm_f['plain_ms']:.3f} / "
        f"{lm_b['plain_ms']:.3f}); V = 32,000 paths' shape fwd "
        f"{v32_f['ms']:.3f} bwd {v32_b['ms']:.3f} (plain "
        f"{v32_f['plain_ms']:.3f} / {v32_b['plain_ms']:.3f}, library "
        f"{v32_f['library_ms']:.3f}, bounds {v32_f['bound_ms']:.4f} / "
        f"{v32_b['bound_ms']:.4f}); deepseek shape fwd {ds_f['ms']:.3f} bwd "
        f"{ds_b['ms']:.3f} (plain {ds_f['plain_ms']:.3f} / "
        f"{ds_b['plain_ms']:.3f}, library {ds_f['library_ms']:.3f}, bounds "
        f"{ds_f['bound_ms']:.4f} / {ds_b['bound_ms']:.4f}); ResNet shape fwd "
        f"{rn_f['ms']:.3f} bwd {rn_b['ms']:.3f}")
    return [{**DCE.INFO_FWD, **lm_f, "max_abs_err": err_f,
             "at_v32000_shape": v32_f, "at_deepseek_shape": ds_f,
             "at_resnet_shape": rn_f,
             "at_pod_shapes": {n: x for n, (x, _) in pod.items()}},
            {**DCE.INFO_BWD, **lm_b, "max_abs_err": err_b,
             "at_v32000_shape": v32_b, "at_deepseek_shape": ds_b,
             "at_resnet_shape": rn_b,
             "at_pod_shapes": {n: y for n, (_, y) in pod.items()}}]

def _emb_library(s, t):
    return (F.normalize(s, dim=-1) - F.normalize(t, dim=-1)).square().sum(-1)


def phase_emb_dist(dev) -> list:
    """emb_dist forward and backward against the plain versions at the
    paths' rows and the edges (s == t, E = 8,192, an odd E on the scalar
    path, a bf16 student against an f32 teacher); timed at the ResNet
    path's and both pod rows (`_emb_timing`)."""
    g = torch.Generator(device=dev).manual_seed(2)
    rows = BATCH  # Δ·B
    err_f, err_b = 0.0, 0.0
    f32 = torch.float32
    for name, B, D in (("slice", rows, E), ("large", 256, 8192),
                       ("s==t", rows, E),
                       ("gossip_socket", preset_shapes("gossip_socket")[2],
                        E), ("serve_loop", *serve_shapes()["emb_dist"]),
                       # the pod step's Δ·B' = B' rows, make_mhd_train_step's
                       # Δ = 2
                       ("pod", POD_ROWS, POD_CFG.d_model),
                       ("pod mhd_train_step", 2 * POD_ROWS,
                        POD_CFG.d_model),
                       # one element a load: E odd
                       ("odd E", 37, 1001),
                       # a bf16 student against an f32 teacher
                       ("bf16 student", 64, 1024)):
        s_dt = torch.bfloat16 if name == "bf16 student" else f32
        s = torch.randn(B, D, generator=g, device=dev).to(s_dt)
        t = s.clone() if name == "s==t" else torch.randn(
            B, D, generator=g, device=dev)
        gd = torch.randn(B, generator=g, device=dev)
        o, o_ref = EMB.emb_dist_fwd_kernel(s, t), EMB.emb_dist_plain(s, t)
        gs = EMB.emb_dist_bwd_kernel(s, t, gd)
        gs_ref = EMB.emb_dist_bwd_plain(s, t, gd)
        torch.cuda.synchronize()
        check(close(o, o_ref, TOL_F32, TOL_F32), f"emb_dist {name}")
        if s_dt == f32:
            check(close(gs, gs_ref, TOL_F32, TOL_GRAD_ABS),
                  f"emb_dist bwd {name}")
            err_b = max(err_b, maxerr(gs, gs_ref))
        else:
            check(gs.dtype == s_dt and close(
                gs, gs_ref, TOL_BF16_GRAD_REL, TOL_BF16_GRAD_ABS),
                f"emb_dist bwd {name}")
        if name == "s==t":
            check(bool((o == 0).all()), "emb_dist s==t: exactly 0")
        err_f = max(err_f, maxerr(o, o_ref))
        SHAPES_HELD["emb_dist"].add((B, D))
        log(f"emb_dist {name} ({B}, {D}): fwd max|d|={maxerr(o, o_ref):.3g}"
            f" bwd max|d|={maxerr(gs, gs_ref):.3g}")
    fwd, bwd = _emb_timing(dev, g, rows, E)
    # the pod path's rows, where emb_dist does real work
    pod = {name: _emb_timing(dev, g, B, POD_CFG.d_model)
           for name, B in (("pod", POD_ROWS),
                           ("pod mhd_train_step", 2 * POD_ROWS))}
    for name, (x, y) in {"resnet": (fwd, bwd), **pod}.items():
        for what, z in (("fwd", x), ("bwd", y)):
            lib = "none" if z["library_ms"] is None \
                else f"{z['library_ms']:.4f}"
            log(f"emb_dist {what} timing at {name} {z['shape']}: device "
                f"{z['ms']:.4f} ms by graph, cold (bound {z['bound_ms']:.5f}"
                f": {100 * z['bound_ms'] / z['ms']:.1f} %), host "
                f"{z['host_ms']:.4f} ms a call, a call's events "
                f"{z['event_ms']:.4f} ms; plain {z['plain_ms']:.4f}, "
                f"library {lib} (by graph)")
    return [{**EMB.INFO_FWD, **fwd, "max_abs_err": err_f,
             "at_pod_shapes": {n: x for n, (x, _) in pod.items()}},
            {**EMB.INFO_BWD, **bwd, "max_abs_err": err_b,
             "at_pod_shapes": {n: y for n, (_, y) in pod.items()}}]


def _emb_timing(dev, g, B: int, D: int) -> tuple:
    """emb_dist's forward and backward at (B, D) f32, with their bounds:
    ``ms``, the kernel's device time (`graph_ms`: a CUDA graph of
    launches over inputs rotated past the L2); ``host_ms``, the wrapper's
    host time a call (`host_ms`); ``event_ms``, a call's CUDA-event
    median (`time_ms`, the host's launch cost included, as timed before);
    the plain version and the library call by graph too."""
    def make():
        return (torch.randn(B, D, generator=g, device=dev),
                torch.randn(B, D, generator=g, device=dev),
                torch.randn(B, generator=g, device=dev))

    copies = cold_copies(make, 2 * B * D * 4)
    pairs = [c[:2] for c in copies]
    s, t, gd = copies[0]
    fb, fby = kernel_bound(EMB.cost_fwd(B, D))
    bb, bby = kernel_bound(EMB.cost_bwd(B, D))
    fwd = {"shape": [B, D],
           "ms": graph_ms(EMB.emb_dist_fwd_kernel, pairs),
           "host_ms": host_ms(EMB.emb_dist_fwd_kernel, pairs),
           "event_ms": time_ms(lambda: EMB.emb_dist_fwd_kernel(s, t)),
           "plain_ms": graph_ms(EMB.emb_dist_plain, pairs),
           "bound_ms": fb, "bound_by": fby,
           "library_ms": graph_ms(_emb_library, pairs)}
    bwd = {"shape": [B, D],
           "ms": graph_ms(EMB.emb_dist_bwd_kernel, copies),
           "host_ms": host_ms(EMB.emb_dist_bwd_kernel, copies),
           "event_ms": time_ms(lambda: EMB.emb_dist_bwd_kernel(s, t, gd)),
           "plain_ms": graph_ms(EMB.emb_dist_bwd_plain, copies),
           "bound_ms": bb, "bound_by": bby, "library_ms": None}
    return fwd, bwd


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


# ---------------------------------------------------------------------------
# the roofline of each path's step
# ---------------------------------------------------------------------------

# each profiled round's tracer (phase_profile), whose runtime/distill
# spans give collect_obs the achieved rate of each distill update
PROFILE_SPANS: dict = {}
# each path's step against the H100's roofline, in the order measured
ROOFLINE: dict = {}
# minitron-4b's counted tick bytes over the hand reckoning of its tick (the
# weights it multiplies, one embedding row a slot, the caches read once and
# written once): the eager decode also copies every cache three times a
# tick (index_put's new cache, the units' stack, a clone), each a read and
# a write. The band is written in PERF.md before the call.
TICK_BYTES_BAND = (1.00, 1.15)


def roofline_row(label: str, cost: dict, counted_peak: float,
                 step_ms: float, max_memory_gib: float,
                 model_fl=None, extra=None) -> dict:
    """A path's step against the card: its counted FLOPs by type and
    bytes, the compute term (Σ flops_type / peak_type) and the memory term
    (bytes / 3.35 TB/s), the bound (the larger), the measured median step
    and the share bound / measured, model_flops / counted flops, and the
    counted peak (arguments + the step's own peak) beside
    torch.cuda.max_memory_allocated."""
    compute_ms = HW.compute_s(cost) * 1e3
    memory_ms = cost["bytes"] / HW.hbm_bw * 1e3
    bound_ms = max(compute_ms, memory_ms)
    row = {"flops": cost["flops"], "bytes": cost["bytes"],
           **{k: cost[k] for k in cost if k.startswith("flops_")},
           "compute_ms": compute_ms, "memory_ms": memory_ms,
           "dominant": "compute" if compute_ms >= memory_ms else "memory",
           "bound_ms": bound_ms, "measured_ms": step_ms,
           "share": bound_ms / step_ms,
           "model_flops": model_fl,
           "model_over_counted": model_fl / cost["flops"] if model_fl
           else None,
           "counted_peak_gib": counted_peak / 2**30,
           "max_memory_gib": max_memory_gib, **(extra or {})}
    log(f"roofline {label}: {cost['flops'] / 1e12:.4f} TFLOP (f32 "
        f"{cost.get('flops_f32', 0) / 1e12:.4f}, 3xTF32 "
        f"{cost.get('flops_tf32x3', 0) / 1e12:.4f}, bf16 "
        f"{cost.get('flops_bf16', 0) / 1e12:.4f}), {cost['bytes'] / 1e9:.3f}"
        f" GB; compute {compute_ms:.3f} ms, memory {memory_ms:.3f} ms "
        f"({row['dominant']}); bound {bound_ms:.3f} ms against a measured "
        f"{step_ms:.3f} ms: {100 * row['share']:.1f} % of the roofline; "
        f"model/counted "
        + (f"{row['model_over_counted']:.3f}" if model_fl else "n/a")
        + f"; counted peak {row['counted_peak_gib']:.2f} GiB, "
        f"max_memory_allocated {max_memory_gib:.2f} GiB")
    ROOFLINE[label] = row
    return row


def mhd_roofline(label: str, trainer, cfg, step_s: list,
                 max_memory_gib: float, tokens=None) -> dict:
    """An MHD path's fleet step against the roofline, through the user's
    entry point: ``collect_obs(trainer, tracer=<the profiled round's>,
    with_roofline=True)`` counts one client's distill update on meta copies
    of its arguments (every client of a path runs one bundle). A fleet step
    is every local client's update; its counted peak, each client's state
    and one update's arguments and own peak. The achieved rate of the
    ``runtime/distill`` spans is a floor: the sync loop reads a step's
    metrics after its publish round, where the span ends. ``tokens``: an
    LM client's tokens a step (private + public), for model_flops."""
    from repro_torch.obs import collect_obs

    t0 = time.perf_counter()
    rows = collect_obs(trainer, tracer=PROFILE_SPANS.pop(label),
                       with_roofline=True).roofline
    check(len(rows) == 1, f"roofline {label}: one bundle, got {list(rows)}")
    (name, r), = rows.items()
    count_s = time.perf_counter() - t0
    K = len(trainer.local)
    cost = {k: K * v for k, v in r.items()
            if k == "bytes" or k.startswith("flops")}
    n = sum(v.numel() for v in trainer.clients[0].params.values())
    model_fl = K * model_flops(cfg, n, tokens, "train") if tokens else None
    peak = K * r["state_bytes"] + r["argument_bytes"] - r["state_bytes"] \
        + r["peak_bytes"]
    return roofline_row(label, cost, peak, statistics.median(step_s[1:])
                        * 1e3, max_memory_gib, model_fl, {
                            "clients": K, "bundle": name, "update": r,
                            "count_s": count_s})


def phase_profile(trainer, first: int, steps: int, name: str,
                  by_shape: bool = False) -> dict:
    """One more publish round (``steps`` steps from ``first``) of a path
    under torch.profiler — device busy share of the wall time and device
    time by kernel — and under the port's tracer, whose spans give the
    host's time by span name (``wire/decode`` includes the host densify and
    the copy of the dense window to the card; spans nest, and the forward
    spans end when the work is queued, not done). ``by_shape`` also
    records the ops' input shapes and sums the device time of the kernels
    each PyTorch op launches itself by op and shapes (which matmul is an
    expert product, which a vocabulary head). The table goes to
    chiprun_out/profile_<name>.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import tracer

    torch.cuda.synchronize()
    spans = tracer.enable()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=by_shape) as prof:
        t0 = time.perf_counter()
        for t in range(first, first + steps):
            trainer.step(t)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    tracer.disable()
    PROFILE_SPANS[name] = spans
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
    by_op = []
    if by_shape:
        rows = sorted((e for e in prof.key_averages(group_by_input_shape=True)
                       if e.device_type == DeviceType.CPU
                       and e.self_device_time_total > 0),
                      key=lambda e: -e.self_device_time_total)
        by_op = [{"op": e.key, "shapes": str(e.input_shapes)[:160],
                "calls": e.count, "device_us": e.self_device_time_total}
               for e in rows[:30]]
        for row in by_op[:15]:
            log(f"  {row['device_us'] / 1e3:8.2f} ms {row['calls']:6d}x "
                f"{row['op']} {row['shapes']}")
    return {"wall_us": wall_us, "busy_us": busy_us, "top": top,
            "ours_us_per_call": ours, "host_spans": host, "ops": by_op,
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


def _resnet18_arch(num_labels: int, aux_heads: int, width: int):
    return resnet18(num_labels, num_aux_heads=aux_heads, width=width)


def register_resnet18() -> None:
    """ResNet-18 as the experiment API's client arch ``resnet18`` (the
    reference registers no such arch). Also run by every gossip child
    (`launch_gossip`'s ``child_init``), in its own process."""
    if "resnet18" not in EXP.CLIENT_ARCHS:
        EXP.CLIENT_ARCHS.register("resnet18")(_resnet18_arch)


def phase_exp_path(dev, resnet_med: float) -> dict:
    """The experiment API on the card: (a) MHD through
    Experiment(spec).run() at the ResNet path's settings, (b) a restore of
    its step-6 checkpoint, (c) the three baselines, (d) the quickstart."""
    register_resnet18()
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


# the fleet path: the gossip and churn_ring presets at full ResNet-18 width
# on the ResNet path's data (1000 classes, 32x32, 8 images a class), the
# schedulers against the sync loop, and fleet snapshots
FLEET_TICKS = 40  # (a) wall ticks under each policy
FLEET_EQ_STEPS = 8  # (b) the bitwise anchor's steps
FLEET_SKEW_TICKS, FLEET_SKEW_CUT = 12, 6  # (c) a cut between pool rounds
FLEET_CHURN_STEPS = 20  # (d)
FLEET_DIR = ROOT / "build" / "fleet"
FLEET_KERNELS = ("topk_wire", "dist_ce_fwd", "dist_ce_bwd", "emb_dist_fwd",
                 "emb_dist_bwd")


class Deterministic:
    """cuDNN's deterministic algorithms (and no autotuning) for a run that
    is compared bit for bit; the earlier settings come back after it."""

    def __enter__(self):
        self._saved = (torch.backends.cudnn.deterministic,
                       torch.backends.cudnn.benchmark)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False

    def __exit__(self, *exc):
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = self._saved


def fleet_preset(name: str, steps: int, **train) -> "EXP.ExperimentSpec":
    """A preset at full ResNet-18 width (``resnet18``, width 64, its aux
    heads) on the ResNet path's data: its algorithm, topology, schedule,
    transport, wire, gate and batches as they are; the labels split over
    its clients; ``steps`` in place of its own."""
    spec = EXP.get_preset(name)
    k = spec.num_clients
    return dataclasses.replace(
        spec,
        data=EXP.DataSpec(num_labels=NUM_LABELS, samples_per_label=8,
                          image_size=32, noise=1.0, test_samples_per_label=2,
                          seed=0),
        partition=dataclasses.replace(spec.partition,
                                      labels_per_client=NUM_LABELS // k),
        clients=EXP.ExperimentSpec.uniform_fleet(
            k, arch="resnet18", aux_heads=spec.clients[0].aux_heads,
            width=CFG.width),
        train=dataclasses.replace(spec.train, steps=steps, **train))


def _params_equal(a, b) -> int:
    """Every param leaf of two trainers' clients compared bit for bit;
    returns the number of leaves (raises on the first difference)."""
    n = 0
    for ca, cb in zip(a.clients, b.clients):
        for k, v in ca.params.items():
            check(torch.equal(v, cb.params[k]),
                  f"client {ca.client_id} {k} bitwise")
            n += 1
    return n


def _fleet_gossip(dev) -> dict:
    """(a) `gossip` with 4 ResNet-18 clients, 40 wall ticks under lockstep
    and under the scoreboard, client 3 paced at 4x a measured client
    step."""
    base = fleet_preset("gossip", FLEET_TICKS)
    triple = EXP.materialize_data(base.data, base.partition,
                                  base.num_clients)
    warm = dataclasses.replace(base, train=dataclasses.replace(
        base.train, steps=4))
    _, _, tick_s = _timed_run(EXP.Experiment(warm, data=triple, device=dev))
    # ticks 1-3: the three fast clients step, the straggler does not
    client_ms = statistics.median(tick_s[1:]) / 3 * 1e3
    pace_ms = 4 * client_ms
    out = {"client_step_ms": client_ms, "pace_ms": pace_ms}
    for mode in ("lockstep", "scoreboard"):
        spec = dataclasses.replace(base, schedule=dataclasses.replace(
            base.schedule, mode=mode, pace_ms=(0.0, 0.0, 0.0, pace_ms)))
        t0 = time.perf_counter()
        res, steps, tick_s = _timed_run(EXP.Experiment(spec, data=triple,
                                                       device=dev))
        wall = time.perf_counter() - t0
        sched = res.scheduler
        check(sched.mode == mode, f"gossip {mode}: scheduler")
        for t, m in enumerate(steps):
            _finite(m, f"gossip {mode}: tick {t}")
        _finite(res.metrics, f"gossip {mode}: final metrics")
        local = list(sched.local_steps)
        check(local[3] >= FLEET_TICKS // 4 and
              min(local[:3]) >= FLEET_TICKS,
              f"gossip {mode}: local steps {local}")
        meter = res.trainer.meter
        fresh = sched.freshness_report()
        row = {
            "wall_s": wall, "tick_ms_median":
                statistics.median(tick_s[1:]) * 1e3,
            "tick_ms": [x * 1e3 for x in tick_s],
            "local_steps": local,
            "fast_done_s": max(sched.resolved_at[:3]) - t0,
            "straggler_done_s": sched.resolved_at[3] - t0,
            "stale_skipped": sum(m.get(f"c{i}/stale_skipped", 0.0)
                                 for m in steps for i in range(4)),
            "distill_active": sum(m.get(f"c{i}/distill_active", 0.0)
                                  for m in steps for i in range(4)),
            "offered_bytes": meter.total_bytes,
            "delivered_bytes": meter.delivered_bytes,
            "dropped_messages": res.transport.dropped_count,
            "messages": dict(meter.summary()),
            "freshness": {str(c): f for c, f in fresh.items()},
            "stats": dict(sched.stats)}
        check(meter.delivered_bytes <= meter.total_bytes,
              f"gossip {mode}: delivered <= offered")
        out[mode] = row
        log(f"fleet (a) gossip {mode}: {FLEET_TICKS} ticks in {wall:.2f} s, "
            f"tick median {row['tick_ms_median']:.1f} ms, local steps "
            f"{local}, fast clients done {row['fast_done_s']:.2f} s, "
            f"straggler {row['straggler_done_s']:.2f} s; stale_skipped "
            f"{row['stale_skipped']:.0f}, distill_active "
            f"{row['distill_active']:.0f}; bytes offered "
            f"{meter.total_bytes}, delivered {meter.delivered_bytes}, "
            f"messages dropped {row['dropped_messages']}; stats "
            f"{row['stats']}")
        log(f"fleet (a) gossip {mode}: meter {row['messages']}; freshness "
            f"{fresh}")
    log(f"fleet (a): a client step {client_ms:.1f} ms (median of the "
        f"unpaced ticks 1-3 over their 3 clients), pace_ms of client 3 "
        f"{pace_ms:.1f}")
    return out


def _fleet_anchor(dev, triple) -> dict:
    """(b) K=3 ResNet-18, 8 steps, equal rates, loopback, unbounded
    staleness and run-ahead: lockstep == scoreboard == sync, every param
    leaf and every step metric, in deterministic cuDNN mode."""
    runs = {}
    with Deterministic():
        for mode in ("sync", "lockstep", "scoreboard"):
            spec = exp_spec("mhd", MHD, FLEET_EQ_STEPS, aux_heads=H - 1)
            spec = dataclasses.replace(spec,
                                       schedule=EXP.ScheduleSpec(mode=mode))
            res, steps, _ = _timed_run(EXP.Experiment(spec, data=triple,
                                                      device=dev))
            runs[mode] = (res, [{k: v for k, v in m.items()
                                 if not k.endswith("local_step")}
                                for m in steps])
    sync_res, sync_steps = runs["sync"]
    leaves = 0
    for mode in ("lockstep", "scoreboard"):
        res, steps = runs[mode]
        check(steps == sync_steps, f"fleet (b): {mode} step metrics == sync")
        check(res.metrics == sync_res.metrics,
              f"fleet (b): {mode} final metrics == sync")
        leaves = _params_equal(res.trainer, sync_res.trainer)
    log(f"fleet (b): lockstep == scoreboard == sync over {FLEET_EQ_STEPS} "
        f"steps, {leaves} param leaves and every step metric bitwise "
        f"(cudnn.deterministic)")
    return {"leaves": leaves}


def _fleet_skew_snapshot(dev, triple) -> dict:
    """(c) rates (1, 1, 4): a fleet snapshot at wall 6 — between the
    straggler's pool rounds (every 16 ticks) and not a multiple of S_P —
    restored into a fresh adapter; the continued run equals the
    uninterrupted one bitwise, under both policies."""
    out = {}
    for mode in ("lockstep", "scoreboard"):
        spec = exp_spec("mhd", MHD, FLEET_SKEW_TICKS, aux_heads=H - 1)
        spec = dataclasses.replace(
            spec, schedule=EXP.ScheduleSpec(mode=mode, rates=(1, 1, 4)),
            wire=dataclasses.replace(spec.wire, horizon=4 * S_P))
        d = FLEET_DIR / f"skew_{mode}"
        shutil.rmtree(d, ignore_errors=True)

        def adapter():
            algo = EXP.make_algorithm(spec)
            algo.setup(EXP.Experiment(spec, data=triple,
                                      device=dev).build_bindings())
            return algo

        with Deterministic():
            a = adapter()
            full = []
            for t in range(FLEET_SKEW_TICKS):
                if t == FLEET_SKEW_CUT:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    a.snapshot(str(d), FLEET_SKEW_CUT)
                    save_s = time.perf_counter() - t0
                full.append(a.step(t))
            b = adapter()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            check(b.restore_snapshot(str(d)) == FLEET_SKEW_CUT,
                  f"fleet (c) {mode}: restored step")
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            check(b.scheduler.local_steps == [FLEET_SKEW_CUT] * 2 + [2],
                  f"fleet (c) {mode}: clocks {b.scheduler.local_steps}")
            rest = [b.step(t) for t in range(FLEET_SKEW_CUT,
                                             FLEET_SKEW_TICKS)]
        check(rest == full[FLEET_SKEW_CUT:],
              f"fleet (c) {mode}: continued metrics == uninterrupted")
        leaves = _params_equal(a.trainer, b.trainer)
        nbytes = sum(f.stat().st_size for f in d.rglob("*") if f.is_file())
        out[mode] = {"save_s": save_s, "restore_s": restore_s,
                     "bytes": nbytes, "leaves": leaves,
                     "local_steps": list(b.scheduler.local_steps)}
        log(f"fleet (c) {mode}: snapshot at wall {FLEET_SKEW_CUT} under "
            f"rates (1, 1, 4): save {save_s:.3f} s, restore "
            f"{restore_s:.3f} s, {nbytes / 2**20:.1f} MiB on disk; ticks "
            f"{FLEET_SKEW_CUT}-{FLEET_SKEW_TICKS - 1} and {leaves} leaves "
            f"bitwise equal to the uninterrupted run; local steps "
            f"{b.scheduler.local_steps}")
        shutil.rmtree(d, ignore_errors=True)
    return out


def _fleet_churn(dev) -> dict:
    """(d) `churn_ring` with 5 ResNet-18 clients: client 4 joins, client
    1 is killed and restarts from a fleet snapshot, client 2 is killed and
    restarts fresh, the ring rewires to two hops; traced."""
    from repro_torch.obs import load_trace
    from repro_torch.obs.metrics import phase_attribution

    snap_dir, trace_dir = FLEET_DIR / "churn_snapshots", FLEET_DIR / "trace"
    for d in (snap_dir, trace_dir):
        shutil.rmtree(d, ignore_errors=True)
    base = fleet_preset("churn_ring", FLEET_CHURN_STEPS,
                        snapshot_dir=str(snap_dir), snapshot_every=8,
                        trace_dir=str(trace_dir))
    rewire = next(ev for ev in base.churn.events if ev.kind == "rewire")
    events = (EXP.ChurnEventSpec(kind="join", step=4, client=4),
              EXP.ChurnEventSpec(kind="kill", step=8, client=1),
              EXP.ChurnEventSpec(kind="kill", step=10, client=2),
              EXP.ChurnEventSpec(kind="restart", step=12, client=1,
                                 from_snapshot=True),
              EXP.ChurnEventSpec(kind="restart", step=16, client=2,
                                 from_snapshot=False),
              dataclasses.replace(rewire, step=18))
    spec = dataclasses.replace(base, churn=EXP.ChurnSpec(events=events))
    triple = EXP.materialize_data(spec.data, spec.partition,
                                  spec.num_clients)
    res, steps, step_s = _timed_run(EXP.Experiment(spec, data=triple,
                                                   device=dev))
    for t, m in enumerate(steps):
        _finite(m, f"churn: step {t}")
    alive = [m["fleet/alive"] for m in steps]
    check(alive == [4.0] * 4 + [5.0] * 4 + [4.0] * 2 + [3.0] * 2 +
          [4.0] * 4 + [5.0] * 4, f"churn: alive {alive}")
    applied = res.algorithm.churn.applied
    check(applied[3] == "restart(c1)@12 from snapshot step 8" and
          applied[4] == "restart(c2)@16 fresh", f"churn: applied {applied}")
    check(any(m.get("c1/distill_active", 0.0) for m in steps[13:]),
          "churn: the restored client distills again")
    meter = res.trainer.meter
    check(meter.tombstoned_bytes > 0, "churn: mail to the dead tombstoned")
    check(meter.delivered_bytes + meter.tombstoned_bytes ==
          meter.total_bytes, "churn: every offered byte accounted")
    trace = load_trace(str(trace_dir / "trace.json"))
    phases = phase_attribution(trace["traceEvents"])
    row = next(iter(phases.values()))
    obs = {k: v for k, v in res.metrics.items() if k.startswith("obs/")}
    check(obs.get("obs/trace/dropped") == 0.0, "churn: no trace dropped")
    log(f"fleet (d) churn_ring: {FLEET_CHURN_STEPS} steps, step median "
        f"{statistics.median(step_s[1:]) * 1e3:.1f} ms; applied {applied}; "
        f"alive {alive}; tombstoned {meter.tombstoned_bytes} B of "
        f"{meter.total_bytes} offered")
    log("fleet (d) host time by phase (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in row.items() if v))
    return {"step_s": step_s, "applied": applied, "alive": alive,
            "phases": row, "trace_events": len(trace["traceEvents"]),
            "tombstoned_bytes": meter.tombstoned_bytes,
            "offered_bytes": meter.total_bytes}


def phase_fleet_path(dev) -> dict:
    """The fleet layers on the card: (a) `gossip` under lockstep and
    scoreboard with a paced straggler, (b) lockstep == scoreboard == sync
    bitwise, (c) a mid-cadence snapshot under 4x skew resumed bitwise, (d)
    `churn_ring` with joins, kills, both restarts, the rewire and a trace.
    Every launch count is set to 0 just before and read just after; the
    ResNet path's kernels must have launched. Needs `phase_exp_path`'s
    ``resnet18`` registration."""
    t0 = time.perf_counter()
    spec = exp_spec("mhd", MHD, STEPS)
    triple = EXP.materialize_data(spec.data, spec.partition, K)
    ops.reset_launch_counts()
    out = {"gossip": _fleet_gossip(dev)}
    torch.cuda.empty_cache()
    out["anchor"] = _fleet_anchor(dev, triple)
    out["skew_snapshot"] = _fleet_skew_snapshot(dev, triple)
    torch.cuda.empty_cache()
    out["churn"] = _fleet_churn(dev)
    out["counts"] = ops.launch_counts()
    for name in FLEET_KERNELS:
        check(out["counts"][name] > 0,
              f"fleet path: kernel {name} launched ({out['counts'][name]})")
    out["seconds"] = time.perf_counter() - t0
    log(f"fleet phase: {out['seconds']:.1f} s; launches {out['counts']}")
    return out


# the socket path: gossip_socket (4 ResNet-18 clients on a cycle, top-k 5
# in f16, int8 embeddings, S_P 5, horizon 20, 40 steps) on the fleet
# path's data, in-process over one socket transport and then one OS
# process (one CUDA context) per client through launch_gossip; the churn
# smoke of scripts/port_gossip_procs.py at the same width (its scoreboard
# smoke, a paced straggler across processes, left the smoke to keep it in
# its time: `python scripts/port_gossip_procs.py --scoreboard-smoke` runs
# it, and phase_fleet_path holds the scoreboard in-process)
SOCKET_DIR = ROOT / "build" / "socket"
SOCKET_KERNELS = FLEET_KERNELS
SOCKET_TIMEOUT = 240.0  # (b): every launch's hard cap, seconds
SOCKET_CHURN_TIMEOUT = 120.0  # (c): each of its two launches


def _gossip_script():
    path = ROOT / "scripts" / "port_gossip_procs.py"
    mod_spec = importlib.util.spec_from_file_location("port_gossip_procs",
                                                      path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def _add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def _sum_counts(results: dict) -> dict:
    total: dict = {}
    for r in results.values():
        _add_counts(total, r["kernel_launches"])
    return total


def _socket_inprocess(dev, spec, triple) -> dict:
    """(a) gossip_socket through Experiment(spec).run(), once over the
    socket transport and once over loopback, in cuDNN's deterministic
    mode: the same params bit for bit and the same teacher schedule."""
    runs = {}
    with Deterministic():
        for kind in ("socket", "loopback"):
            sp = dataclasses.replace(spec, transport=EXP.TransportSpec(
                kind=kind))
            t0 = time.perf_counter()
            res, steps, step_s = _timed_run(EXP.Experiment(sp, data=triple,
                                                           device=dev))
            runs[kind] = (res, steps, step_s, time.perf_counter() - t0)
    (sock, s_steps, s_step_s, s_wall), (loop, l_steps, _, l_wall) = \
        runs["socket"], runs["loopback"]
    for t, m in enumerate(s_steps):
        _finite(m, f"socket (a): step {t}")
    check(s_steps == l_steps, "socket (a): step metrics == loopback")
    leaves = _params_equal(sock.trainer, loop.trainer)
    schedule = [[int(m[f"c{i}/distill_active"]) for m in s_steps]
                for i in range(spec.num_clients)]
    check(all(any(row) for row in schedule),
          f"socket (a): every client distills {schedule}")
    meter = sock.trainer.meter
    check(meter.delivered_bytes == meter.total_bytes > 0 and
          meter.by_edge == loop.trainer.meter.by_edge,
          "socket (a): delivered == offered, the loopback run's books")
    check(sock.transport._closed, "socket (a): listeners closed")
    out = {"wall_s": s_wall, "loopback_wall_s": l_wall,
           "step_ms_median": statistics.median(s_step_s[1:]) * 1e3,
           "leaves": leaves, "schedule": schedule,
           "offered_bytes": meter.total_bytes,
           "frame_bytes": meter.total_bytes / max(meter.num_messages, 1),
           "drain_stalls": sock.metrics["comm/drain_stalls"]}
    log(f"socket (a): gossip_socket {spec.train.steps} steps in-process, "
        f"socket == loopback, {leaves} param leaves and every step metric "
        f"bitwise (cudnn.deterministic); walls {s_wall:.2f} / {l_wall:.2f} "
        f"s, step median {out['step_ms_median']:.1f} ms; "
        f"{meter.num_messages} frames of {out['frame_bytes']:.0f} B, "
        f"drain stalls {out['drain_stalls']:.0f}; schedule {schedule}")
    return out


def _socket_ranks(results: dict, what: str) -> list:
    """Each rank's host times and card memory, logged."""
    rows = []
    for rank in sorted(results):
        r = results[rank]
        rows.append({k: r[k] for k in (
            "rank", "start_step", "steps", "spawn_s", "setup_s",
            "rendezvous_s", "wall_seconds", "barrier_wait_s",
            "max_memory_allocated", "distill_steps", "final_loss",
            "kernel_launches", "device", "drain_stalls")})
        log(f"{what} rank {rank} on {r['device']}: spawn {r['spawn_s']:.2f} "
            f"s, setup {r['setup_s']:.2f} s, rendezvous "
            f"{r['rendezvous_s']:.2f} s, step loop "
            f"{r['wall_seconds']:.2f} s for {r['steps'] - r['start_step']} "
            f"steps, finish barrier {r['barrier_wait_s']:.2f} s, card peak "
            f"{r['max_memory_allocated'] / 2**30:.2f} GiB; distilled on "
            f"{r['distill_steps']} steps, loss {r['final_loss']:.3f}; "
            f"launches {r['kernel_launches']}")
    return rows


def _socket_procs(dev, spec) -> dict:
    """(b) the same spec through launch_gossip: 4 ranks, each its own
    process and CUDA context on this card."""
    from repro_torch.launch import delivery_gaps, fleet_summary, launch_gossip

    t0 = time.perf_counter()
    results = launch_gossip(spec, timeout=SOCKET_TIMEOUT, device=str(dev),
                            child_init=register_resnet18)
    wall = time.perf_counter() - t0
    check(sorted(results) == list(range(spec.num_clients)),
          f"socket (b): ranks {sorted(results)}")
    for rank, r in results.items():
        check(r["steps"] == spec.train.steps and r["start_step"] == 0,
              f"socket (b): rank {rank} ran {spec.train.steps} steps")
        check(r["distill_steps"] >= 1,
              f"socket (b): rank {rank} distilled ({r['distill_steps']})")
        check(math.isfinite(r["final_loss"]), f"socket (b): rank {rank} loss")
        for name in SOCKET_KERNELS:
            check(r["kernel_launches"][name] > 0,
                  f"socket (b): rank {rank} launched {name} "
                  f"({r['kernel_launches'][name]})")
    gaps = delivery_gaps(results)
    check(not gaps, f"socket (b): delivered == offered on every edge {gaps}")
    fleet = fleet_summary(results)
    log(f"socket (b): {spec.num_clients} processes on one card, launch "
        f"{wall:.2f} s; fleet {fleet}")
    return {"launch_s": wall, "fleet": fleet,
            "ranks": _socket_ranks(results, "socket (b)"),
            "counts": _sum_counts(results)}


def phase_socket_path(dev) -> dict:
    """The socket transport and the gossip launcher on the card: (a)
    gossip_socket in-process, socket == loopback bitwise; (b) the same
    spec as 4 OS processes; (c) the churn smoke (rank 1 crashed, the
    fleet resumed from its per-rank snapshots). The counts are set to 0
    just before (a); the path's launches are this process's, read after
    (c), plus what every child reported."""
    script = _gossip_script()
    register_resnet18()
    shutil.rmtree(SOCKET_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    spec = fleet_preset("gossip_socket", 40)
    triple = EXP.materialize_data(spec.data, spec.partition,
                                  spec.num_clients)
    ops.reset_launch_counts()
    out = {"inprocess": _socket_inprocess(dev, spec, triple)}
    torch.cuda.empty_cache()
    out["procs"] = _socket_procs(dev, spec)
    counts = dict(out["procs"]["counts"])

    churn = script.churn_smoke(
        base=fleet_preset("gossip_socket", 8), device=str(dev),
        child_init=register_resnet18, timeout=SOCKET_CHURN_TIMEOUT,
        snap_dir=SOCKET_DIR / "churn", warm=False)
    check(not churn["failures"], f"socket (c): {churn['failures']}")
    _add_counts(counts, _sum_counts(churn["results"]))
    out["churn"] = {
        "crash_detect_s": churn["crash_detect_s"],
        "crash_error": churn["crash_error"], "resume_s": churn["resume_s"],
        "ranks": _socket_ranks(churn["results"], "socket (c)")}
    log(f"socket (c): the crash of rank 1 failed the launch in "
        f"{churn['crash_detect_s']:.2f} s (cap {SOCKET_CHURN_TIMEOUT:.0f} "
        f"s): {churn['crash_error']}; resumed in {churn['resume_s']:.2f} s, "
        f"rank 1 from step {churn['results'][1]['start_step']}")
    shutil.rmtree(SOCKET_DIR, ignore_errors=True)

    out["parent_counts"] = ops.launch_counts()
    _add_counts(counts, out["parent_counts"])
    out["counts"] = counts
    for name in SOCKET_KERNELS:
        check(counts[name] > 0, f"socket path: kernel {name} launched "
              f"({counts[name]})")
    out["seconds"] = time.perf_counter() - t0
    log(f"socket phase: {out['seconds']:.1f} s; launches {counts} (this "
        f"process {out['parent_counts']})")
    return out


def _adaptive_frame(dev, g, W: int, N: int, V: int, label: str) -> dict:
    """One adaptive delta frame of W windows, LM_H heads, N positions and
    V columns, encoded on the card and by the same encoder on CPU tensors:
    byte-identical outside the lse lane, k_per_token identical, entries
    within budget·N. Its indices travel as u16 up to V = 65,535 and as u32
    above. Its bound: the heads read once and the frame written once, or
    three f32 operations an entry (as topk_wire's: max, exp, sum), the
    larger."""
    heads = torch.randn(W, LM_H, N, V, generator=g, device=dev) * 2
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
    check(list(a) == list(b), f"adaptive wire {label}: array order")
    for name, x in a.items():
        y = b[name]
        check(x.dtype == y.dtype and x.shape == y.shape,
              f"adaptive wire {label}: {name} shape")
        if name == "lse":
            check(np.allclose(x, y, rtol=TOL_LSE, atol=TOL_LSE),
                  f"adaptive wire {label}: lse")
        else:
            check(x.tobytes() == y.tobytes(),
                  f"adaptive wire {label}: {name} bytes")
    idx_dtype = np.uint16 if V <= 0xFFFF else np.uint32
    check(b["idx"].dtype == idx_dtype,
          f"adaptive wire {label}: idx {b['idx'].dtype} != {idx_dtype}")
    kt = b["k_per_token"].astype(np.int64)
    entry_bytes = b["vals"].nbytes + b["idx"].nbytes
    budget = LM_COMM["budget_bytes_per_token"] * W * N
    entries = W * LM_H * N * V
    b_ms, b_by = bound(entries * 4 + len(on_card), 3 * entries)
    check(entry_bytes <= budget,
          f"adaptive wire {label}: entries {entry_bytes} B > budget "
          f"{budget} B")
    log(f"adaptive wire {label} ({W}, {LM_H}, {N}, {V}): device frame "
        f"({len(on_card)} B, {t_card:.2f} s) identical to the same encoder "
        f"on CPU tensors ({t_cpu:.2f} s) outside the lse lane "
        f"(lse max|d|={np.abs(a['lse'] - b['lse']).max():.3g}); idx "
        f"{b['idx'].dtype}, largest {int(b['idx'].max())}; k per token "
        f"{kt.min()}..{kt.max()}, mean {kt.mean():.3f}; entries "
        f"{entry_bytes} B <= budget {budget} B; bound {b_ms:.4f} ms "
        f"{b_by}")
    return {"shape": [W, LM_H, N, V], "frame_bytes": len(on_card),
            "bound_ms": b_ms, "bound_by": b_by,
            "entry_bytes": entry_bytes, "budget_bytes": budget,
            "idx_dtype": str(b["idx"].dtype), "card_s": t_card,
            "cpu_tensors_s": t_cpu}


def phase_adaptive_wire(dev) -> None:
    """The adaptive, delta-compressed wire at the LM path's frame shape
    (W=4 windows, H=3 heads, 1024 positions, V=50280), and a small frame
    at deepseek-v3's vocabulary (W=1, 256 positions, V=129,280), whose
    indices travel as u32: each frame encoded on the card against the
    same encoder on CPU tensors, where topk_wire takes its plain version.
    Both sides share the entropy and budget allocation code, so this holds
    the kernel and the card's float32 arithmetic against the CPU's; that
    allocation is held against the JAX package on the CPU
    (tests/test_torch_lm_wire.py, at V = 129,280 too). The decoded arrays
    are byte-identical outside the lse lane (lse within TOL_LSE: the order
    of the sum), k_per_token identical, and the (val, idx) entry streams
    stay within budget·N."""
    g = torch.Generator(device=dev).manual_seed(6)
    RECORD["adaptive_wire"] = _adaptive_frame(dev, g, LM_S_P, LM_MAX_POS,
                                              LM_VOCAB, "lm")
    RECORD["adaptive_wire_deepseek"] = _adaptive_frame(dev, g, *DS_FRAME,
                                                       DS_VOCAB, "deepseek")


def flash_key(q, k, v=None, causal: bool = True, window: int = 0,
              softcap: float = 0.0) -> tuple:
    """A flash_attention launch's SHAPES_HELD key: (B, T, S, H, KV, d,
    causal, window, dtype, softcap)."""
    B, T, H, d = q.shape
    return (B, T, k.shape[1], H, k.shape[2], d, bool(causal), int(window),
            str(q.dtype), float(softcap))


class KernelShapes:
    """While a path trains: the shape each launch of topk_wire's,
    dist_ce's, flash_attention's and emb_dist's forward kernel was given,
    keyed as in
    SHAPES_HELD (each backward takes its forward's inputs). The wrappers
    look their kernels up in their modules at each call, so replacing the
    module attribute sees every launch; the counts stay the wrappers'
    own. ``check(label)`` fails a launch at a shape no kernel phase
    held; ``record()`` gives each shape with its launches."""

    # (module, kernel wrapper, SHAPES_HELD key, shape of the call's args)
    WATCH = [(TOPK, "topk_wire_kernel", "topk_wire",
              lambda x, k: (*x.shape, k)),
             (DCE, "dist_ce_fwd_kernel", "dist_ce",
              lambda s, t: (*s.shape, str(s.dtype), str(t.dtype))),
             (FA, "flash_attention_fwd_kernel", "flash_attention",
              flash_key),
             (EMB, "emb_dist_fwd_kernel", "emb_dist",
              lambda s, t: tuple(s.shape))]

    def __enter__(self):
        self.seen = {key: collections.Counter()
                     for _, _, key, _ in self.WATCH}
        self.orig = []
        for mod, name, key, shape in self.WATCH:
            fn = getattr(mod, name)
            self.orig.append((mod, name, fn))

            def watched(*args, _fn=fn, _key=key, _shape=shape, **kw):
                self.seen[_key][_shape(*args, **kw)] += 1
                return _fn(*args, **kw)

            setattr(mod, name, watched)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.orig:
            setattr(mod, name, fn)

    def check(self, label: str) -> None:
        for key, seen in self.seen.items():
            missed = sorted(set(seen) - SHAPES_HELD[key])
            check(not missed, f"{label}: {key} launched at {missed}, where "
                  f"no kernel phase held it against its plain version")

    def record(self) -> dict:
        return {k: sorted([*shape, n] for shape, n in v.items())
                for k, v in self.seen.items()}


def phase_lm_path(dev, cfg, label: str, kernels, n_clients: int = LM_K,
                  reference=REFERENCE_DISTILLED_LM, after_step=None
                  ) -> tuple:
    """An LM slice through the user's entry points: ``n_clients`` clients of
    ``cfg`` (three full-width mamba2-370m cut to 16 layers on the LM path;
    three full-width zamba2-7b cut to one period on the hybrid path; two
    full-width arctic-480b cut to one layer of 4 experts on the MoE path;
    two full-width deepseek-v3-671b cut to one MoE layer of 12 experts on
    the DeepSeek path), MHD over the adaptive delta-compressed wire, 12
    steps and one evaluate(), with every kernel's launch count set to 0
    just before (by the caller) and read just after; each of ``kernels``
    must have launched, at shapes the kernel phases held against the plain
    versions (SHAPES_HELD), and the teacher schedule must be
    ``reference``.
    ``after_step(t)`` runs after each step's synchronize."""
    t0 = time.perf_counter()
    with KernelShapes() as shapes:
        arrays, test, part = lm_path_data(lm, data, n_clients)
        transport = RecordingTransport()
        trainer = DecentralizedTrainer(
            [lm.lm_client_bundle(build_bundle(cfg), LM_MAX_POS, LM_POS_SEED)
             for _ in range(n_clients)],
            make_optimizer(OptimizerConfig(**LM_OPTIMIZER)),
            MHDConfig(**LM_MHD), RunConfig(**LM_RUN), arrays,
            part.client_indices, part.public_indices,
            complete_graph(n_clients),
            LM_DOMAINS, exchange="prediction_adaptive",
            comm=CommConfig(**LM_COMM), transport=transport)
        torch.cuda.synchronize()
        n_params = sum(v.numel() for v in trainer.clients[0].params.values())
        log(f"{label} path: data + {n_clients} x {cfg.name} "
            f"({n_params / 1e6:.1f} M params each) init + seed publish "
            f"{time.perf_counter() - t0:.2f} s; card memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
        step_s, history = [], []
        for t in range(LM_STEPS):
            a = time.perf_counter()
            history.append(trainer.step(t))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - a)
            if after_step is not None:
                after_step(t)
        a = time.perf_counter()
        ev = trainer.evaluate(test)
        eval_s = time.perf_counter() - a
    counts = ops.launch_counts()
    shapes.check(f"{label} path")

    distilled = [[int(mt[f"c{i}/distill_active"]) for mt in history]
                 for i in range(n_clients)]
    for t, mt in enumerate(history):
        for i in range(n_clients):
            check(math.isfinite(mt[f"c{i}/loss"]),
                  f"{label} path: c{i} loss at {t}")
    check(distilled == reference,
          f"{label} path: distilled {distilled} != the reference's schedule "
          f"{reference}")
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
    ends = [[round(mt[f"c{i}/loss"], 4) for i in range(n_clients)]
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
        "kernel_shapes": shapes.record(),
        "max_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "beta": {k: v for k, v in ev.items() if k.startswith("mean/")},
        "loss": [[mt[f"c{i}/loss"] for i in range(n_clients)]
                 for mt in history]}


class ExpertLoad:
    """While an MoE path trains: every ``models.moe.moe_apply`` call also
    routes a detached copy of its input (the f32 router, the top-k, the
    running counts) and keeps, on the card, the pairs each expert got and
    dropped; ``step()`` reads them after each fleet step. Under remat a
    unit's recompute routes the same tokens again, which leaves the
    shares as they are."""

    def __init__(self, label: str):
        self.label = label
        self.pending, self.steps = [], []

    def __enter__(self):
        self.orig = MOE.moe_apply

        def recorded(params, x, cfg, act="silu", scoring="softmax"):
            with torch.no_grad():
                xf = x.detach().reshape(-1, x.shape[-1]).float()
                _, ids, _ = MOE.router_topk(xf @ params["router"].float(),
                                            cfg.top_k, scoring)
                flat = ids.reshape(-1)
                _, keep = MOE.slot_positions(
                    flat, cfg.num_experts, MOE.capacity(xf.shape[0], cfg))
                E = cfg.num_experts
                self.pending.append(torch.stack([
                    torch.bincount(flat, minlength=E),
                    torch.bincount(flat[~keep], minlength=E)]))
            return self.orig(params, x, cfg, act, scoring)

        MOE.moe_apply = recorded
        return self

    def __exit__(self, *exc):
        MOE.moe_apply = self.orig

    def step(self, t: int) -> None:
        got, dropped = torch.stack(self.pending).sum(0).cpu().tolist()
        calls = len(self.pending)
        self.pending.clear()
        n = sum(got)
        row = {"step": t, "calls": calls, "load": [g / n for g in got],
               "dropped_share": sum(dropped) / n}
        self.steps.append(row)
        log(f"{self.label}: step {t} expert load "
            f"{[round(x, 4) for x in row['load']]}, dropped "
            f"{row['dropped_share']:.4f} of the pairs")


def _hetero_inprocess(dev, spec, script) -> dict:
    """(a) lm_hetero through Experiment(spec).run() on the card, its own
    steps over its in-process socket transport; its teacher schedule
    equal to REFERENCE_DISTILLED_HETERO."""
    ceiling, _ = script.lm_frame_ceiling(spec)
    t0 = time.perf_counter()
    res, steps, step_s = _timed_run(EXP.Experiment(spec, device=dev))
    wall = time.perf_counter() - t0
    for t, m in enumerate(steps):
        _finite(m, f"moe (a): step {t}")
    schedule = [[int(m[f"c{i}/distill_active"]) for m in steps]
                for i in range(spec.num_clients)]
    check(all(any(row) for row in schedule),
          f"moe (a): every client distills {schedule}")
    check(schedule == REFERENCE_DISTILLED_HETERO,
          f"moe (a): schedule {schedule} != the CPU's "
          f"{REFERENCE_DISTILLED_HETERO}")
    meter = res.trainer.meter
    check(meter.num_messages > 0 and
          dict(meter.by_edge) == dict(meter.by_edge_delivered),
          "moe (a): delivered == offered on every edge")
    mean_frame = meter.total_bytes / meter.num_messages
    check(mean_frame <= ceiling,
          f"moe (a): mean frame {mean_frame:.0f} B > ceiling {ceiling} B")
    check(res.transport._closed, "moe (a): listeners closed")
    out = {"wall_s": wall, "step_ms_median": statistics.median(
        step_s[1:]) * 1e3, "schedule": schedule,
        "frames": meter.num_messages, "mean_frame": mean_frame,
        "ceiling": ceiling, "final_loss": [
            steps[-1][f"c{i}/loss"] for i in range(spec.num_clients)]}
    log(f"moe (a): lm_hetero ({'/'.join(c.arch for c in spec.clients)}) "
        f"{spec.train.steps} steps in-process over the socket transport "
        f"in {wall:.2f} s, step median {out['step_ms_median']:.1f} ms; "
        f"{meter.num_messages} frames, mean {mean_frame:.0f} B <= ceiling "
        f"{ceiling} B; schedule {schedule}; final losses "
        f"{[round(x, 4) for x in out['final_loss']]}")
    return out


def _hetero_procs(dev, spec, script) -> dict:
    """(b) the same spec as 3 OS processes through launch_gossip, one
    architecture a rank: scripts/port_gossip_procs.py's --lm-smoke body."""
    rep = script.lm_smoke(base=spec, device=str(dev), steps=spec.train.steps,
                          timeout=SOCKET_TIMEOUT, warm=False)
    check(not rep["failures"], f"moe (b): {rep['failures']}")
    results = rep["results"]
    for rank, r in results.items():
        check(r["steps"] == spec.train.steps,
              f"moe (b): rank {rank} ran {spec.train.steps} steps")
        for name in HETERO_RANK_KERNELS.get(rank, ()):
            check(r["kernel_launches"][name] > 0,
                  f"moe (b): rank {rank} ({spec.clients[rank].arch}) "
                  f"launched {name} ({r['kernel_launches'][name]})")
    log(f"moe (b): 3 processes on one card, launch {rep['launch_s']:.2f} "
        f"s; {rep['fleet']['offered_messages']:.0f} frames, mean "
        f"{rep['mean_frame']:.0f} B <= ceiling {rep['ceiling']} B")
    return {"launch_s": rep["launch_s"], "fleet": rep["fleet"],
            "mean_frame": rep["mean_frame"], "ceiling": rep["ceiling"],
            "ranks": _socket_ranks(results, "moe (b)"),
            "counts": _sum_counts(results)}


def _recount(ids: np.ndarray, E: int, cap: int) -> tuple:
    """Slot positions by a running count per expert in token-major (n, k)
    order, and the keep mask (position < cap), in numpy."""
    seen = np.zeros(E, np.int64)
    pos = np.empty(ids.size, np.int64)
    for i, e in enumerate(ids.reshape(-1).tolist()):
        pos[i] = seen[e]
        seen[e] += 1
    return pos, pos < cap


def _moe_block(dev, model, tokens, label: str, want_cap: int) -> dict:
    """One MoE block of ``model`` at full width with all its experts
    (arctic-480b's 128 in the MoE path's (d), deepseek-v3's 256 and its
    shared expert in the DeepSeek path's (c)), forward only, on ``tokens``
    = (B, T), f32, routed as the model routes (softmax or sigmoid). The
    weights are drawn on the card from a CUDA generator, in place, one
    expert slice at a time. Checks: the capacity; the slot positions and
    keep mask against a numpy recount of the expert ids; each kept pair's
    expert output, for 64 sampled tokens and every token with a dropped
    pair (at least one), against a float64
    evaluation of its expert, and those tokens' outputs against the
    float64 weighted sum of their kept pairs alone plus the shared
    expert's, relative to the largest entry (TOL_FLASH); moe_apply's
    output equal to its parts'. Timed with CUDA events against its bound:
    the bytes of the weights and tokens, or the router's, the kept pairs'
    and the shared expert's operations."""
    cfg, act, scoring = model.moe, model.act, model.moe_scoring
    D, Fe, E, K = model.d_model, cfg.d_ff_expert, cfg.num_experts, \
        cfg.top_k
    Fs = cfg.num_shared_experts * Fe
    B, T = tokens
    N = B * T
    g = torch.Generator(device=dev).manual_seed(23)
    t0 = time.perf_counter()
    params = {"router": torch.empty(D, E, device=dev).normal_(
        0.0, 1.0 / math.sqrt(D), generator=g)}
    for name, shape, std in (("w_gate", (E, D, Fe), 1.0 / math.sqrt(D)),
                             ("w_up", (E, D, Fe), 1.0 / math.sqrt(D)),
                             ("w_down", (E, Fe, D), 1.0 / math.sqrt(Fe))):
        w = params[name] = torch.empty(shape, device=dev)
        for e in range(E):
            w[e].normal_(0.0, std, generator=g)
    if Fs:  # the shared expert: an MLP of width num_shared · d_ff_expert
        for name, shape, std in (("w_up", (D, Fs), 1.0 / math.sqrt(D)),
                                 ("w_down", (Fs, D), 1.0 / math.sqrt(Fs)),
                                 ("w_gate", (D, Fs), 1.0 / math.sqrt(D))):
            params[f"shared/{name}"] = torch.empty(shape, device=dev).normal_(
                0.0, std, generator=g)
    shared = {k[len("shared/"):]: v for k, v in params.items()
              if k.startswith("shared/")}
    x = torch.randn(B, T, D, generator=g, device=dev)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    weight_bytes = sum(v.numel() * v.element_size() for v in params.values())
    C = MOE.capacity(N, cfg)
    check(C == want_cap, f"{label}: capacity {C} != {want_cap}")
    with torch.no_grad():
        y, aux = MOE.moe_apply(params, x, cfg, act, scoring)
        ms = time_ms(lambda: MOE.moe_apply(params, x, cfg, act, scoring),
                     iters=10, warmup=2)
        xf = x.reshape(N, D)
        w8, ids, _ = MOE.router_topk(xf @ params["router"], K, scoring)
        flat = ids.reshape(-1)
        pos, keep = MOE.slot_positions(flat, E, C)
        out_buf = MOE.expert_ffn(params, MOE.dispatch(xf, flat, pos, keep, E,
                                                      C, K))
        y2 = MOE.combine(out_buf, flat, pos, keep, w8, K)
        if shared:
            y2 = y2 + LAYERS.mlp_apply(shared, xf, act)
        check(_relerr(y.reshape(N, D), y2) <= TOL_F32,
              f"{label}: moe_apply == its parts")
        want_pos, want_keep = _recount(flat.cpu().numpy(), E, C)
        check(np.array_equal(pos.cpu().numpy(), want_pos) and
              np.array_equal(keep.cpu().numpy(), want_keep),
              f"{label}: slot positions and keep mask == the numpy recount")
        dropped = int((~keep).sum())
        # every token with a dropped pair, beside the random sample: its
        # combined output must be the sum over its kept pairs alone
        hit = (~keep).reshape(N, K).any(1).nonzero().flatten().tolist()
        check(len(hit) > 0, f"{label}: no token had a pair dropped")
        sample = sorted(set(torch.randperm(
            N, generator=torch.Generator().manual_seed(5))[
                :MOE_BLOCK_SAMPLES].tolist()) | set(hit))
        x64 = xf.double()
        want_y = {n: torch.zeros(D, dtype=torch.float64, device=dev)
                  for n in sample}
        if shared:
            xs = x64[sample]
            ref = (F.silu(xs @ shared["w_gate"].double()) *
                   (xs @ shared["w_up"].double())) @ shared["w_down"].double()
            for r, n in enumerate(sample):
                want_y[n] += ref[r]
        pair_err, kept_pairs = 0.0, 0
        by_expert: dict = {}
        for n in sample:
            for j in range(K):
                i = n * K + j
                if bool(keep[i]):
                    by_expert.setdefault(int(flat[i]), []).append(i)
        for e, rows in sorted(by_expert.items()):
            toks = [i // K for i in rows]
            xs = x64[toks]
            ref = (F.silu(xs @ params["w_gate"][e].double()) *
                   (xs @ params["w_up"][e].double())) @ \
                params["w_down"][e].double()
            got = out_buf[e, pos[rows]].double()
            for r, i in enumerate(rows):
                pair_err = max(pair_err, _relerr(got[r], ref[r]))
                want_y[i // K] += float(w8.reshape(-1)[i]) * ref[r]
            kept_pairs += len(rows)
        y_err = max(_relerr(y2[n].double(), want_y[n]) for n in sample)
        y_err_hit = max((_relerr(y2[n].double(), want_y[n]) for n in hit),
                        default=0.0)
    check(pair_err <= TOL_FLASH,
          f"{label}: kept pairs {pair_err:.3g} > {TOL_FLASH} of float64")
    check(y_err <= TOL_FLASH,
          f"{label}: sampled outputs {y_err:.3g} > {TOL_FLASH} of float64 "
          f"({y_err_hit:.3g} on the {len(hit)} tokens with a dropped pair)")
    check(math.isfinite(float(aux)), f"{label}: aux finite")
    load = torch.bincount(flat, minlength=E)
    # the bound counts the work this run's routing needs: the router, the
    # three expert products of each kept pair and the shared expert's of
    # each token. The padded (E, C) buffer's products, which the port
    # runs, and those of every routed pair are recorded beside it
    kept = N * K - dropped
    bytes_ = weight_bytes + 2 * x.numel() * 4
    flops = {n: 2 * N * D * E + 3 * 2 * (rows * Fe + N * Fs) * D
             for n, rows in (("kept", kept), ("routed", N * K),
                             ("padded", E * C))}
    b_ms, b_by = bound(bytes_, flops["kept"])
    out = {"tokens": N, "experts": E, "capacity": C, "scoring": scoring,
           "shared_d_ff": Fs, "ms": ms, "bound_ms": b_ms, "bound_by": b_by,
           "tflop": {n: f / 1e12 for n, f in flops.items()},
           "bound_ms_routed": bound(bytes_, flops["routed"])[0],
           "bound_ms_padded": bound(bytes_, flops["padded"])[0],
           "weight_gb": weight_bytes / 1e9, "draw_s": draw_s,
           "dropped_pairs": dropped, "pairs": N * K,
           "tokens_checked": len(sample), "tokens_with_a_drop": len(hit),
           "kept_pairs_checked": kept_pairs, "pair_rel_err": pair_err,
           "y_rel_err": y_err, "y_rel_err_dropped": y_err_hit,
           "aux": float(aux),
           "load_min_max": [int(load.min()), int(load.max())],
           "max_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"{label}: {model.name} MoE block, {E} experts of {D} x {Fe} "
        f"({scoring}; shared d_ff {Fs}), {out['weight_gb']:.2f} GB of f32 "
        f"weights drawn on the card in {draw_s:.2f} s; {N} tokens, C = {C}; "
        f"forward {ms:.3f} ms against its bound {b_ms:.3f} ms ({b_by}; "
        f"{out['tflop']['kept']:.3f} TFLOP for the {kept} kept pairs; "
        f"{out['bound_ms_routed']:.3f} ms for all {N * K} routed, "
        f"{out['bound_ms_padded']:.3f} ms for the {E * C} padded slots); "
        f"{dropped} pairs dropped, expert loads {out['load_min_max'][0]}.."
        f"{out['load_min_max'][1]}; {kept_pairs} kept pairs of "
        f"{len(sample)} tokens ({len(hit)} with a dropped pair) within "
        f"{pair_err:.3g} of float64, outputs {y_err:.3g} ({y_err_hit:.3g} "
        f"where a pair was dropped); card peak "
        f"{out['max_memory_gib']:.1f} GiB")
    del params, shared, x, y, y2, out_buf
    torch.cuda.empty_cache()
    return out


def phase_moe_path(dev) -> dict:
    """The MoE path: (a) lm_hetero (an SSM, a dense transformer and an MoE
    transformer) through Experiment(spec).run() for its own 30 steps over
    its in-process socket transport; (b) the same spec as 3 OS processes
    through launch_gossip (the --lm-smoke body); (c) K=2 full-width
    arctic-480b cut to one layer of 4 experts through phase_lm_path, each
    step's expert load and dropped share logged, then a profiled publish
    round; (d) one full-width arctic MoE block with all 128 experts,
    forward only. The counts are set to 0 just before (a) and read after
    (b) (this process's plus every child's), and again before and after
    (c); the path's launches are their sum."""
    script = _gossip_script()
    t0 = time.perf_counter()
    spec = EXP.get_preset("lm_hetero")
    ops.reset_launch_counts()
    with KernelShapes() as shapes:
        out = {"inprocess": _hetero_inprocess(dev, spec, script)}
    shapes.check("moe (a)")
    out["inprocess"]["kernel_shapes"] = shapes.record()
    torch.cuda.empty_cache()
    out["procs"] = _hetero_procs(dev, spec, script)
    counts = dict(ops.launch_counts())
    for name in HETERO_KERNELS:
        check(counts[name] > 0, f"moe (a): kernel {name} launched "
              f"({counts[name]})")
    _add_counts(counts, out["procs"]["counts"])
    out["hetero_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    block = MOE_CFG.stages[0].block
    log(f"moe path: {MOE_ARCH} at full width, cut in depth from "
        f"{_MOE_FULL.num_layers} to {MOE_CFG.num_layers} layer "
        f"({[(sp.attn, sp.ffn) for sp in block]}) and in experts from "
        f"{_MOE_FULL.moe.num_experts} to {MOE_CFG.moe.num_experts}, "
        f"d_model {MOE_CFG.d_model}, vocab {MOE_CFG.vocab_size}, K={MOE_K}")
    ops.reset_launch_counts()
    with ExpertLoad("moe path") as load:
        trainer, arctic = phase_lm_path(dev, MOE_CFG, "moe", MOE_KERNELS,
                                        n_clients=MOE_K,
                                        reference=REFERENCE_DISTILLED_MOE,
                                        after_step=load.step)
    arctic["expert_load"] = load.steps
    for t, mt in enumerate(arctic["loss"]):
        check(all(math.isfinite(v) for v in mt), f"moe (c): losses at {t}")
    check(all(math.isfinite(v) for v in arctic["beta"].values()),
          "moe (c): beta finite")
    _add_counts(counts, arctic["counts"])
    out["arctic"] = arctic
    RECORD["profile_moe"] = phase_profile(trainer, LM_STEPS, LM_S_P, "moe",
                                          by_shape=True)
    mhd_roofline("moe", trainer, MOE_CFG, arctic["step_s"],
                 arctic["max_memory_gib"], LM_TOKENS)
    del trainer
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out["block"] = _moe_block(dev, _MOE_FULL, MOE_BLOCK_TOKENS, "moe (d)",
                              80)
    out["counts"] = counts
    out["seconds"] = time.perf_counter() - t0
    log(f"moe phase: {out['seconds']:.1f} s ((a)+(b) "
        f"{out['hetero_s']:.1f} s); launches {counts}")
    return out


def _leaf_bytes(cfg) -> list:
    """Each leaf's bytes in an f32 model of ``cfg``, largest first, from
    the shapes alone: ``init_lm`` under fake tensors allocates nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        shapes = TF.init_lm(torch.Generator(), cfg, device="cpu")
    return sorted((v.numel() * 4 for v in shapes.values()), reverse=True)


def _deepseek_loss(dev) -> dict:
    """(b) The model bundle's loss with MTP at deepseek-v3's full
    vocabulary: one client of DS_LOSS_CFG, its weights drawn on the card,
    DS_LOSS_STEPS AdamW steps on one batch of 2 x 512 tokens drawn over the
    whole vocabulary. ce, aux_loss and mtp_ce finite at every step; the
    loss falls. The peak is reckoned before the run: four f32 copies of
    the params (params, grads, AdamW's two moments), and the update's
    transient of four copies of the largest leaf."""
    cfg = DS_LOSS_CFG
    sizes = _leaf_bytes(cfg)
    n_bytes = sum(sizes)
    reckoned = (4 * n_bytes + 4 * sizes[0]) / 2**30
    log(f"deepseek (b): {cfg.name}, vocab {cfg.vocab_size}, "
        f"{n_bytes / 4e6:.1f} M params; reckoned peak {reckoned:.1f} GiB "
        f"(4 x {n_bytes / 2**30:.2f} GiB + the update's 4 x "
        f"{sizes[0] / 2**30:.2f} GiB)")
    t0 = time.perf_counter()
    params = TF.init_lm(torch.Generator(device=dev).manual_seed(24), cfg,
                        device=dev)
    bundle = build_bundle(cfg)
    tokens = torch.randint(0, cfg.vocab_size, DS_LOSS_TOKENS, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(
                               25))
    opt = make_optimizer(OptimizerConfig(**DS_LOSS_OPTIMIZER))
    state = opt.init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    steps = []
    for t in range(DS_LOSS_STEPS):
        a = time.perf_counter()
        live = {k: v.requires_grad_() for k, v in params.items()}
        loss, metrics = bundle.loss(live, {"tokens": tokens})
        grads = dict(zip(live, torch.autograd.grad(
            loss, list(live.values()), allow_unused=True,
            materialize_grads=True)))
        row = {"loss": loss.item(), **{k: v.item()
                                       for k, v in metrics.items()}}
        del loss, metrics, live
        params = {k: v.detach() for k, v in params.items()}
        params, state = opt.update(grads, state, params, t)
        del grads
        torch.cuda.synchronize()
        row["s"] = time.perf_counter() - a
        steps.append(row)
        _finite(row, f"deepseek (b): step {t}")
        log(f"deepseek (b): step {t} loss {row['loss']:.4f} (ce "
            f"{row['ce']:.4f}, aux_loss {row['aux_loss']:.3g}, mtp_ce "
            f"{row['mtp_ce']:.4f}) in {row['s']:.2f} s")
    check(set(steps[0]) >= {"ce", "aux_loss", "mtp_ce"},
          f"deepseek (b): metrics {sorted(steps[0])}")
    check(steps[-1]["loss"] < steps[0]["loss"],
          f"deepseek (b): the loss falls ({steps[0]['loss']:.4f} -> "
          f"{steps[-1]['loss']:.4f})")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"deepseek (b): {DS_LOSS_STEPS} AdamW steps, init {init_s:.2f} s, "
        f"step median {statistics.median(r['s'] for r in steps):.2f} s; "
        f"card peak {peak:.1f} GiB (reckoned {reckoned:.1f})")
    del params, state, tokens
    torch.cuda.empty_cache()
    return {"params": n_bytes // 4, "reckoned_gib": reckoned,
            "init_s": init_s, "steps": steps, "max_memory_gib": peak}


def phase_deepseek_path(dev) -> dict:
    """The DeepSeek path: (a) K=2 full-width deepseek-v3-671b clients cut
    to one MoE layer of 12 experts at a 32,000-word vocabulary through
    phase_lm_path (MLA, sigmoid top-8 routing with the shared expert, the
    MHD loss without the MTP branch), each step's expert load and dropped
    share logged (some step must drop a pair), then a profiled publish
    round by op and shape; (b) the
    bundle's loss with MTP at the full vocabulary, 3 AdamW steps; (c) one
    full-width deepseek MoE block with all 256 experts and the shared one,
    forward only. The counts are set to 0 just before (a) and read just
    after it; (b) and (c) launch none of the port's kernels."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"deepseek path: {DS_ARCH} at full width, cut in depth from "
        f"{_DS_FULL.num_layers} to {DS_CFG.num_layers} MoE layer, in "
        f"experts from {_DS_FULL.moe.num_experts} to "
        f"{DS_CFG.moe.num_experts}, in vocabulary from {DS_VOCAB} to "
        f"{DS_CFG.vocab_size}, without MTP; d_model {DS_CFG.d_model}, "
        f"{DS_CFG.num_heads} MLA heads, {DS_CFG.moe_scoring} top-"
        f"{DS_CFG.moe.top_k}, K={DS_K}")
    state = DS_K * 4 * sum(_leaf_bytes(DS_CFG)) / 2**30
    log(f"deepseek (a): reckoned {state:.1f} GiB of params, grads and "
        f"AdamW moments for the {DS_K} clients, before activations")
    ops.reset_launch_counts()
    with ExpertLoad("deepseek path") as load:
        trainer, out = phase_lm_path(dev, DS_CFG, "deepseek", DS_KERNELS,
                                     n_clients=DS_K,
                                     reference=REFERENCE_DISTILLED_DEEPSEEK,
                                     after_step=load.step)
    out["expert_load"], out["reckoned_state_gib"] = load.steps, state
    check(all(math.isfinite(v) for v in out["beta"].values()),
          "deepseek (a): beta finite")
    check(any(r["dropped_share"] > 0 for r in load.steps),
          "deepseek (a): the routers dropped no pair in any step")
    check(not any(k.startswith("mtp/")
                  for k in trainer.clients[0].params),
          "deepseek (a): no MTP leaves")
    RECORD["profile_deepseek"] = phase_profile(trainer, LM_STEPS, LM_S_P,
                                               "deepseek", by_shape=True)
    mhd_roofline("deepseek", trainer, DS_CFG, out["step_s"],
                 out["max_memory_gib"], LM_TOKENS)
    del trainer
    out["fleet_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    a = time.perf_counter()
    out["loss_mtp"] = _deepseek_loss(dev)
    out["loss_mtp"]["seconds"] = time.perf_counter() - a
    torch.cuda.reset_peak_memory_stats()
    out["block"] = _moe_block(dev, _DS_FULL, DS_BLOCK_TOKENS, "deepseek (c)",
                              160)
    out["seconds"] = time.perf_counter() - t0
    log(f"deepseek phase: {out['seconds']:.1f} s ((a) {out['fleet_s']:.1f} "
        f"s, (b) {out['loss_mtp']['seconds']:.1f} s); launches "
        f"{out['counts']}")
    return out


def attn_calls(cfg) -> int:
    """flash_attention calls in one forward of ``cfg``: every self-, cross
    and shared attention layer, the decoder's cross sublayers and the
    encoder's layers."""
    n = 0
    for st in cfg.stages:
        for sp in st.block:
            n += st.repeats * ((sp.attn in ("full", "swa", "cross")
                                and cfg.mla is None)
                               + sp.shared_attn + sp.cross_attn)
    return n + (cfg.encoder.num_layers if cfg.audio is not None else 0)


class GradWatch:
    """An optimizer that reads the largest |gradient| of some leaves
    before it hands every gradient to ``opt``'s update: what the train step
    computed, seen where it is consumed."""

    def __init__(self, opt: Optimizer, keys):
        self.keys, self.steps = list(keys), []
        self.opt = Optimizer(init=opt.init, update=self._update)
        self._inner = opt

    def _update(self, grads, state, params, step):
        self.steps.append({k: float(grads[k].abs().max())
                           for k in self.keys})
        return self._inner.update(grads, state, params, step)


def _step_profile(step_fn, state, batch, name: str, vocab: int) -> tuple:
    """One more train step under torch.profiler: the device time by
    kernel and by op. Categories: each hand kernel that ran
    (``flash_attention``, ``ssd_scan``, ``topk_wire``, ``dist_ce``,
    ``emb_dist``: their kernels by name); ``heads`` (every op with an input dimension that is a multiple
    of the vocabulary: the tied or untied head's GEMMs, the aux heads'
    one product of m·V columns, the softmax CE and their backward); ``gemm`` (the other matmuls: projections, FFNs, the front
    ends); ``other`` (norms, activations, residual adds, copies). The
    table goes to chiprun_out/profile_<name>.txt. Returns (state, row)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    mm = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels)
    hand = {n: sum(e.self_device_time_total for e in kernels
                   if n in e.key)
            for n in ("flash_attention", "ssd_scan", "topk_wire", "dist_ce",
                      "emb_dist")}
    hand = {n: v for n, v in hand.items() if v}
    rows = sorted((e for e in prof.key_averages(group_by_input_shape=True)
                   if e.device_type == DeviceType.CPU
                   and e.self_device_time_total > 0),
                  key=lambda e: -e.self_device_time_total)
    def head(e) -> bool:
        return any(isinstance(n, int) and n and n % vocab == 0
                   for sh in e.input_shapes if sh for n in sh)

    heads = sum(e.self_device_time_total for e in rows if head(e))
    gemm = sum(e.self_device_time_total for e in rows
               if e.key in mm and not head(e))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"profile_{name}.txt").write_text(prof.key_averages(
        group_by_input_shape=True).table(sort_by="self_device_time_total",
                                         row_limit=60))
    by = {"gemm": gemm, "heads": heads, **hand,
          "other": busy - gemm - heads - sum(hand.values())}
    top = [{"op": e.key, "shapes": str(e.input_shapes)[:160],
            "calls": e.count, "device_us": e.self_device_time_total}
           for e in rows[:20]]
    log(f"profile {name}: one step, wall {wall_us / 1e3:.1f} ms, device "
        f"busy {busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f} %), "
        f"{sum(e.count for e in kernels)} kernel launches; by op: " +
        ", ".join(f"{k} {v / 1e3:.1f} ms ({100 * v / max(busy, 1):.1f} %)"
                  for k, v in by.items()))
    for row in top[:12]:
        log(f"  {row['device_us'] / 1e3:8.2f} ms {row['calls']:6d}x "
            f"{row['op']} {row['shapes']}")
    return state, {"wall_us": wall_us, "busy_us": busy, "by_op_us": by,
                   "ops": top, "loss": float(metrics["loss"]),
                   "launches": sum(e.count for e in kernels)}


def _xattn_model(dev, cfg, seq_len: int, label: str,
                 cuda_count: bool = False) -> dict:
    """One model through the launcher's train state and step on the card:
    its params drawn there, one warm-up step, XATTN_STEPS timed steps and
    a profiled one, each a fresh batch of `supervised_batch`'s draws
    (``seq_len``: the encoder's frames for whisper, the tokens for
    llama-vision). The loss and ce of every step finite; flash_attention
    launched exactly twice per attention call a step forward (each unit
    runs again under remat) and once backward, at shapes the kernel phase
    held. The front end live: its projection's gradients nonzero and
    finite — for llama-vision, whose cross gates start at 0 (tanh(0) = 0
    multiplies the cross layer away, so no gradient reaches it at step 0),
    every gate moved after step 0 and ``vision_proj``'s and the cross
    layer's ``wk`` gradients nonzero from step 1 — and, after the steps,
    other embeddings (or frames) change the logits. The peak is reckoned
    before the run: four f32 copies of the params (params, grads, AdamW's
    two moments) and the update's transient of four copies of the largest
    leaf; activations come on top. Then the step against the roofline
    (`roofline_row`): the launcher's step counted on meta at this
    configuration and batch; with ``cuda_count``, one more step counted on
    the card, real tensors and the kernels launching, which must give the
    meta count's FLOPs, bytes and kernel entries exactly."""
    sizes = _leaf_bytes(cfg)
    n_bytes = sum(sizes)
    reckoned = (4 * n_bytes + 4 * sizes[0]) / 2**30
    audio = cfg.audio is not None
    front = "audio_proj" if audio else "vision_proj"
    calls = attn_calls(cfg)
    runs = 2 if cfg.remat != "none" else 1  # remat runs each unit again
    log(f"xattn {label}: {cfg.name}, {n_bytes / 4e6:.1f} M params, "
        f"{cfg.num_layers} decoder layers"
        + (f" + {cfg.encoder.num_layers} encoder layers" if audio else "")
        + f", vocab {cfg.vocab_size}; B = {XATTN_BATCH} x {seq_len} "
        f"{'frames' if audio else 'tokens'}; {calls} attention calls a "
        f"forward; reckoned peak {reckoned:.1f} GiB (4 x "
        f"{n_bytes / 2**30:.2f} GiB + the update's 4 x "
        f"{sizes[0] / 2**30:.2f} GiB) before activations")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bundle = build_bundle(cfg)
    keys = [front] + ([] if audio else ["stage0/layer0/attn/wk"])
    watch = GradWatch(make_optimizer(OptimizerConfig(**XATTN_OPTIMIZER)),
                      keys)
    t0 = time.perf_counter()
    state = init_train_state(bundle, watch.opt, seed=XATTN_SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gates = sorted(k for k in state["params"] if k.endswith("cross_gate"))
    check(audio or len(gates) == 1, f"xattn {label}: cross gates {gates}")
    step_fn = make_train_step(bundle, watch.opt)
    rng = np.random.default_rng(XATTN_SEED)
    steps = []
    with KernelShapes() as shapes:
        for t in range(1 + XATTN_STEPS):
            batch = supervised_batch(rng, cfg, XATTN_BATCH, seq_len, dev)
            before = ops.launch_counts()
            torch.cuda.synchronize()
            a = time.perf_counter()
            state, metrics = step_fn(state, batch)
            torch.cuda.synchronize()
            row = {k: float(v) for k, v in metrics.items()}
            row["s"] = time.perf_counter() - a
            after = ops.launch_counts()
            row["flash"] = [after[n] - before[n] for n in XATTN_KERNELS]
            row["grad_max"] = watch.steps[-1]
            row["gates"] = [float(state["params"][k].abs().max())
                            for k in gates]
            steps.append(row)
            _finite({k: row[k] for k in ("loss", "ce", "aux_loss")},
                    f"xattn {label}: step {t}")
            check(row["flash"] == [runs * calls, calls],
                  f"xattn {label}: step {t} flash_attention launches "
                  f"{row['flash']} != [{runs * calls}, {calls}]")
            log(f"xattn {label}: step {t} loss {row['loss']:.4f} (ce "
                f"{row['ce']:.4f}) in {row['s']:.3f} s; flash_attention "
                f"fwd/bwd {row['flash']}; max |grad| " + ", ".join(
                    f"{k} {v:.3g}" for k, v in row["grad_max"].items())
                + (f"; |cross_gate| {row['gates']}" if gates else ""))
        state, prof = _step_profile(step_fn, state, supervised_batch(
            rng, cfg, XATTN_BATCH, seq_len, dev), label, cfg.vocab_size)
        # the front end reaches the logits: the last batch with other
        # embeddings (or frames), drawn from another stream
        other = dict(batch)
        key = "audio_frames" if audio else "vision_embeds"
        other[key] = torch.from_numpy(np.random.default_rng(
            XATTN_SEED + 1).standard_normal(tuple(batch[key].shape)).astype(
            np.float32)).to(dev)
        with torch.no_grad():
            lo = bundle.apply(state["params"], batch)["logits"]
            lo2 = bundle.apply(state["params"], other)["logits"]
            moved = float((lo - lo2).abs().max())
            finite = bool(torch.isfinite(lo).all())
        del lo, lo2
    shapes.check(f"xattn {label}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(finite, f"xattn {label}: logits finite")
    check(moved > 0, f"xattn {label}: other {key} change the logits "
          f"({moved})")
    for t, row in enumerate(steps):
        for k, v in row["grad_max"].items():
            check(math.isfinite(v), f"xattn {label}: {k} gradient finite "
                  f"at step {t}")
            if audio or t >= 1:
                check(v > 0, f"xattn {label}: {k} gradient nonzero at step "
                      f"{t} ({v})")
        if gates:
            check(all(g > 0 for g in row["gates"]),
                  f"xattn {label}: cross_gate moved after step {t} "
                  f"{row['gates']}")
    med = statistics.median(r["s"] for r in steps[1:])
    plain = make_train_step(bundle, make_optimizer(OptimizerConfig(
        **XATTN_OPTIMIZER)))
    batch = supervised_batch(rng, cfg, XATTN_BATCH, seq_len, dev)
    meta_args = meta_like((state, batch))
    a = time.perf_counter()
    _, counted = op_cost.count(plain, *meta_args)
    roof = roofline_row(
        label, counted.to_dict(), counted.peak_bytes
        + op_cost.tree_bytes(meta_args), med * 1e3, peak,
        model_flops(cfg, n_bytes // 4, XATTN_BATCH * seq_len, "train"),
        {"count_s": time.perf_counter() - a, "kernels": counted.kernels})
    if cuda_count:
        with op_cost.OpCounter(args=(state, batch)) as on_card:
            state, _ = plain(state, batch)
        torch.cuda.synchronize()
        roof["cuda_count"] = on_card.to_dict()
        same = on_card.to_dict() == counted.to_dict() and \
            on_card.kernels == counted.kernels
        log(f"roofline {label}: one step counted on the card "
            f"{on_card.to_dict()}, on meta {counted.to_dict()}: "
            + ("equal" if same else "DIFFERENT"))
        check(same, f"roofline {label}: the step counted on the card "
              f"{on_card.to_dict()} {on_card.kernels} == counted on meta "
              f"{counted.to_dict()} {counted.kernels}")
    log(f"xattn {label}: init {init_s:.2f} s; step median {med:.3f} s "
        f"(warm-up {steps[0]['s']:.3f} s); card peak {peak:.1f} GiB "
        f"(reckoned {reckoned:.1f} before activations); other {key} move "
        f"the logits by up to {moved:.4g}; flash_attention at "
        f"{shapes.record()['flash_attention']} (shape, launches)")
    return {"config": cfg.name, "params": n_bytes // 4,
            "reckoned_gib": reckoned, "init_s": init_s, "steps": steps,
            "step_median_s": med, "max_memory_gib": peak,
            "logits_moved": moved, "attn_calls": calls,
            "kernel_shapes": shapes.record(), "profile": prof}


def phase_xattn_path(dev) -> dict:
    """The cross-attention path (`launch.train`'s supervised mode): (a)
    whisper-large-v3 cut to 16 + 16 of its 32 + 32 layers, (b)
    llama-3.2-vision-90b cut to its gated cross layer and one
    self-attention layer at vocabulary 32,000, each
    through `_xattn_model`. The counts are set to 0 just before (a) and
    read just after (b); flash_attention forward and backward must have
    launched."""
    t0 = time.perf_counter()
    log(f"xattn path: {WHISPER_ARCH} at {WHISPER_CFG.num_layers} + "
        f"{WHISPER_CFG.encoder.num_layers} layers; {LLAMA_V_ARCH} at full "
        f"width, cut in depth from {_LLAMA_V_FULL.num_layers} to "
        f"{LLAMA_V_CFG.num_layers} layers "
        f"({[sp.attn for sp in LLAMA_V_CFG.stages[0].block]}) and in "
        f"vocabulary from {_LLAMA_V_FULL.vocab_size} to "
        f"{LLAMA_V_CFG.vocab_size}; AdamW lr "
        f"{XATTN_OPTIMIZER['init_lr']}, f32")
    ops.reset_launch_counts()
    out = {"whisper": _xattn_model(dev, WHISPER_CFG, WHISPER_FRAMES,
                                   "whisper", cuda_count=True)}
    torch.cuda.empty_cache()
    out["llama_vision"] = _xattn_model(dev, LLAMA_V_CFG, LLAMA_V_TOKENS,
                                       "llama-vision")
    out["counts"] = counts = ops.launch_counts()
    for name in XATTN_KERNELS:
        check(counts[name] > 0, f"xattn path: kernel {name} launched "
              f"({counts[name]})")
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"xattn phase: {out['seconds']:.1f} s; launches {counts}")
    return out


def _serve_loop(dev) -> dict:
    """(a) serve_loop exactly as the preset defines it, through
    `run_serve_scenario`: every request answered; at least one teacher
    cache hit, each hit byte for byte its window's recompute; the front's
    params bitwise the snapshot the trainer wrote; the feedback steps
    distilling, moving every client's params and metering wire bytes; each
    generate request's tokens equal to `solo_generate`'s; topk_wire,
    dist_ce and emb_dist launched, at shapes the kernel phases held. Runs
    in cuDNN's deterministic mode, so a recompute repeats the forward's
    bits."""
    spec = EXP.get_preset("serve_loop")
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    with Deterministic(), KernelShapes() as shapes:
        res = SERVE.run_serve_scenario(spec, str(SERVE_DIR), device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        front, m = res.front, res.metrics
        # the streams replayed from the serve seed: which window each
        # teacher request asked for, and each generate request
        rng = np.random.default_rng(spec.serve.seed)
        test = EXP.materialize_data(spec.data, spec.partition,
                                    spec.num_clients)[1]
        stream = SERVE.front._request_stream(res.spec, test, rng)
        gens = SERVE.front._generate_stream(
            res.spec, front.engine.bundle.config.vocab_size, rng)
        windows = {r.request_id: r for r in stream if r.kind == "teacher"}
        hits = [r for r in res.responses if r.kind == "teacher"
                and r.cache_hit]
        for r in hits:
            req = windows[r.request_id]
            teachers = req.teachers or tuple(range(len(front.bundles)))
            batch = batch_to_device(front.public.sample(req.window_id), dev)
            again = np.stack([front._apply(front.bundles[t])(
                front.params[t], batch).cpu().numpy()
                for t in teachers]).mean(axis=0)
            check(again.tobytes() == r.predictions["logits"].tobytes(),
                  f"serve (a): request {r.request_id}'s cache hit == "
                  f"a recompute of window {req.window_id}")
    counts = ops.launch_counts()
    shapes.check("serve (a)")
    n_req = spec.serve.requests + max(spec.serve.num_slots * 2, 4)
    check(len(res.responses) == n_req == sum(
        m[f"served/{k}"] for k in ("classify", "teacher", "generate")),
        f"serve (a): {len(res.responses)} of {n_req} requests answered")
    check(len(hits) >= 1, "serve (a): a teacher cache hit")
    snap = res.spec.train.snapshot_dir
    trainer = res.experiment.trainer
    for cid, b in enumerate(front.bundles):
        like = {k: v.clone() for k, v in front.params[cid].items()}
        loaded, step = load_client_params(snap, cid, like)
        check(step == spec.train.steps, f"serve (a): snapshot step {step}")
        for k, v in loaded.items():
            check(torch.equal(v, front.params[cid][k]),
                  f"serve (a): front client {cid} {k} == the snapshot")
        check(any(not torch.equal(v, front.params[cid][k])
                  for k, v in trainer.clients[cid].params.items()),
              f"serve (a): feedback moved client {cid}'s params")
    check(m["feedback/steps"] == spec.serve.feedback_steps
          and m["feedback/distill_steps"] >= 1
          and m["feedback/wire_bytes"] > 0,
          f"serve (a): feedback distilled over the wire "
          f"{ {k: v for k, v in m.items() if k.startswith('feedback/')} }")
    eng = front.engine
    by_id = {r.request_id: r.tokens for r in res.responses
             if r.kind == "generate"}
    for req in gens:
        solo = SERVE.solo_generate(eng.bundle, eng.params, req.prompt,
                                   req.max_new_tokens, eng.cache_len)
        check(by_id[req.request_id] == solo,
              f"serve (a): request {req.request_id} continuous "
              f"{by_id[req.request_id]} == solo {solo}")
    for name in SERVE_KERNELS:
        check(counts[name] > 0, f"serve (a): kernel {name} launched "
              f"({counts[name]})")
    log(f"serve (a): serve_loop train {spec.train.steps} steps + snapshot "
        f"+ {n_req} requests + {spec.serve.feedback_steps} feedback steps "
        f"in {wall:.2f} s; cache {int(m['cache/hits'])} hits / "
        f"{int(m['cache/misses'])} misses, each hit == its recompute; "
        f"engine occupancy {m['engine/occupancy']:.3f}, {len(gens)} "
        f"generate requests == solo; feedback {m['feedback/wire_bytes']:.0f}"
        f" wire bytes, {m['feedback/distill_steps']:.0f} client-steps "
        f"distilled; launches {counts}")
    return {"wall_s": wall, "metrics": m, "hits": len(hits),
            "counts": counts, "kernel_shapes": shapes.record()}


class EngineClock:
    """While an engine runs: the wall time of each prefill and decode call
    (each ends in a synchronize), the prompt tokens prefilled, and each
    generated token's top-2 logits by request (the prefill's first token,
    then one a tick), on the host."""

    def __init__(self, engine):
        self.prefill_s, self.decode_s, self.prompt_tokens = [], [], 0
        self.top2 = collections.defaultdict(list)
        self.order = list(engine.queue)  # admission is first in, first out
        self.finite = True
        prefill, decode = engine.prefill, engine.decode
        lanes = engine.lanes  # not the engine: no cycle through it

        def timed_prefill(params, prompt, caches):
            a = time.perf_counter()
            caches, logits = prefill(params, prompt, caches)
            top = logits[-1][0, -1].topk(2).values.cpu()
            self.prefill_s.append(time.perf_counter() - a)
            self.prompt_tokens += prompt.shape[1]
            rid = self.order[len(self.prefill_s) - 1].request_id
            self.top2[rid].append(top.tolist())
            return caches, logits

        def timed_decode(params, tokens, caches):
            a = time.perf_counter()
            logits, caches = decode(params, tokens, caches)
            top = logits[:, -1].topk(2).values.cpu()
            self.decode_s.append(time.perf_counter() - a)
            self.finite &= bool(torch.isfinite(top).all())
            for slot, lane in enumerate(lanes):
                if lane is not None:
                    self.top2[lane.request.request_id].append(
                        top[slot].tolist())
            return logits, caches

        engine.prefill, engine.decode = timed_prefill, timed_decode


@torch.no_grad()
def _graph_against_eager(bundle, params, slots, cache_len, dev) -> dict:
    """The engine's CUDA-graph step (`GraphStep`) against the eager
    ``decode_step`` on the same input, as a kernel against its plain
    version: caches warmed by 4 eager steps, then row b moved on to
    position 4 + 3b; the logits and every cache leaf within TOL_F32 of
    the largest magnitude (the same kernels run, so 0 is expected)."""
    g = torch.Generator(device=dev).manual_seed(SERVE_SEED + 1)
    V = bundle.config.vocab_size

    def tokens():
        return torch.randint(0, V, (slots, 1), generator=g, device=dev,
                             dtype=torch.int32)

    caches = bundle.init_cache(slots, cache_len, torch.float32, device=dev)
    for _ in range(4):
        _, caches = bundle.decode_step(params, tokens(), caches)
    shift = 3 * torch.arange(slots, dtype=torch.int32, device=dev)
    caches = {k: v + shift if k.endswith("index") else v
              for k, v in caches.items()}
    tok = tokens()
    want, want_c = bundle.decode_step(params, tok, caches)
    graph = SERVE.engine.GraphStep(bundle, params, caches)
    got, got_c = graph(params, tok, graph.caches)
    torch.cuda.synchronize()
    errs = {"logits": maxerr(got, want) / float(want.abs().max())}
    for k, v in want_c.items():
        errs[k] = maxerr(got_c[k], v) / max(float(v.abs().max()), 1e-30)
    worst = max(errs, key=errs.get)
    check(errs[worst] <= TOL_F32, f"serve: the graph step's {worst} "
          f"{errs[worst]:.3g} of the eager step's largest magnitude")
    return {"logits": errs["logits"], "worst": worst,
            "worst_err": errs[worst]}


def _gap(top2) -> float:
    """A row's top-2 logit gap, relative to its largest logit."""
    return (top2[0] - top2[1]) / max(abs(top2[0]), 1e-30)


@torch.no_grad()
def _solo_top2(bundle, params, prompt, tokens, cache_len) -> list:
    """The top-2 logits of a B = 1 decode of ``prompt`` followed by
    ``tokens``, at its last step."""
    dev = next(iter(params.values())).device
    seq = torch.from_numpy(np.concatenate([prompt, tokens]).astype(
        np.int32)[None]).to(dev)
    caches = bundle.init_cache(1, cache_len, torch.float32, device=dev)
    caches, logits = SERVE.Prefill(bundle)(params, seq, caches)
    return logits[-1][0, -1].topk(2).values.cpu().tolist()


def _same_tokens(label: str, rid: int, a: list, b: list, top2_a: list,
                 top2_b, ties: list) -> None:
    """``a`` == ``b``, or else, at the first token that differs, both
    rows' top-2 gaps within TOL_TIE (a near-tie, recorded in ``ties``);
    ``top2_b`` gives the second row's top-2 there (a list, or a function
    of the position)."""
    if a == b:
        return
    j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
    tb = top2_b(j) if callable(top2_b) else top2_b[j]
    gaps = (_gap(top2_a[j]), _gap(tb))
    log(f"{label}: request {rid} differs at token {j} ({a[j]} vs {b[j]}); "
        f"top-2 {top2_a[j]} and {tb}, relative gaps {gaps[0]:.3g} and "
        f"{gaps[1]:.3g}")
    check(max(gaps) <= TOL_TIE, f"{label}: request {rid} token {j} flip is "
          f"not a near-tie (gaps {gaps})")
    ties.append({"request": rid, "token": j, "top2": [top2_a[j], tb],
                 "gaps": list(gaps)})


def _serve_model(dev, label, cfg, slots, n_req, prompt_range, gen_range,
                 cache_len, n_solo) -> dict:
    """(b), (c): ``n_req`` mixed-length requests through the engine at the
    config's full width and depth (params drawn on the card), under
    continuous and then static admission: the tokens of the two runs
    equal, the first ``n_solo`` requests' equal `solo_generate`'s (a
    differing token allowed only as a near-tie), the logits finite; the
    tokens a second, the median decode tick against its bound (the bytes
    a tick reads: the weights it multiplies, the embedding rows and the
    caches once each), the prefill's ms a prompt token, the occupancy of
    both runs and the card's peak."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bundle = build_bundle(cfg)
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator(device=dev).manual_seed(SERVE_SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(v.numel() for v in params.values())
    aux = params["aux_heads"].numel() if "aux_heads" in params else 0
    rng = np.random.default_rng(SERVE_SEED)
    reqs = [SERVE.ServeRequest(
        request_id=i, kind="generate",
        prompt=rng.integers(0, cfg.vocab_size, int(rng.integers(
            prompt_range[0], prompt_range[1] + 1)), dtype=np.int32),
        max_new_tokens=int(rng.integers(gen_range[0], gen_range[1] + 1)))
        for i in range(n_req)]
    runs = {}
    for admission in ("continuous", "static"):
        eng = SERVE.ContinuousBatchingEngine(
            bundle, params, num_slots=slots, cache_len=cache_len,
            admission=admission, device=dev)
        for r in reqs:
            eng.submit(r)
        clock = EngineClock(eng)
        a = time.perf_counter()
        out = {r.request_id: r.tokens for r in eng.run()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - a
        n_tok = sum(len(t) for t in out.values())
        runs[admission] = {
            "wall_s": wall, "tokens": n_tok, "tokens_per_s": n_tok / wall,
            "tick_ms_median": statistics.median(clock.decode_s) * 1e3,
            "tick_ms": [round(x * 1e3, 3) for x in clock.decode_s],
            "prefill_ms_per_token": sum(clock.prefill_s) * 1e3
            / clock.prompt_tokens,
            "occupancy": eng.occupancy(), "decode_ticks": eng.decode_ticks,
            "out": out, "top2": clock.top2, "finite": clock.finite}
        check(len(out) == n_req, f"serve {label}: {admission} answered "
              f"{len(out)} of {n_req}")
        check(clock.finite, f"serve {label}: {admission} logits finite")
    cont, stat = runs["continuous"], runs["static"]
    ties: list = []
    for r in reqs:
        _same_tokens(f"serve {label} static vs continuous", r.request_id,
                     cont["out"][r.request_id], stat["out"][r.request_id],
                     cont["top2"][r.request_id], stat["top2"][r.request_id],
                     ties)
    for r in reqs[:n_solo]:
        got = cont["out"][r.request_id]
        solo = SERVE.solo_generate(bundle, params, r.prompt,
                                   r.max_new_tokens, cache_len)
        _same_tokens(f"serve {label} continuous vs solo", r.request_id, got,
                     solo, cont["top2"][r.request_id],
                     lambda j, r=r, got=got: _solo_top2(
                         bundle, params, r.prompt, np.asarray(got[:j]),
                         cache_len), ties)
    graph_err = _graph_against_eager(bundle, params, slots, cache_len, dev)
    peak = torch.cuda.max_memory_allocated() / 2**30
    # a tick's bytes: every weight it multiplies (the aux heads are not
    # read), one embedding row a slot, the caches read once and written
    # once
    caches = bundle.init_cache(slots, cache_len, torch.float32, device=dev)
    cache_bytes = sum(v.numel() * v.element_size() for v in caches.values())
    del caches
    w_bytes = sum(v.numel() * v.element_size() for k, v in params.items()
                  if k not in ("embed", "aux_heads"))
    if cfg.tie_embeddings:
        w_bytes += params["embed"].numel() * 4
    tick_bytes = w_bytes + slots * cfg.d_model * 4 + 2 * cache_bytes
    bound_ms = tick_bytes / PEAK_BYTES * 1e3
    # the tick against the roofline: decode_step counted on meta at these
    # slots and caches (the graph replays the same kernels)
    meta_args = (meta_like(params), torch.empty(
        (slots, 1), dtype=torch.int32, device="meta"), bundle.init_cache(
        slots, cache_len, torch.float32, device="meta"))
    a = time.perf_counter()
    _, counted = op_cost.count(bundle.decode_step, *meta_args)
    roof = roofline_row(
        f"serve {label}", counted.to_dict(), counted.peak_bytes
        + op_cost.tree_bytes(meta_args),
        runs["continuous"]["tick_ms_median"], peak,
        model_flops(cfg, n_params - aux, slots, "decode"),
        {"count_s": time.perf_counter() - a, "hand_tick_bytes": tick_bytes,
         "counted_over_hand": counted.bytes / tick_bytes})
    if label == "minitron-4b":
        lo, hi = TICK_BYTES_BAND
        check(lo <= roof["counted_over_hand"] <= hi,
              f"serve {label}: the counted tick bytes {counted.bytes:.6g} "
              f"are {roof['counted_over_hand']:.4f} of the hand reckoning "
              f"{tick_bytes:.6g}, outside [{lo}, {hi}]")
    log(f"serve {label}: {cfg.name} {n_params / 1e9:.3f} B params "
        f"({n_params * 4 / 1e9:.2f} GB f32, aux heads {aux / 1e9:.3f} B, not "
        f"read by decode) drawn in {init_s:.2f} s; {n_req} requests on "
        f"{slots} slots, cache_len {cache_len}")
    for name, r in runs.items():
        log(f"serve {label}: {name}: {r['tokens']} tokens in "
            f"{r['wall_s']:.2f} s ({r['tokens_per_s']:.1f} tokens/s), "
            f"{r['decode_ticks']} ticks, median tick {r['tick_ms_median']:.3f}"
            f" ms (bound {bound_ms:.3f} ms: {tick_bytes / 1e9:.3f} GB), "
            f"prefill {r['prefill_ms_per_token']:.3f} ms a prompt token, "
            f"occupancy {r['occupancy']:.3f}")
    log(f"serve {label}: static == continuous for {n_req} requests, "
        f"{n_solo} == solo_generate; near-ties {ties}; the graph step "
        f"against the eager one {graph_err}; card peak {peak:.1f} GiB")
    del params
    torch.cuda.empty_cache()
    for r in runs.values():
        del r["out"], r["top2"]
    return {"config": cfg.name, "params": n_params, "aux_params": aux,
            "init_s": init_s, "tick_bytes": tick_bytes,
            "tick_bound_ms": bound_ms, "runs": runs, "near_ties": ties,
            "graph_vs_eager": graph_err, "max_memory_gib": peak}


def phase_serve_path(dev) -> dict:
    """The serve path (`repro_torch.serve`): (a) serve_loop through
    `run_serve_scenario`, then decode at published widths through the
    engine, (b) minitron-4b and (c) mamba2-370m, both uncut (`_serve_model`).
    Every kernel's launch count is set to 0 just before (a) and read just
    after (c); topk_wire, dist_ce and emb_dist must have launched."""
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    out = {"serve_loop": _serve_loop(dev)}
    for label, cfg, *rest in SERVE_LM:
        out[label] = _serve_model(dev, label, cfg, *rest)
    out["counts"] = counts = ops.launch_counts()
    for name in SERVE_KERNELS:
        check(counts[name] > 0, f"serve path: kernel {name} launched "
              f"({counts[name]})")
    out["seconds"] = time.perf_counter() - t0
    log(f"serve phase: {out['seconds']:.1f} s; launches {counts}")
    return out


def _pod_batches(n: int, clients: int, seed: int) -> list:
    """``n`` pod batches of POD_CFG's tokens drawn from ``seed``, on the
    host."""
    rng = np.random.default_rng(seed)
    V = POD_CFG.vocab_size
    return [{"private_tokens": torch.from_numpy(rng.integers(
                 0, V, (clients, POD_B, POD_SEQ)).astype(np.int32)),
             "public_tokens": torch.from_numpy(rng.integers(
                 0, V, (POD_B_PUB, POD_SEQ)).astype(np.int32))}
            for _ in range(n)]


def _pod_steps(step, state, batches, dev, what: str) -> tuple:
    """Run ``step`` over ``batches``: (state, metrics and seconds a
    step); every loss finite."""
    hist, secs = [], []
    for t, b in enumerate(batches):
        b = {k: v.to(dev) for k, v in b.items()}
        a = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - a)
        m = {k: float(v) for k, v in m.items()}
        check(all(math.isfinite(v) for v in m.values()),
              f"pod path: {what} step {t} metrics finite ({m})")
        hist.append(m)
    return state, hist, secs


def phase_pod_path(dev) -> dict:
    """The pod path (`core.mhd_distributed`, `launch.steps`): K = 2
    full-width, full-depth mamba2-370m clients on the paper's fused pod
    step in an NCCL group of world size 1 (a FileStore under
    chiprun_out/), a ("pod", "data", "model") mesh of (1, 1, 1) holding
    both: the same 2
    top-k steps first run with no group (mesh None) from the same params,
    and the group's params after them must equal those bitwise; then the
    group's run goes on to POD_TOPK_STEPS top-k and POD_FULL_STEPS full
    steps (losses finite, every client's params moved). Then
    make_mhd_train_step on one student with Δ = 2 teachers' params (the
    fleet's), whose params must not change. Every kernel's count is set to
    0 by the caller just before and read just after; topk_wire, dist_ce,
    emb_dist and ssd_scan must have launched, at shapes the kernel phases
    held. The topk step is counted on meta for its roofline row."""
    import datetime

    import torch.distributed as dist

    from repro_torch.core import mhd_distributed as MD
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import make_mhd_train_step

    t0 = time.perf_counter()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    store = out_dir / "pod_filestore"
    if store.exists():
        store.unlink()
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_test_mesh((1, 1, 1), ("pod", "data", "model"))
        out = _pod_run(dev, mesh, MD, make_mhd_train_step)
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t0
    log(f"pod phase: {out['seconds']:.1f} s")
    return out


def _pod_run(dev, mesh, MD, make_mhd_train_step) -> dict:
    bundle = build_bundle(POD_CFG)
    opt = make_optimizer(OptimizerConfig(**POD_OPTIMIZER))
    mhd = MHDConfig(**POD_MHD)
    topk = MD.DistributedMHDConfig(num_clients=POD_K, exchange="topk",
                                   topk=POD_TOPK)
    full = dataclasses.replace(topk, exchange="full")
    draws = [bundle.init(torch.Generator(device=dev).manual_seed(i))
             for i in range(POD_K)]
    stacked = {k: torch.stack([d.pop(k) for d in draws])
               for k in list(draws[0])}
    del draws
    init = MD.local_params(stacked, bundle, POD_K, mesh)
    del stacked
    n_params = sum(v[0].numel() for v in init.values())
    batches = _pod_batches(POD_TOPK_STEPS + POD_FULL_STEPS, POD_K, POD_SEED)
    log(f"pod path: {POD_K} x {POD_CFG.name} ({n_params / 1e6:.1f} M params "
        f"each, {POD_CFG.num_layers} layers), B = {POD_B} + {POD_B_PUB} "
        f"sequences of {POD_SEQ}, one NCCL rank, mesh "
        f"{tuple(mesh.mesh_dim_names)} {tuple(mesh.mesh.shape)}")
    torch.cuda.reset_peak_memory_stats()
    with KernelShapes() as shapes:
        # (1) the same 2 top-k steps with no group
        alone = {"params": {k: v.clone() for k, v in init.items()}}
        alone["opt"], alone["step"] = opt.init(alone["params"]), 0
        alone, hist0, _ = _pod_steps(
            MD.make_distributed_mhd_step(bundle, opt, mhd, topk), alone,
            batches[:2], dev, "no group")
        ref = alone["params"]
        del alone
        # (2) the group's run: top-k steps, then full ones
        state = {"params": {k: v.clone() for k, v in init.items()}}
        state["opt"], state["step"] = opt.init(state["params"]), 0
        step_topk = MD.make_distributed_mhd_step(bundle, opt, mhd, topk,
                                                 mesh)
        state, hist, secs = _pod_steps(step_topk, state, batches[:2], dev,
                                       "topk")
        same = [k for k in ref if torch.equal(ref[k], state["params"][k])]
        check(len(same) == len(ref), f"pod path: params after 2 top-k "
              f"steps under the NCCL group == with no group, bitwise "
              f"({len(same)} of {len(ref)} leaves)")
        check(hist[:2] == hist0, f"pod path: the group's metrics == no "
              f"group's ({hist[:2]} vs {hist0})")
        del ref
        state, h, s = _pod_steps(step_topk, state,
                                 batches[2:POD_TOPK_STEPS], dev, "topk")
        hist, secs = hist + h, secs + s
        state, h_full, s_full = _pod_steps(
            MD.make_distributed_mhd_step(bundle, opt, mhd, full, mesh),
            state, batches[POD_TOPK_STEPS:], dev, "full")
        moved = []
        for c in range(POD_K):
            n = sum(int(not torch.equal(v[c], init[k][c]))
                    for k, v in state["params"].items())
            moved.append(n)
            check(n > 0, f"pod path: client {c}'s params moved")
        peak_pod = torch.cuda.max_memory_allocated() / 2**30
        del init
        # (3) make_mhd_train_step: client 0 a student of Δ = 2 teachers
        teachers = {k: v.detach().clone() for k, v in
                    state["params"].items()}
        del state
        frozen = {k: v.clone() for k, v in teachers.items()}
        student = {k: v[0].clone() for k, v in teachers.items()}
        st = {"params": student, "opt": opt.init(student), "step": 0}
        start = {k: v.clone() for k, v in student.items()}
        mhd2 = MHDConfig(**dict(POD_MHD, delta=2))
        mstep = make_mhd_train_step(bundle, opt, mhd2)
        m_hist, m_secs = [], []
        for t, b in enumerate(_pod_batches(POD_MHD_STEPS, 1, POD_SEED + 1)):
            batch = {"private_tokens": b["private_tokens"][0].to(dev),
                     "public_tokens": b["public_tokens"].to(dev),
                     "teacher_params": teachers}
            a = time.perf_counter()
            st, m = mstep(st, batch)
            torch.cuda.synchronize()
            m_secs.append(time.perf_counter() - a)
            m = {k: float(v) for k, v in m.items()}
            check(math.isfinite(m["loss"]), f"pod path: mhd_train_step "
                  f"{t} loss finite")
            m_hist.append(m)
        check(all(torch.equal(teachers[k], frozen[k]) for k in frozen),
              "pod path: the teachers' params unchanged")
        check(any(not torch.equal(st["params"][k], start[k])
                  for k in start), "pod path: the student's params moved")
    counts = ops.launch_counts()
    shapes.check("pod path")
    for name in POD_KERNELS:
        check(counts[name] > 0, f"pod path: kernel {name} launched "
              f"({counts[name]})")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del teachers, frozen, student, st, start
    torch.cuda.empty_cache()
    med = statistics.median(secs[1:]) * 1e3
    med_full = statistics.median(s_full) * 1e3
    log(f"pod path: top-k steps {[round(x * 1e3, 1) for x in secs]} ms "
        f"(median after the first {med:.1f}), full steps "
        f"{[round(x * 1e3, 1) for x in s_full]} ms; losses "
        f"{[round(m['loss'], 4) for m in hist + h_full]}; every leaf of "
        f"each client moved: {moved}; card memory peak {peak_pod:.1f} GiB "
        f"(pod steps), {peak:.1f} GiB with make_mhd_train_step "
        f"({[round(x * 1e3, 1) for x in m_secs]} ms, losses "
        f"{[round(m['loss'], 4) for m in m_hist]}); launches {counts}")
    row = _pod_roofline(bundle, opt, mhd, topk, MD, med, peak_pod)
    return {"counts": counts, "step_s": secs, "full_step_s": s_full,
            "median_ms": med, "full_median_ms": med_full,
            "metrics": hist + h_full, "moved_leaves": moved,
            "mhd_train_step": {"metrics": m_hist, "step_s": m_secs},
            "params_per_client": n_params, "max_memory_gib": peak,
            "pod_max_memory_gib": peak_pod,
            "kernel_shapes": shapes.record(), "roofline": row}


def _pod_roofline(bundle, opt, mhd, topk, MD, step_ms: float,
                  max_memory_gib: float) -> dict:
    """The top-k pod step (both clients on one rank, no group) counted on
    meta: its roofline row against the measured median."""
    from repro_torch.models.layers import MetaDraw

    t0 = time.perf_counter()
    p = bundle.init(MetaDraw().manual_seed(0))
    local = MD.local_params({k: v.unsqueeze(0).expand(POD_K, *v.shape)
                             for k, v in p.items()}, bundle, POD_K)
    state = {"params": local, "opt": opt.init(local), "step": 0}
    b = _pod_batches(1, POD_K, POD_SEED)[0]
    batch = {k: torch.empty_like(v, device="meta") for k, v in b.items()}
    args = (state, batch)
    _, counter = op_cost.count(MD.make_distributed_mhd_step(
        bundle, opt, mhd, topk), *args)
    n = sum(v.numel() for v in p.values())
    tokens = (POD_B + POD_B_PUB) * POD_SEQ
    return roofline_row(
        "pod", counter.to_dict(),
        op_cost.tree_bytes(args) + counter.peak_bytes, step_ms,
        max_memory_gib, POD_K * model_flops(POD_CFG, n, tokens, "train"),
        {"clients": POD_K, "count_s": time.perf_counter() - t0,
         "kernels": counter.kernels})

# ---------------------------------------------------------------------------
# the tp path: tensor and FSDP sharding within a pod
# ---------------------------------------------------------------------------

def _tp_batches(dev, cfg, seq: int) -> list:
    rng = np.random.default_rng(TP_SEED)
    return [{"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TP_B, seq)).astype(np.int32)).to(dev)}
            for _ in range(TP_STEPS)]


def _tp_init(dev, cfg) -> dict:
    """``cfg``'s params drawn on ``dev`` from TP_SEED (the same draw in
    every process)."""
    return build_bundle(cfg).init(
        torch.Generator(device=dev).manual_seed(TP_SEED))


def _tp_steps(dev, params: dict, cfg, seq: int) -> tuple:
    """make_train_step over the tp batches from ``params`` under whatever
    mesh is active: (params after, metrics a step with the norm the
    optimizer clipped by as "grad_norm", seconds a step)."""
    bundle = build_bundle(cfg)
    base = make_optimizer(OptimizerConfig(**TP_OPTIMIZER))
    norms = []

    def update(grads, state, params, step):
        norms.append(global_norm(grads))
        return base.update(grads, state, params, step)

    opt = Optimizer(base.init, update)
    step = make_train_step(bundle, opt)
    state = {"params": params, "opt": opt.init(params), "step": 0}
    hist, secs = [], []
    for t, b in enumerate(_tp_batches(dev, cfg, seq)):
        a = time.perf_counter()
        state, m = step(state, b)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - a)
        hist.append({k: float(v) for k, v in m.items()})
        hist[-1]["grad_norm"] = float(norms[t])
    return state["params"], hist, secs


def _check_collectives(rank: int, world: int, dev) -> dict:
    """Each collective the sharded step runs, over the running group on
    ``dev``'s tensors, against its expected result: {collective: "ok" or
    what went wrong}. Two processes on one card run over gloo (NCCL
    refuses two ranks on one card)."""
    import torch.distributed as dist

    x = torch.full((2, 3), float(rank + 1), device=dev)
    total = sum(range(1, world + 1))
    # uneven all-to-all: rank 0 keeps 2 of its 3 rows and sends 1 to rank
    # 1, every other rank sends its one row to rank 0
    rows = 3 if rank == 0 else 1
    send = [2, 1] + [0] * (world - 2) if rank == 0 else [1] + [0] * (
        world - 1)
    recv = [2] + [1] * (world - 1) if rank == 0 else [1 if rank == 1 else 0
                                                      ] + [0] * (world - 1)
    want_a2a = ([0.0, 1.0] + [10.0 * r for r in range(1, world)]
                if rank == 0 else [2.0] if rank == 1 else [])

    def all_to_all():
        out = torch.empty(sum(recv), device=dev)
        dist.all_to_all_single(out, torch.arange(float(rows), device=dev)
                               + 10 * rank, output_split_sizes=recv,
                               input_split_sizes=send)
        return out

    def gathered():
        out = torch.empty(2 * world, 3, device=dev)
        dist.all_gather_into_tensor(out, x)
        return out

    def scattered():
        out = torch.empty(2, 3, device=dev)
        dist.reduce_scatter_tensor(out, torch.ones(2 * world, 3, device=dev)
                                   * (rank + 1))
        return out

    def reduced(op):
        y = x.clone()
        dist.all_reduce(y, op=op)
        return y

    cases = {"all_gather_into_tensor": (gathered, torch.cat(
                 [torch.full((2, 3), float(r + 1)) for r in range(world)])),
             "reduce_scatter_tensor": (scattered,
                                       torch.full((2, 3), float(total))),
             "all_reduce": (lambda: reduced(dist.ReduceOp.SUM),
                            torch.full((2, 3), float(total))),
             "all_reduce max": (lambda: reduced(dist.ReduceOp.MAX),
                                torch.full((2, 3), float(world))),
             "all_to_all_single": (all_to_all, torch.tensor(want_a2a))}
    out = {}
    for name, (fn, want) in cases.items():
        try:
            got = fn()
            ok = got.device == x.device and torch.equal(got.cpu(), want)
            out[name] = "ok" if ok else f"wrong result {got.tolist()}"
        except Exception as e:  # recorded; the caller fails the phase
            out[name] = f"{type(e).__name__}: {e}"[:300]
    return out


def _tp_rank(rank: int, world: int, store: str, results, done, cfg,
             seq: int, device_type: str) -> None:
    """One model rank of the tp path's (3): the collectives checked over
    the group (`_check_collectives`), then its blocks of the same draw and
    the same steps on a (1, world) mesh over gloo; puts (rank, the
    collectives' check, metrics, seconds, coords, specs, its blocks on the
    card, its memory peak) on ``results`` and holds them until
    ``done``."""
    import datetime

    import torch.distributed as dist

    from repro_torch.common.sharding import active_partition, use_mesh
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import mesh_specs, shard_rank

    cuda = device_type == "cuda"
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(dev)
        build.build_cuda(["flash_attention"])
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        probe = _check_collectives(rank, world, dev)
        mesh = make_test_mesh((1, world), ("data", "model"), device_type)
        with use_mesh(mesh):
            part = active_partition()
            specs = mesh_specs(build_bundle(cfg), part)
            params = {k: v.clone() for k, v in shard_rank(
                _tp_init(dev, cfg), specs, part).items()}
            if cuda:
                torch.cuda.empty_cache()
            params, hist, secs = _tp_steps(dev, params, cfg, seq)
        coords = {a: int(mesh.get_local_rank(a))
                  for a in mesh.mesh_dim_names}
        peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
        if cuda:
            # hold the blocks only: the main process compares them on the
            # card beside every other process's
            torch.cuda.empty_cache()
        results.put((rank, probe, hist, secs, coords, specs, params, peak))
        done.wait(TP_TIMEOUT)
    finally:
        dist.destroy_process_group()


def _spawn(target, world: int, store: Path, *extra) -> tuple:
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store.parent.mkdir(exist_ok=True)
    if store.exists():
        store.unlink()
    procs = [ctx.Process(target=target, args=(r, world, str(store), results,
                                               *extra))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, results


def _collect(results, procs, timeout: float):
    """Each rank's item from ``results``, in arrival order, failing as
    soon as a rank exits without giving one or ``timeout`` seconds
    pass."""
    import queue

    deadline = time.perf_counter() + timeout
    for _ in procs:
        while True:
            try:
                yield results.get(timeout=2)
                break
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode]
                check(not dead and time.perf_counter() < deadline,
                      f"a rank failed (exit codes {dead}) or "
                      f"{timeout:.0f} s passed before every rank answered")


def _reap(procs, timeout: float) -> list:
    """Join ``procs`` within ``timeout`` seconds, terminating any left;
    their exit codes."""
    deadline = time.perf_counter() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.perf_counter()))
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(10)
    return [p.exitcode for p in procs]


def phase_tp_path(dev) -> dict:
    """The tp path (`launch.steps.make_train_step` under `use_mesh`, the
    sharding within a pod): TP_CFG's step (1) with no mesh, (2) on a
    (data, model) mesh of (1, 1) in an NCCL group of world size 1,
    bitwise equal to (1), and (3) on a (1, TP_MODEL) mesh across TP_MODEL
    processes on the card over gloo, each first checking every collective
    the step runs, held against (1). Every kernel's count is set to 0 by
    the caller just before and read just after (the main process's runs,
    (1) and (2)); flash_attention must have launched, at shapes the
    kernel phase held."""
    import datetime

    import torch.distributed as dist

    from repro_torch.common.sharding import use_mesh
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.shardings import shard_leaf

    t0 = time.perf_counter()
    n_params = sum(v.numel() for v in build_bundle(TP_CFG).init(
        LAYERS.MetaDraw().manual_seed(0)).values())
    log(f"tp path: {TP_CFG.name} at full width ({n_params / 1e9:.3f} B "
        f"params, {TP_DEPTH} of {_TP_FULL.num_layers} layers), "
        f"{TP_B} x {TP_SEQ} tokens, SGD momentum, {TP_STEPS} steps")
    torch.cuda.reset_peak_memory_stats()
    with KernelShapes() as shapes:
        # (1) no mesh; its params kept on the host
        ref, hist0, secs0 = _tp_steps(dev, _tp_init(dev, TP_CFG), TP_CFG,
                                      TP_SEQ)
        ref = {k: v.cpu() for k, v in ref.items()}
        torch.cuda.empty_cache()
        # (2) a (1, 1) mesh under NCCL
        store = ROOT / "chiprun_out" / "tp_filestore"
        store.parent.mkdir(exist_ok=True)
        if store.exists():
            store.unlink()
        dist.init_process_group("nccl", init_method=f"file://{store}",
                                rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=60))
        try:
            mesh = make_test_mesh((1, 1), ("data", "model"))
            with use_mesh(mesh):
                got, hist, secs = _tp_steps(dev, _tp_init(dev, TP_CFG),
                                            TP_CFG, TP_SEQ)
        finally:
            dist.destroy_process_group()
        same = [k for k in ref if torch.equal(ref[k], got[k].cpu())]
        check(len(same) == len(ref), f"tp path: params after {TP_STEPS} "
              f"steps on a (1, 1) mesh under NCCL == with no mesh, bitwise "
              f"({len(same)} of {len(ref)} leaves)")
        check(hist == hist0, f"tp path: the mesh's metrics == no mesh's "
              f"({hist} vs {hist0})")
        check(all(math.isfinite(v) for m in hist for v in m.values()),
              "tp path: metrics finite")
        clip = TP_OPTIMIZER["grad_clip_norm"]
        check(all(m["grad_norm"] > clip for m in hist0), f"tp path: the "
              f"clip binds: gradient norms {[m['grad_norm'] for m in hist0]}"
              f" > {clip}")
        del got
        torch.cuda.empty_cache()
        # the logit softcap: the same model with attn_logit_softcap set
        capped = dataclasses.replace(TP_CFG, attn_logit_softcap=SOFTCAP)
        got, hist_cap, secs_cap = _tp_steps(dev, _tp_init(dev, capped),
                                            capped, TP_SEQ)
        del got
        check(all(math.isfinite(v) for m in hist_cap for v in m.values()),
              f"tp path: softcap {SOFTCAP:g} metrics finite ({hist_cap})")
        check(hist_cap[0]["loss"] != hist0[0]["loss"], "tp path: the "
              "softcap changes the loss")
        capped_launches = sum(n for key, n in shapes.seen[
            "flash_attention"].items() if key[-1] == SOFTCAP)
        check(capped_launches > 0, "tp path: flash_attention launched "
              f"with softcap {SOFTCAP:g} ({capped_launches})")
    counts = ops.launch_counts()
    shapes.check("tp path")
    for name in TP_KERNELS:
        check(counts[name] > 0, f"tp path: kernel {name} launched "
              f"({counts[name]})")
    peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    out = {"counts": counts, "step_s": secs0, "mesh_step_s": secs,
           "metrics": hist0, "params": n_params, "max_memory_gib": peak,
           "kernel_shapes": shapes.record(),
           "softcap": {"c": SOFTCAP, "step_s": secs_cap,
                       "metrics": hist_cap,
                       "flash_launches": capped_launches}}
    log(f"tp path: no mesh {[round(x * 1e3, 1) for x in secs0]} ms, (1, 1) "
        f"mesh {[round(x * 1e3, 1) for x in secs]} ms a step, losses "
        f"{[round(m['loss'], 5) for m in hist0]}, gradient norms "
        f"{[round(m['grad_norm'], 4) for m in hist0]} clipped to "
        f"{TP_OPTIMIZER['grad_clip_norm']}; softcap {SOFTCAP:g}: "
        f"{[round(x * 1e3, 1) for x in secs_cap]} ms a step, losses "
        f"{[round(m['loss'], 5) for m in hist_cap]}, {capped_launches} "
        f"capped forward launches; card memory peak {peak:.1f} GiB, "
        f"launches {counts}")
    out["model_ranks"] = _tp_model_ranks(dev, ref, hist0, shard_leaf)
    out["roofline"] = _tp_roofline(statistics.median(secs0), peak)
    out["seconds"] = time.perf_counter() - t0
    log(f"tp phase: {out['seconds']:.1f} s")
    return out


def _tp_model_ranks(dev, ref: dict, hist0: list, shard_leaf) -> dict:
    """(3): TP_MODEL processes on the card, each its blocks; every
    collective right over their group, their metrics against (1)'s at
    TP_RTOL, every block against (1)'s block (moved to the card a leaf at
    a time) at TP_ATOL."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    done = mp.get_context("spawn").Event()
    procs, results = _spawn(_tp_rank, TP_MODEL,
                            ROOT / "chiprun_out" / "tp2_filestore", done,
                            TP_CFG, TP_SEQ, dev.type)
    worst, metrics_err, ranks = 0.0, 0.0, {}
    try:
        for rank, probe, hist, secs, coords, specs, params, peak in \
                _collect(results, procs, TP_TIMEOUT):
            check(all(v == "ok" for v in probe.values()), f"tp path: rank "
                  f"{rank}'s collectives over gloo on the card: {probe}")
            ranks[rank] = {"step_s": secs, "max_memory_gib": peak,
                           "metrics": hist, "collectives": probe}
            for m, m0 in zip(hist, hist0):
                for k in m0:
                    d = abs(m[k] - m0[k])
                    metrics_err = max(metrics_err, d and d / abs(m0[k])
                                      if m0[k] else d and math.inf)
            sizes = {"data": 1, "model": TP_MODEL}
            for k, v in params.items():
                want = shard_leaf(ref[k], specs.get(k, ()), sizes, coords)
                worst = max(worst,
                            float((v - want.to(v.device)).abs().max()))
            del params
    finally:
        done.set()
        codes = _reap(procs, 60)
    check(codes == [0] * TP_MODEL, f"tp path: the model ranks exited "
          f"{codes}")
    check(len(ranks) == TP_MODEL and metrics_err <= TP_RTOL,
          f"tp path: model = {TP_MODEL} metrics against no mesh "
          f"{metrics_err:.3g} (tolerance {TP_RTOL} relative)")
    check(worst <= TP_ATOL, f"tp path: model = {TP_MODEL} params against "
          f"no mesh max|d| {worst:.3g} (tolerance {TP_ATOL})")
    out = {"ranks": ranks, "metrics_rel_err": metrics_err,
           "params_max_abs_err": worst, "exit_codes": codes,
           "seconds": time.perf_counter() - t0}
    rs = list(ranks.values())
    log(f"tp path: model = {TP_MODEL} across {TP_MODEL} processes on one "
        f"card over gloo, every collective right: metrics within "
        f"{metrics_err:.3g} relative, params within {worst:.3g} of no mesh;"
        f" steps {[[round(x * 1e3, 1) for x in r['step_s']] for r in rs]} "
        f"ms; peaks {[round(r['max_memory_gib'], 1) for r in rs]}"
        f" GiB; {out['seconds']:.1f} s")
    return out


def _tp_roofline(step_ms_s: float, max_memory_gib: float) -> dict:
    """The tp path's step with no mesh, counted on meta: its roofline row
    against the measured median."""
    bundle = build_bundle(TP_CFG)
    opt = make_optimizer(OptimizerConfig(**TP_OPTIMIZER))
    state = train_state_shapes(bundle, opt)
    batch = {"tokens": torch.empty((TP_B, TP_SEQ), dtype=torch.int32,
                                   device="meta")}
    args = (state, batch)
    _, counter = op_cost.count(make_train_step(bundle, opt), *args)
    n = sum(v.numel() for v in state["params"].values())
    return roofline_row(
        "tp", counter.to_dict(), op_cost.tree_bytes(args)
        + counter.peak_bytes, step_ms_s * 1e3, max_memory_gib,
        model_flops(TP_CFG, n, TP_B * TP_SEQ, "train"),
        {"kernels": counter.kernels})


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
    torch.cuda.reset_peak_memory_stats()
    trainer, resnet = phase_resnet_path(dev)
    RECORD["profile_resnet"] = phase_profile(trainer, STEPS, S_P, "resnet")
    mhd_roofline("resnet", trainer, CFG, resnet["step_s"],
                 torch.cuda.max_memory_allocated() / 2**30)
    del trainer
    torch.cuda.empty_cache()
    exp_path = phase_exp_path(dev, statistics.median(resnet["step_s"][1:]))
    torch.cuda.empty_cache()
    fleet_path = phase_fleet_path(dev)
    torch.cuda.empty_cache()
    socket_path = phase_socket_path(dev)
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    trainer, lm_path = phase_lm_path(dev, LM_CFG, "lm", LM_KERNELS)
    RECORD["profile_lm"] = phase_profile(trainer, LM_STEPS, LM_S_P, "lm")
    mhd_roofline("lm", trainer, LM_CFG, lm_path["step_s"],
                 lm_path["max_memory_gib"], LM_TOKENS)
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
    mhd_roofline("zamba2", trainer, ZAMBA_CFG, zamba_path["step_s"],
                 zamba_path["max_memory_gib"], LM_TOKENS)
    del trainer
    torch.cuda.empty_cache()
    moe_path = phase_moe_path(dev)
    torch.cuda.empty_cache()
    deepseek_path = phase_deepseek_path(dev)
    torch.cuda.empty_cache()
    xattn_path = phase_xattn_path(dev)
    torch.cuda.empty_cache()
    serve_path = phase_serve_path(dev)
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    pod_path = phase_pod_path(dev)
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    tp_path = phase_tp_path(dev)
    paths = {"resnet": resnet, "exp": exp_path["mhd"], "fleet": fleet_path,
             "socket": socket_path, "lm": lm_path, "zamba2": zamba_path,
             "moe": moe_path, "deepseek": deepseek_path, "xattn": xattn_path,
             "serve": serve_path, "pod": pod_path, "tp": tp_path}
    for k in kernels:
        k["launches_by_path"] = {p: r["counts"][k["name"]]
                                 for p, r in paths.items()}
        k["launches"] = sum(k["launches_by_path"].values())
    RECORD["roofline"] = ROOFLINE
    RECORD.update(kernels=kernels, resnet_path=resnet, exp_path=exp_path,
                  fleet_path=fleet_path, socket_path=socket_path,
                  lm_path=lm_path, zamba2_path=zamba_path, moe_path=moe_path,
                  deepseek_path=deepseek_path, xattn_path=xattn_path,
                  serve_path=serve_path, pod_path=pod_path,
                  tp_path=tp_path,
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
