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
     forward and backward — against its plain PyTorch version on the card,
     at the main path's shapes, at one larger shape and on a ties case,
     and times kernel, plain version and one library yardstick with CUDA
     events (median of repeated calls);
  4. checks the fused wire encode on the card byte for byte against the
     numpy host path, and the Eq. 1 loss with its gradients on the
     kernels against the plain path on the CPU;
  5. drives the main path through the user's entry points: K=3 ResNet-18
     clients (width 64, 1000 classes, 4 aux heads) exchanging top-k
     predictions, 12 steps and one evaluate(), with every kernel's launch
     count set to 0 just before and read just after;
  6. runs one more publish round of the path under torch.profiler: the
     card's busy share of the wall time and its time by kernel (table in
     ``chiprun_out/profile.txt``);
  7. prints one ``{"kernels": [...]}`` line and, last, the device line
     ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and never prints
the last line. The full record also goes to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import os
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
                              frame_overhead_nbytes, topk_frame_nbytes)
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import (DecentralizedTrainer, MHDConfig,  # noqa: E402
                              RunConfig, complete_graph, mhd_total_loss)
from repro_torch import data  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import dist_ce as DCE  # noqa: E402
from repro_torch.kernels import emb_dist as EMB  # noqa: E402
from repro_torch.kernels import topk_wire as TOPK  # noqa: E402
from repro_torch.models import build_bundle  # noqa: E402
from repro_torch.optim import OptimizerConfig, make_optimizer  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, fp32 (no
# tensor cores) flop/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12

# the main path's run
K, NUM_LABELS, STEPS, S_P, POOL, TOPK_K = 3, 1000, 12, 4, 3, 32
BATCH = 32
CFG = ARCHS["resnet18-imagenet"]["full"]()  # ResNet-18, 1000 classes, H=5
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


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def maxerr(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


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
    build.build_cuda(["topk_wire"])
    log(f"build: nvcc {time.perf_counter() - t0:.2f} s")
    for line in (build.BUILD_DIR / "topk_wire.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def phase_topk(dev) -> dict:
    g = torch.Generator(device=dev).manual_seed(0)
    rows = 4 * H * BATCH  # W·H·B of one publish
    err = 0.0
    cases = [("slice", torch.randn(rows, NUM_LABELS, generator=g,
                                   device=dev) * 3, TOPK_K),
             ("large", torch.randn(rows, 32768, generator=g, device=dev) * 3,
              TOPK_K),
             # either side of where the row stops fitting in shared memory
             # beside the kernel's static scratch
             ("smem row", torch.randn(64, 12000, generator=g, device=dev),
              TOPK_K),
             ("48 KB row", torch.randn(64, 12288, generator=g, device=dev),
              TOPK_K),
             ("ties", torch.randint(-3, 3, (64, NUM_LABELS), generator=g,
                                    device=dev).float(), TOPK_K),
             ("k=V", torch.randn(8, 40, generator=g, device=dev), 40)]
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
    x = cases[0][1]
    ms = time_ms(lambda: TOPK.topk_wire_kernel(x, TOPK_K))
    plain = time_ms(lambda: TOPK.topk_wire_plain(x, TOPK_K))
    lib = time_ms(lambda: (torch.topk(x, TOPK_K, dim=-1),
                           torch.logsumexp(x, dim=-1)))
    B, V = x.shape
    b_ms, b_by = bound(B * V * 4 + B * TOPK_K * 8 + B * 4, 3 * B * V)
    return {**TOPK.INFO, "shape": [B, V, TOPK_K], "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib}


def _dist_ce_library(s, t):
    logp = F.log_softmax(s, dim=-1)
    p_t = F.softmax(t, dim=-1)
    return -(p_t * logp).sum(-1), p_t.amax(-1), logp.amax(-1).exp()


def phase_dist_ce(dev) -> list:
    g = torch.Generator(device=dev).manual_seed(1)
    rows = 2 * BATCH  # n_cand·B of one aux level
    err_f, err_b = 0.0, 0.0
    cases = [("slice", rows, NUM_LABELS, torch.float32, 3.0),
             ("large", rows, 32768, torch.float32, 3.0),
             ("bf16", rows, NUM_LABELS, torch.bfloat16, 3.0),
             ("ties", rows, NUM_LABELS, torch.float32, 0.0)]
    for name, B, V, dt, scale in cases:
        s = (torch.randn(B, V, generator=g, device=dev) * 3).to(dt)
        t = (torch.randn(B, V, generator=g, device=dev) * scale).to(dt)
        gce = torch.randn(B, generator=g, device=dev)
        out = DCE.dist_ce_fwd_kernel(s, t)
        ref = DCE.dist_ce_fwd_plain(s, t)
        gs = DCE.dist_ce_bwd_kernel(s, t, out[3], gce)
        gs_ref = DCE.dist_ce_bwd_plain(s, t, ref[3], gce)
        torch.cuda.synchronize()
        tol = TOL_F32 if dt == torch.float32 else TOL_BF16
        for a, b, nm in zip(out[:3], ref[:3], ("ce", "t_conf", "s_conf")):
            check(close(a, b, tol, tol), f"dist_ce {name}: {nm}")
            if dt == torch.float32:
                err_f = max(err_f, maxerr(a, b))
        if dt == torch.float32:
            check(close(gs, gs_ref, TOL_F32, TOL_GRAD_ABS),
                  f"dist_ce bwd {name}")
        else:
            check(close(gs, gs_ref, TOL_BF16_GRAD_REL, TOL_BF16_GRAD_ABS),
                  f"dist_ce bwd {name}")
        if dt == torch.float32:
            err_b = max(err_b, maxerr(gs, gs_ref))
        log(f"dist_ce {name} ({B}, {V}) {dt}: fwd max|d|="
            f"{max(maxerr(a, b) for a, b in zip(out[:3], ref[:3])):.3g} "
            f"bwd max|d|={maxerr(gs, gs_ref):.3g}")
    B, V = rows, NUM_LABELS
    s = torch.randn(B, V, generator=g, device=dev) * 3
    t = torch.randn(B, V, generator=g, device=dev) * 3
    gce = torch.randn(B, generator=g, device=dev)
    stats = DCE.dist_ce_fwd_kernel(s, t)[3]
    fb, fby = bound(2 * B * V * 4 + 7 * B * 4, 8 * B * V)
    bb, bby = bound(3 * B * V * 4 + 5 * B * 4, 6 * B * V)
    fwd = {**DCE.INFO_FWD, "shape": [B, V], "max_abs_err": err_f,
           "ms": time_ms(lambda: DCE.dist_ce_fwd_kernel(s, t)),
           "plain_ms": time_ms(lambda: DCE.dist_ce_fwd_plain(s, t)),
           "bound_ms": fb, "bound_by": fby,
           "library_ms": time_ms(lambda: _dist_ce_library(s, t))}
    bwd = {**DCE.INFO_BWD, "shape": [B, V], "max_abs_err": err_b,
           "ms": time_ms(lambda: DCE.dist_ce_bwd_kernel(s, t, stats, gce)),
           "plain_ms": time_ms(
               lambda: DCE.dist_ce_bwd_plain(s, t, stats, gce)),
           "bound_ms": bb, "bound_by": bby, "library_ms": None}
    return [fwd, bwd]


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


def phase_path(dev) -> dict:
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
    log(f"path: data + {K} x {CFG.name} init + seed publish "
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
            check(math.isfinite(mt[f"c{i}/loss"]), f"path: c{i} loss at {t}")
    check(distilled == REFERENCE_DISTILLED,
          f"path: distilled {distilled} != the reference's schedule "
          f"{REFERENCE_DISTILLED}")
    for name, n in counts.items():
        check(n > 0, f"path: kernel {name} launched ({n})")
    W = S_P
    expect = W * topk_frame_nbytes(
        BATCH, TOPK_K, num_heads=H, emb_dim=E, val_bytes=2, idx_bytes=2,
        lse_bytes=4, emb_bytes_per_dim=1, emb_scale_bytes=4, hash_bytes=8) \
        + frame_overhead_nbytes({"sample_ids": 2, "vals": 4, "idx": 4,
                                 "lse": 3, "emb_q": 3, "emb_scale": 2})
    check(len(transport.frames) > 0, "path: frames published")
    for payload in transport.frames:
        msg = trainer.codec.decode(payload)
        check(len(payload) == expect, f"path: frame {len(payload)} B "
                                      f"!= {expect} B")
        check(msg.arrays["vals"].shape == (W, H, BATCH, TOPK_K),
              "path: frame shape")
    meter = trainer.meter
    check(dict(meter.by_edge) == dict(meter.by_edge_delivered),
          "path: delivered == offered on every edge")
    for k, v in ev.items():
        check(math.isfinite(v), f"path: {k} finite")
    med = statistics.median(step_s[1:])
    log(f"path: {STEPS} steps, step time median {med * 1e3:.1f} ms "
        f"(first {step_s[0] * 1e3:.1f} ms; publish steps "
        f"{[round(step_s[t] * 1e3, 1) for t in range(S_P - 1, STEPS, S_P)]}"
        f" ms), evaluate {eval_s:.2f} s")
    log(f"path: distill_active per client and step {distilled}")
    log(f"path: {len(transport.frames)} frames of {expect} B; "
        f"launches {counts}")
    log(f"path: mean/main/beta_sh={ev['mean/main/beta_sh']:.4f} "
        f"mean/aux4/beta_sh={ev['mean/aux4/beta_sh']:.4f} final loss "
        f"{[round(history[-1][f'c{i}/loss'], 4) for i in range(K)]}")
    return trainer, {"counts": counts, "step_s": step_s, "eval_s": eval_s,
            "frame_bytes": expect, "frames": len(transport.frames),
            "distilled": distilled,
            "beta": {k: v for k, v in ev.items() if k.startswith("mean/")},
            "final_loss": [history[-1][f"c{i}/loss"] for i in range(K)]}


def phase_profile(trainer) -> dict:
    """One more publish round (S_P steps) of the path under
    torch.profiler — device busy share of the wall time and device time by
    kernel. The table goes to chiprun_out/profile.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(STEPS, STEPS + S_P):
            trainer.step(t)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in kernels)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile.txt").write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=60))
    top = [{"kernel": e.key[:90], "calls": e.count,
            "device_us": e.self_device_time_total} for e in kernels[:15]]
    ours = {}
    for info, _ in ops.KERNELS:
        rows = [e for e in kernels if f"{info['name']}_kernel" in e.key]
        n = sum(e.count for e in rows)
        total = sum(e.self_device_time_total for e in rows)
        ours[info["name"]] = {"calls": n, "device_us": total,
                              "us_per_call": total / n if n else None}
    log(f"profile: {S_P} steps, wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f} %), "
        f"{sum(e.count for e in kernels)} kernel launches")
    for row in top:
        log(f"  {row['device_us'] / 1e3:8.2f} ms {row['calls']:6d}x "
            f"{row['kernel']}")
    log(f"profile: the port's kernels on the card {ours}")
    return {"wall_us": wall_us, "busy_us": busy_us, "top": top,
            "ours_us_per_call": ours,
            "launches": sum(e.count for e in kernels)}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs on the "
              "GPU only", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    RECORD["device"] = phase_device()
    phase_build()
    kernels = [phase_topk(dev), *phase_dist_ce(dev), *phase_emb_dist(dev)]
    phase_wire(dev)
    phase_loss(dev)
    ops.reset_launch_counts()
    trainer, path = phase_path(dev)
    RECORD["profile"] = phase_profile(trainer)
    for k in kernels:
        k["launches"] = path["counts"][k["name"]]
    RECORD.update(kernels=kernels, path=path,
                  seconds=time.perf_counter() - t_start)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(RECORD, indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
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
