#!/usr/bin/env python3
"""Where a pod step's time goes on one card: chip_smoke's pod path (K = 2
mamba2-370m clients at full width and depth on the fused pod step of
`repro_torch.core.mhd_distributed`, 4 + 4 sequences of 512, SGD
momentum), with no process group.

    python3 ablations/pod_step.py

Builds the CUDA kernels, draws both clients on the card, runs a warm-up
step of each exchange, then times rounds of 3 top-k and 3 full steps
in turns (top-k, full, top-k, full; the host wall of each step to a
synchronize), then one profiled step of each exchange
(`chip_smoke._step_profile`: the device's busy share of the wall, its
time by category — the f32 GEMMs, the heads' products and softmaxes,
each hand kernel, the rest — and the ops that take the most; the tables
go to chiprun_out/profile_pod-{topk,full}.txt). Prints the card's name
and power limit first.
"""
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from repro_torch.core import mhd_distributed as MD  # noqa: E402


def main() -> None:
    dev = torch.device("cuda", 0)
    c.phase_device()
    c.build.build_cuda(["topk_wire", "ssd_scan"])
    bundle = c.build_bundle(c.POD_CFG)
    opt = c.make_optimizer(c.OptimizerConfig(**c.POD_OPTIMIZER))
    mhd = c.MHDConfig(**c.POD_MHD)
    steps = {ex: MD.make_distributed_mhd_step(
        bundle, opt, mhd, MD.DistributedMHDConfig(
            num_clients=c.POD_K, exchange=ex, topk=c.POD_TOPK))
        for ex in ("topk", "full")}
    draws = [bundle.init(torch.Generator(device=dev).manual_seed(i))
             for i in range(c.POD_K)]
    params = {k: torch.stack([d.pop(k) for d in draws])
              for k in list(draws[0])}
    state = {"params": params, "opt": opt.init(params), "step": 0}
    batches = [{k: v.to(dev) for k, v in b.items()}
               for b in c._pod_batches(2, c.POD_K, c.POD_SEED)]
    secs = {"topk": [], "full": []}
    for ex in ("topk", "full"):  # warm-up: each exchange's first launches
        state, _ = steps[ex](state, batches[0])
    torch.cuda.synchronize()
    for ex in ("topk", "full", "topk", "full"):
        for t in range(3):
            a = time.perf_counter()
            state, _ = steps[ex](state, batches[t % 2])
            torch.cuda.synchronize()
            secs[ex].append(time.perf_counter() - a)
    for ex, s in secs.items():
        c.log(f"pod {ex} steps {[round(x * 1e3, 1) for x in s]} ms, median "
              f"{statistics.median(s) * 1e3:.1f} ms")
    for ex in ("topk", "full"):
        state, _ = c._step_profile(steps[ex], state, batches[0],
                                     f"pod-{ex}", c.POD_CFG.vocab_size)
    c.log(f"card memory peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB")


if __name__ == "__main__":
    main()
