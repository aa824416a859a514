#!/usr/bin/env python3
"""The ``topk_wire`` wrapper of one checkout, timed at the three paths'
shapes, to hold two versions of the kernel against each other on one card.

    python3 ablations/topk_wire_pair.py CHECKOUT

CHECKOUT is the root of a checkout (this one, ``.``, or an older commit
unpacked with ``git archive``); its ``src/`` is imported and its kernel
built from its own sources. At the ResNet path's shape (640 x 1000, k =
32) and the LM and hybrid paths' publish shapes (12,288 x 50,280 and x
32,000, k = 8) it prints, as one JSON line, a wrapper call's CUDA-event
median (as chip_smoke.py times it) and the profiler's device time a call
(the mean of 20), and first the CUDA-event median of a one-element fill,
which says how fast this host launches. Run each checkout in a process of
its own, in turns (old, new, new, old). Needs a CUDA card.
"""
from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

SHAPES = {"resnet": (640, 1000, 32, 50), "lm": (12288, 50280, 8, 20),
          "zamba2": (12288, 32000, 8, 20)}  # B, V, k, timed calls


def time_ms(fn, iters: int) -> float:
    """Median of per-call CUDA-event times (ms), after 5 warm-up calls."""
    import torch
    for _ in range(5):
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


def main() -> None:
    root = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import topk_wire as T
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    t = torch.zeros(1, device=dev)
    out = {"checkout": str(root), "fill_ms": time_ms(lambda: t.fill_(1.0),
                                                     200)}
    for name, (B, V, k, iters) in SHAPES.items():
        x = torch.randn(B, V, generator=g, device=dev) * 3
        ms = time_ms(lambda: T.topk_wire_kernel(x, k), iters)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                T.topk_wire_kernel(x, k)
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and "topk_wire" in e.key]
        out[name] = {"ms": ms, "device_us": sum(
            e.self_device_time_total for e in rows) / sum(e.count
                                                          for e in rows)}
        del x
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
