#!/usr/bin/env python3
"""Where a decode step's time goes on one card: the host or the device.

    python3 ablations/serve_decode.py

For minitron-4b and mamba2-370m at their published width and depth (f32
params drawn on the card), at 8 rows and at 1 (the engine's tick and its
prefill step), with caches of 96 positions: the eager ``decode_step``'s
host wall a step (10 steps, synchronized at the end); its device time and
launches a step under the profiler, with the kernels that take the most;
the same step as the engine's CUDA graph (`repro_torch.serve.engine.
GraphStep`), replayed; and single products of the rows with the largest
weights, with the rate they read them at. Prints the card's name and power
limit first.
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_bundle  # noqa: E402
from repro_torch.serve.engine import GraphStep  # noqa: E402

CACHE_LEN = 96


def wall_ms(fn, n: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    a = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - a) / n * 1e3


def event_ms(fn, n: int = 20) -> float:
    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


@torch.no_grad()
def run(name: str, B: int) -> None:
    dev = torch.device("cuda", 0)
    cfg = get_config(name)
    bundle = build_bundle(cfg)
    params = bundle.init(torch.Generator(device=dev).manual_seed(0))
    tok = torch.zeros(B, 1, dtype=torch.int32, device=dev)
    state = {"c": bundle.init_cache(B, CACHE_LEN, torch.float32,
                                    device=dev)}

    def eager():
        _, state["c"] = bundle.decode_step(params, tok, state["c"])

    eager = wall_ms(eager)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            _, state["c"] = bundle.decode_step(params, tok, state["c"])
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in rows) / 3e3
    n = sum(e.count for e in rows) / 3
    print(f"{name} B={B}: eager {eager:.2f} ms a step (host wall); device "
          f"{dev_ms:.2f} ms in {n:.0f} launches a step")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"   {e.self_device_time_total / 3e3:8.3f} ms {e.count // 3:5d}x"
              f"  {e.key[:100]}")
    graph = GraphStep(bundle, params, state["c"])
    replay = wall_ms(lambda: graph(params, tok, graph.caches))
    print(f"{name} B={B}: graph replay {replay:.3f} ms a step (host wall)")
    x = torch.randn(B, cfg.d_model, device=dev)
    heads = "embed" if cfg.tie_embeddings else "lm_head"
    for k in (heads, "stage0/layer0/ffn/w_up", "stage0/layer0/ffn/w_down",
              "stage0/layer0/attn/wq", "stage0/layer0/attn/in_proj"):
        if k not in params:
            continue
        w = params[k][0] if k.startswith("stage") else params[k]
        w = w.t() if k == "embed" else w
        xk = x if w.shape[0] == cfg.d_model else torch.randn(
            B, w.shape[0], device=dev)
        ms = event_ms(lambda: xk @ w)
        print(f"   x({B}) @ {k} {tuple(w.shape)}: {ms:.4f} ms, "
              f"{w.numel() * 4 / ms / 1e9:.2f} TB/s")
    del params, state, graph
    torch.cuda.empty_cache()


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("ablations/serve_decode.py runs on a CUDA card only")
    import subprocess

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch in ("minitron-4b", "mamba2-370m"):
        for rows in (8, 1):
            run(arch, rows)
