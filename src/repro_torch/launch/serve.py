"""Serving launcher — thin CLI over `repro_torch.serve` (port of
``repro/launch/serve.py``).

Two modes:

  * decode demo (default): a continuous-batching greedy-decode run over
    one zoo LM — mixed-length requests admitted and retired without
    draining the batch, each prompt prefilled at admission.

        PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b \\
            --batch 4 --prompt-len 32 --gen 16

    ``--no-reduced`` builds the full published config instead of the
    CPU-reduced one (minitron-4b's 5.76 B f32 params take 23 GB of the
    card).

  * fleet scenario (``--preset``): the full train→snapshot→serve→
    feed-back loop of `repro_torch.serve.run_serve_scenario`:

        PYTHONPATH=src python -m repro_torch.launch.serve --preset serve_loop

Both run on the card unless ``--device cpu`` asks for the CPU; there is no
fallback.
"""
from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np


def _demo(args) -> int:
    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.models.zoo import build_bundle
    from repro_torch.serve import ContinuousBatchingEngine, ServeRequest

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if cfg.family == "audio":
        raise SystemExit("use the whisper example for enc-dec serving")
    device = resolve_device(args.device)
    bundle = build_bundle(cfg)
    # an LM drawn on the device (a CPU generator gives the CPU's draws)
    params = bundle.init(torch.Generator(device=device).manual_seed(
        args.seed))
    rng = np.random.default_rng(args.seed)

    engine = ContinuousBatchingEngine(
        bundle, params, num_slots=args.batch,
        cache_len=args.prompt_len + args.gen, admission=args.admission,
        device=device)
    for rid in range(args.batch * 2):
        # mixed lengths: request i generates between gen/2 and gen tokens
        gen = args.gen - (rid % max(args.gen // 2, 1))
        engine.submit(ServeRequest(
            request_id=rid, kind="generate",
            prompt=rng.integers(0, cfg.vocab_size, size=args.prompt_len,
                                dtype=np.int32),
            max_new_tokens=max(gen, 1)))
    t0 = time.time()
    responses = engine.run()
    wall = time.time() - t0

    total_tokens = sum(len(r.tokens) for r in responses)
    print(f"arch={cfg.name} slots={args.batch} prompt={args.prompt_len} "
          f"admission={engine.admission} device={device}")
    print(f"{len(responses)} requests, {total_tokens} tokens in "
          f"{wall:.2f}s ({total_tokens / max(wall, 1e-9):.1f} tok/s, "
          f"occupancy {engine.occupancy():.0%})")
    print("sample generations (token ids):")
    for r in sorted(responses, key=lambda r: r.request_id)[:2]:
        print(f"  req{r.request_id}: {r.tokens[:12]} "
              f"(admit tick {r.admit_tick}, finish {r.finish_tick})")
    return 0


def _scenario(args) -> int:
    from repro_torch.exp import get_preset
    from repro_torch.serve import run_serve_scenario

    spec = get_preset(args.preset)
    if spec.serve.requests <= 0:
        raise SystemExit(f"preset {args.preset!r} has no serve block "
                         "(serve.requests == 0)")
    workdir = args.workdir or tempfile.mkdtemp(prefix="serve_")
    out = run_serve_scenario(spec, workdir, device=args.device)
    print(f"preset={args.preset} workdir={workdir}")
    for k in sorted(out.metrics):
        print(f"  {k} = {out.metrics[k]:.4g}")
    print(out.front.cache.ledger.format_table())
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="gemma3-12b")
    p.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="CPU-reduced config (--no-reduced = full shape)")
    p.add_argument("--batch", type=int, default=4,
                   help="engine slots (concurrent decode lanes)")
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--admission", default="continuous",
                   choices=("continuous", "static"))
    p.add_argument("--preset", default=None,
                   help="run the fleet serve scenario of this preset "
                        "instead of the decode demo")
    p.add_argument("--workdir", default=None,
                   help="scenario snapshot/artifact dir (default: tmp)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' to run "
                        "on the CPU)")
    args = p.parse_args(argv)

    return _scenario(args) if args.preset else _demo(args)


if __name__ == "__main__":
    raise SystemExit(main())
