#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card at the cell's
own size, in one process:

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 [--out build/calibrate.jsonl]

For every seed: set-up as a run makes it (data, weights, trainer, the
warm-up round's checked steps), the program's state freed, then the float64
reference: the numbers of the program against it are the lower readings. For
each control seed also the control (the reference put in the program's
place in float32 with TF32 on, the precision below the configuration's),
the same in float32 with TF32 off (the program's own precision), and the
faults the check must catch, planted in the reference put in the
program's place: half of each batch left out, one published token
altered, the exchange left out. A state left unchanged reads 1 by
construction and needs no run. One JSON line a seed and side.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "calibrate.jsonl"))
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from portbench import check, harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.Cell.named(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as out:
        def emit(row):
            line = json.dumps(row)
            print(line, flush=True)
            out.write(line + "\n")
            out.flush()

        for seed in seeds:
            t0 = time.perf_counter()
            prep = harness.prepare(cell, seed, device, whole_round=False)
            setup = time.perf_counter() - t0
            harness.free(prep, device)
            t1 = time.perf_counter()
            ref = check.run_reference(cell.config, cell.traffic, seed,
                                      prep.data, device)
            emit({"seed": seed, "side": "program", "setup_s": setup,
                  "reference_s": time.perf_counter() - t1,
                  **check.gaps(prep.program, ref),
                  "loss": prep.program.loss, "ref_loss": ref.loss})
            if seed not in control:
                continue
            sides = {"control": dict(dtype=torch.float32, tf32=True),
                     "f32": dict(dtype=torch.float32),
                     "half": dict(fault="half"),
                     "token": dict(fault="token"),
                     "exchange": dict(fault="exchange")}
            for side, kw in sides.items():
                got = check.run_reference(cell.config, cell.traffic, seed,
                                          prep.data, device, **kw)
                emit({"seed": seed, "side": side, **check.gaps(got, ref)})
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
