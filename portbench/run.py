#!/usr/bin/env python3
"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, with nothing set beforehand. It measures
``repro_torch`` (``src/repro_torch``) on one CUDA card and prints, as the
last line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device`` and, traced,
``breakdown``; the numbers that decide ``correct`` come last, under
``checks``, and as the last lines of standard error.

Without a card it exits with code 2 and prints no result. The kernels
build into ``build/`` in the checkout (nvcc's libraries in
``build/kernels``, Triton's cache in ``build/triton``), so only a
checkout's first run compiles.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# run as a script, this directory would head sys.path and its modules
# would shadow others of the same name: the package is imported from ROOT
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]


def _environment() -> None:
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch

    from portbench import guard, harness, spec

    bench = spec.benchmark()
    cell = spec.cell(args.workload, bench)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("portbench: the program (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    names = [(m["name"], m["unit"]) for m in bench["per_layer"]
             if args.workload in m.get("workloads",
                                       [w["name"] for w in
                                        bench["workloads"]])]
    result = harness.run(harness.Cell.named(args.workload), args.seed,
                         args.seconds, bool(args.trace),
                         torch.device("cuda", 0), STARTED, names)
    bad = guard.loaded_forbidden()
    if bad:
        print(f"portbench: the run loaded {bad} (JAX or the JAX package)",
              file=sys.stderr)
        return 3
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
