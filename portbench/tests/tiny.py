"""A cell at a size a CPU test can run: the benchmark's own cell, its
configuration cut to the program's reduced mamba2-370m (2 layers,
d_model 128, vocabulary 512) and its traffic to 2 + 2 sequences of 64
tokens, with the cell's own limits."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import harness, spec  # noqa: E402

CELL = "mamba2-370m.pred-sp4"


def tiny_cell() -> "harness.Cell":
    w = spec.cell(CELL)
    config = spec.config(w["config"])
    config.update({"d_model": 128, "n_layer": 2, "vocab_size": 512,
                   "d_state": 16, "headdim": 64, "chunk_size": 32,
                   "port": {"arch": "mamba2-370m", "preset": "reduced",
                            "overrides": {}}})
    traffic = spec.traffic(w["traffic"])
    traffic["data"].update({"sequences_per_domain": 8, "seq_len": 64})
    traffic["batch"].update({"private": 2, "public": 2,
                             "max_public_positions": 64})
    return harness.Cell(CELL, config, traffic, spec.limits(CELL))
