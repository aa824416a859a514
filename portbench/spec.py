"""Finding a cell's files by name. ``BENCHMARK.json`` names each cell's
configuration and traffic; everything else lives in a file of its own:

  configs/<config>.json     the configuration as it is run
  traffic/<traffic>.json    the traffic mix's parameters
  limits/<cell>.json        the limits of the numbers that decide correct
  metrics/<metric>.py       a per-layer metric's reader (``read(r)``);
                            ``<kernel>_roofline`` without a file of its
                            own is metrics/roofline.py's read(r, kernel)
  costs/<kernel>.py         a kernel's algorithm counts
  reference/<module>.py     a configuration's plain reference (its
                            ``"reference"`` key)

and the parts a traffic file names by key:

  data/<kind>.py                 "data": {"kind": ...}: ``make(traffic,
                                 seed)``, the cell's data
  clients/<task>.py              "task": the program's client bundle
  reference/task_<task>.py       "task": the client's outputs and
                                 objective, plain
  reference/wire_<exchange>.py   "exchange": what a student holds of a
                                 teacher, plain, and the program's side
  reference/optim_<name>.py      "optimizer": {"name": ...}: the update,
                                 plain, and the program's first gradient

so a later cell, configuration, traffic mix or metric is added as files
alone."""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PART = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def check_name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"bad name {name!r}: letters, digits, _ . - only, "
                         "at most 64, not starting with . or -")
    return name


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(name: str, bench: Optional[dict] = None) -> dict:
    bench = benchmark() if bench is None else bench
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{check_name(name)}.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{check_name(name)}.json")


def limits(cell_name: str) -> Dict[str, float]:
    """{number: limit} of a cell."""
    spec = load_json(HERE / "limits" / f"{check_name(cell_name)}.json")
    return {k: float(v["limit"]) for k, v in spec["numbers"].items()}


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str) -> Callable:
    """``read(r)`` for a per-layer metric, found by its name."""
    check_name(name)
    own = HERE / "metrics" / f"{name}.py"
    if own.exists():
        return _module(own, f"portbench_metric_{name}").read
    if not name.endswith("_roofline"):
        raise KeyError(f"no reader metrics/{name}.py")
    mod = _module(HERE / "metrics" / "roofline.py", "portbench_metric_roofline")
    kernel = name[: -len("_roofline")]
    return lambda r: mod.read(r, kernel)


def part(kind: str, name: str) -> ModuleType:
    """The module ``portbench/<kind>/<name>.py`` a traffic key names."""
    if not PART.match(name):
        raise ValueError(f"bad part name {name!r}: letters, digits and _")
    return importlib.import_module(f"portbench.{kind}.{name}")


def parts(traffic: dict) -> Dict[str, ModuleType]:
    """The reference's parts of a traffic mix: task, wire, optimizer."""
    return {"task": part("reference", "task_" + traffic["task"]),
            "wire": part("reference", "wire_" + traffic["exchange"]),
            "optim": part("reference",
                          "optim_" + traffic["optimizer"]["name"])}


def kernel_costs(kernel: str) -> ModuleType:
    return _module(HERE / "costs" / f"{check_name(kernel)}.py",
                   f"portbench_costs_{kernel}")


def kernels_with_costs():
    return sorted(p.stem for p in (HERE / "costs").glob("*.py")
                  if not p.stem.startswith("_"))
