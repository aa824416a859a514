"""Building and loading the port's hand-written Hopper kernels.

Every kernel is built at first use, from the sources under
``kernels/csrc/`` in this checkout, into ``build/`` at the repository root
(listed in ``.gitignore``):

  * CUDA C++ (``csrc/<name>.cu``, a plain C interface): ``nvcc`` for
    ``sm_90a`` into ``build/kernels/lib<name>-<hash>.so``, loaded with
    ctypes. The hash of the source names the library, so an edited source
    is rebuilt and an unchanged one is loaded as it is.
  * Triton (``csrc/<name>_triton.py``): imported from its file only when a
    kernel is launched, since ``triton`` exists only where there is a card.
    Triton's compile cache goes to ``build/triton``.

Nothing here runs when a module is imported. Each kernel wrapper keeps a
`LaunchCounter` that it bumps once per launch, so a run can show that its
main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
TRITON_CACHE = REPO_ROOT / "build" / "triton"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# sources of many fully unrolled kernels, whose optimisation nvcc spreads
# over the host's threads: flash_attention.cu's 18 kernels took 62 s on one
SPLIT_COMPILE = {"flash_attention"}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class LaunchCounter:
    """How many times one kernel was launched; the wrapper adds one at each
    launch and nowhere else."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0

    def bump(self) -> None:
        self.launches += 1

    def reset(self) -> None:
        self.launches = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: CUDA kernels are built on a machine "
                       "with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_cuda(names: Iterable[str]) -> List[Path]:
    """Compile the named ``csrc/<name>.cu`` sources that are not built yet,
    one ``nvcc`` per source, all started together. Raises with the
    compiler's output if one fails; its ``-Xptxas -v`` report lands in
    ``build/kernels/<name>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        split = ["--split-compile=0"] if name in SPLIT_COMPILE else []
        cmd = [_nvcc(), *NVCC_FLAGS, *split, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    built = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_bytes(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n"
                               + log.decode(errors="replace"))
        os.replace(tmp, out)
        built.append(out)
    return built


def cuda_library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_cuda([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


def triton_module(name: str):
    """Import ``csrc/<name>_triton.py`` (which imports triton) from its
    file. Called only by a wrapper that is about to launch on a card."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(TRITON_CACHE))
    mod_name = f"repro_torch_csrc_{name}_triton"
    with _lock:
        mod = sys.modules.get(mod_name)
        if mod is None:
            spec = importlib.util.spec_from_file_location(
                mod_name, CSRC / f"{name}_triton.py")
            mod = importlib.util.module_from_spec(spec)
            sys.modules[mod_name] = mod
            spec.loader.exec_module(mod)
        return mod
