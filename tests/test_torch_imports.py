"""The port stands alone: importing every module of repro_torch,
chip_smoke.py and examples/port_quickstart.py leaves jax and the JAX
package out of sys.modules, and the kernels' sources (which import
triton) are not imported by any module."""
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(__file__), "..")

PROBE = r"""
import importlib, importlib.util, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for n in names:
    importlib.import_module(n)
for name, path in zip(("chip_smoke", "port_quickstart"), sys.argv[1:]):
    spec = importlib.util.spec_from_file_location(name, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "repro", "triton")
             or m.startswith(("jax.", "repro.", "triton.")))
print(len(names), bad)
"""


def test_port_imports_no_jax_and_no_reference_package():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-c", PROBE, os.path.join(ROOT, "chip_smoke.py"),
         os.path.join(ROOT, "examples", "port_quickstart.py")],
        capture_output=True, text=True, env=env, timeout=120, check=True)
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 62, out.stdout
    assert bad == "[]", bad


def test_chip_smoke_fails_without_a_card():
    """With no CUDA device the script exits non-zero and prints no
    result line."""
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
