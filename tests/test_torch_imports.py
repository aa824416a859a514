"""The port stands alone: importing every module of repro_torch (the
socket transport, the gossip launcher, the MoE FFN, MLA, the training and
serving launchers and their steps, the serving package, every
architecture config, the roofline's counter and the dry run, the mesh
and sharding modules, the expert-parallel MoE and the pod runtime among
them), chip_smoke.py, examples/port_quickstart.py,
examples/port_serve_decode.py and scripts/port_gossip_procs.py leaves jax
and the JAX package out of sys.modules, and the kernels' sources (which
import triton) are not imported by any module."""
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
assert {"repro_torch.comm.socket", "repro_torch.launch",
        "repro_torch.launch.gossip", "repro_torch.models.moe",
        "repro_torch.configs.arctic_480b", "repro_torch.models.mla",
        "repro_torch.configs.deepseek_v3_671b", "repro_torch.launch.steps",
        "repro_torch.launch.train", "repro_torch.configs.whisper_large_v3",
        "repro_torch.configs.llama_3_2_vision_90b",
        "repro_torch.configs.gemma3_27b", "repro_torch.configs.qwen2_5_32b",
        "repro_torch.configs.minitron_4b", "repro_torch.launch.serve",
        "repro_torch.serve", "repro_torch.serve.engine",
        "repro_torch.serve.feedback", "repro_torch.serve.front",
        "repro_torch.serve.request", "repro_torch.serve.router",
        "repro_torch.serve.teacher_cache", "repro_torch.roofline",
        "repro_torch.roofline.analysis", "repro_torch.roofline.op_cost",
        "repro_torch.configs.shapes", "repro_torch.launch.dryrun",
        "repro_torch.kernels.counted", "repro_torch.common.dtypes",
        "repro_torch.common.sharding", "repro_torch.launch.mesh",
        "repro_torch.launch.shardings", "repro_torch.models.moe_a2a",
        "repro_torch.core.mhd_distributed"} <= set(names), names
for name, path in zip(("chip_smoke", "port_quickstart", "port_gossip_procs",
                       "port_serve_decode"), sys.argv[1:]):
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
         os.path.join(ROOT, "examples", "port_quickstart.py"),
         os.path.join(ROOT, "scripts", "port_gossip_procs.py"),
         os.path.join(ROOT, "examples", "port_serve_decode.py")],
        capture_output=True, text=True, env=env, timeout=120, check=True)
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 100, out.stdout
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
