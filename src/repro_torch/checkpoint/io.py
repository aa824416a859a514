"""Checkpoint I/O: the reference's path-keyed npz format, weights carried
across from the JAX package, and the per-client checkpoints every fleet
trainer writes (`CheckpointManager`, `save_client_states`).

Parameters in the port are flat dicts ``{"/"-joined path: tensor}`` whose
keys are exactly the reference's `flatten_with_paths` keys (``stem``,
``s0b1/gn2/scale``, ``aux_heads``, ``stage0/layer0/attn/in_proj`` ...), so
a checkpoint written by either package names its leaves the same way.
Layouts differ in one place only: ResNet convolution kernels are HWIO in
JAX and OIHW here. Those leaves are the ones `resnet.CONV_KERNELS` names
(``stem``, ``*/conv1``, ``*/conv2``, ``*/proj``), in a parameter tree or
under an optimizer state's prefix, and the two converters below transpose
exactly those. Every other leaf crosses unchanged, whatever its rank: LM
stage leaves keep their leading repeats axis (a MoE expert weight is
(R, E, D, F)), dense weights stay (in, out) as the port applies them
(``x @ w``), and the causal-conv weight stays (width, channels).
"""
from __future__ import annotations

import os
import re
import shutil
import tempfile
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.common.pytree import flatten_with_paths
from repro_torch.models.resnet import is_conv_kernel

Tensor = torch.Tensor


def params_from_jax(flat: Mapping[str, np.ndarray],
                    device: Optional[Union[str, torch.device]] = None,
                    dtype: torch.dtype = torch.float32) -> Dict[str, Tensor]:
    """A JAX param (or optimizer-state) tree, as the path-keyed dict of
    numpy arrays `repro.checkpoint.io.save_pytree` writes, → the port's
    flat dict of tensors. Conv kernels go HWIO → OIHW."""
    from repro_torch import resolve_device

    dev = resolve_device(device)
    out: Dict[str, Tensor] = {}
    for k, v in flat.items():
        a = np.array(v)
        if is_conv_kernel(k, a.ndim):
            a = a.transpose(3, 2, 0, 1)
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)
    return out


def params_to_jax(params: Mapping[str, Tensor]) -> Dict[str, np.ndarray]:
    """Inverse of `params_from_jax`: OIHW → HWIO, tensors → numpy."""
    out: Dict[str, np.ndarray] = {}
    for k, v in params.items():
        v = v.detach().cpu()
        # numpy has no bfloat16: such leaves cross as float32
        a = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        if is_conv_kernel(k, a.ndim):
            a = a.transpose(2, 3, 1, 0)
        out[k] = np.ascontiguousarray(a)
    return out


def save_pytree(path: str, tree: Any) -> None:
    """Atomic save of a (nested or flat) tree of tensors/arrays to an npz
    file, keyed like the reference's ``save_pytree``. Tensors are written
    in the port's layout; pass them through `params_to_jax` first for a
    file the JAX package loads into its own layout."""
    arrays = {k: (v.detach().cpu().numpy() if isinstance(v, Tensor)
                  else np.asarray(v))
              for k, v in flatten_with_paths(tree).items()}
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_pytree(path: str) -> Dict[str, np.ndarray]:
    """The path-keyed arrays of an npz written by either package."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


# -- step-indexed checkpoints ------------------------------------------------
#
# A `CheckpointManager` file holds its tree in the reference's array layout
# (conv kernels HWIO), so a directory written by either package restores
# into the other. Restores load into a *target* tree — its structure, and
# each leaf's shape, dtype and device — as the reference's `load_pytree`.

_STEP_RE = re.compile(r"^step_(\d+)$")


def _load_into(flat: Mapping[str, np.ndarray], target: Any) -> Any:
    """The arrays of a reference-layout file in ``target``'s structure,
    each leaf converted by `params_from_jax` to the target leaf's dtype
    and device."""
    tgt = flatten_with_paths(target)
    missing, extra = set(tgt) - set(flat), set(flat) - set(tgt)
    if missing or extra:
        raise ValueError(
            f"checkpoint structure mismatch: missing={sorted(missing)[:5]} "
            f"extra={sorted(extra)[:5]}")

    def fill(tree: Any, prefix: str) -> Any:
        if isinstance(tree, Mapping):
            return {k: fill(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(fill(v, f"{prefix}/{i}" if prefix else str(i))
                              for i, v in enumerate(tree))
        out = params_from_jax({prefix: flat[prefix]}, device=tree.device,
                              dtype=tree.dtype)[prefix]
        if out.shape != tree.shape:
            raise ValueError(f"shape mismatch at {prefix}: "
                             f"{tuple(out.shape)} vs {tuple(tree.shape)}")
        return out

    return fill(target, "")


class CheckpointManager:
    """Step-indexed checkpoint directory with retention."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def save(self, step: int, tree: Any) -> str:
        d = self._step_dir(step)
        os.makedirs(d, exist_ok=True)
        save_pytree(os.path.join(d, "state.npz"),
                    params_to_jax(flatten_with_paths(tree)))
        self._gc()
        return d

    def steps(self):
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, target: Any, step: Optional[int] = None) -> Any:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return _load_into(
            load_pytree(os.path.join(self._step_dir(step), "state.npz")),
            target)

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.max_to_keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)


def save_client_states(directory: str, step: int, states,
                       max_to_keep: int = 2, ids=None) -> None:
    """Per-client ``(params, opt_state)`` checkpoints under
    ``directory/client_{i}/step_{step:010d}/state.npz`` (keys ``params/...``
    and ``opt/...``) — the layout every fleet trainer shares, in both
    packages. ``ids`` names the client id of each state (default:
    positional)."""
    states = list(states)
    ids = range(len(states)) if ids is None else list(ids)
    for i, (params, opt) in zip(ids, states):
        mgr = CheckpointManager(os.path.join(directory, f"client_{i}"),
                                max_to_keep=max_to_keep)
        mgr.save(step, {"params": params, "opt": opt})


def restore_client_states(directory: str, states, step: Optional[int] = None,
                          ids=None):
    """Inverse of `save_client_states`: restores into the given
    ``(params, opt_state)`` targets; returns ``(step, new_states)``."""
    restored = 0
    out = []
    states = list(states)
    ids = range(len(states)) if ids is None else list(ids)
    for i, (params, opt) in zip(ids, states):
        mgr = CheckpointManager(os.path.join(directory, f"client_{i}"))
        state = mgr.restore({"params": params, "opt": opt}, step)
        out.append((state["params"], state["opt"]))
        restored = mgr.latest_step() if step is None else step
    return int(restored), out
