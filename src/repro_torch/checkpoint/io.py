"""Checkpoint I/O: the reference's path-keyed npz format, and weights
carried across from the JAX package.

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
import tempfile
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.models.resnet import is_conv_kernel

Tensor = torch.Tensor


def flatten_with_paths(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts (and lists/tuples) → ``{"/"-joined path: leaf}``, with
    dict keys sorted as `jax.tree_util` orders them."""
    out: Dict[str, Any] = {}
    if isinstance(tree, Mapping):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return {prefix: tree}
    for k, v in items:
        key = f"{prefix}/{k}" if prefix else str(k)
        out.update(flatten_with_paths(v, key))
    return out


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
        a = v.detach().cpu().numpy()
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
