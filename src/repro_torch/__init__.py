"""repro_torch — the PyTorch/CUDA port of the decentralized MHD system.

A second package beside the JAX one, mirroring its layout
(``repro/<sub>/<mod>.py`` → ``repro_torch/<sub>/<mod>.py``). It imports
``torch`` and numpy, never ``jax`` and nothing of ``repro``: the
numpy-only modules it needs are kept as copies of their own.

Entry points run on the GPU: ``device=None`` means ``"cuda"`` and raises
when no card is visible. Pass ``device="cpu"`` explicitly to run on the
CPU (the parity tests do), where every kernel wrapper takes its plain
PyTorch version because the tensor it was given lies on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` → ``cuda``; a CUDA device with no card visible raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the GPU by default and no CUDA device is "
            "visible; pass device='cpu' to run on the CPU explicitly")
    return dev


__all__ = ["resolve_device"]
