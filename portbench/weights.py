"""Each client's initial weights, made by the benchmark from ``--seed`` on
the device: one generator a client, one draw for every normally
distributed leaf and one for the uniform one, in float32, the dtype they
are trained in. The same function hands them to the program (as its bundle's
init) and, drawn again after the window, to the reference."""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def client_seed(seed: int, client: int) -> int:
    """A 63-bit generator seed from (run seed, client id)."""
    words = np.random.SeedSequence((int(seed), int(client), 0x57E1)
                                   ).generate_state(2, np.uint32)
    return ((int(words[0]) << 32) | int(words[1])) & ((1 << 63) - 1)


def make_weights(leaves: Dict[str, Tuple[int, ...]],
                 init_kind: Callable[[str, Tuple[int, ...]],
                                     Tuple[str, float]],
                 seed: int, client: int, device: torch.device
                 ) -> Dict[str, Tensor]:
    """Float32 weights of ``client``, by leaf."""
    dtype = torch.float32
    gen = torch.Generator(device=device).manual_seed(client_seed(seed, client))
    kinds = {k: init_kind(k, s) for k, s in leaves.items()}
    normal = [k for k in leaves if kinds[k][0] == "normal"]
    uniform = [k for k in leaves if kinds[k][0] == "dt_bias"]
    sizes = [math.prod(leaves[k]) for k in normal]
    z = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
    u = torch.rand(sum(math.prod(leaves[k]) for k in uniform),
                   generator=gen, device=device, dtype=torch.float64)
    out: Dict[str, Tensor] = {}
    for k, part in zip(normal, torch.split(z, sizes)):
        out[k] = part.view(leaves[k]).mul_(kinds[k][1])
    off = 0
    for k in uniform:
        n = math.prod(leaves[k])
        lo, hi = math.log(1e-3), math.log(1e-1)
        dt = torch.exp(u[off:off + n] * (hi - lo) + lo)
        out[k] = (dt + torch.log(-torch.expm1(-dt))).view(leaves[k]).to(dtype)
        off += n
    for k, shape in leaves.items():
        kind = kinds[k][0]
        if kind == "ones":
            out[k] = torch.ones(shape, device=device, dtype=dtype)
        elif kind == "zeros":
            out[k] = torch.zeros(shape, device=device, dtype=dtype)
        elif kind == "log_arange":
            H = shape[-1]
            out[k] = torch.log(torch.arange(1, H + 1, device=device,
                                            dtype=dtype)).expand(shape)\
                .contiguous()
    return {k: out[k] for k in leaves}
