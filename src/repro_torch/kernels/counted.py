"""A kernel call that is counted, not launched.

Two routes of a kernel wrapper go through `KernelCall`: a ``meta`` tensor
(the dry run and the roofline count a step there: outputs of the kernel's
shapes and dtypes, nothing computed) and a CPU tensor while a cost counter
runs (`repro_torch.roofline.op_cost`: the plain version, its backward
by autograd of the plain version run again). Either way the forward and
the backward are one entry each, booked with the kernel's own cost, and
what runs inside is not counted: the step counts as it does on the card,
where the wrapper's autograd Function books the same entries around its
launches. With no counter running a CPU tensor takes the plain version
under autograd, as before.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.roofline import op_cost

Tensor = torch.Tensor
Cost = Tuple[dict, float]


class Call:
    """What `KernelCall` runs for one call: the entries' names and costs,
    and the forward (``fwd(*inputs) -> outputs``) and backward
    (``bwd(inputs, grad_outputs, needs_input_grad) -> grads``) of the
    route."""

    def __init__(self, names: Tuple[str, str], costs: Tuple[Cost, Cost],
                 fwd: Callable, bwd: Callable):
        self.names, self.costs, self.fwd, self.bwd = names, costs, fwd, bwd


class KernelCall(torch.autograd.Function):
    @staticmethod
    def forward(ctx, call: Call, *inputs):
        ctx.call = call
        ctx.save_for_backward(*inputs)
        ctx.set_materialize_grads(False)
        with op_cost.kernel(call.names[0], call.costs[0]):
            return tuple(o.contiguous() for o in call.fwd(*inputs))

    @staticmethod
    def backward(ctx, *grads):
        call = ctx.call
        with op_cost.kernel(call.names[1], call.costs[1]):
            out = tuple(None if g is None else g.contiguous()
                        for g in call.bwd(ctx.saved_tensors, grads,
                                          ctx.needs_input_grad[1:]))
        return (None, *out)


def run(call: Call, *inputs: Tensor) -> Tuple[Tensor, ...]:
    return KernelCall.apply(call, *inputs)


def empty_grads(inputs: Sequence[Tensor], grads, needs: Sequence[bool]
                ) -> Tuple[Optional[Tensor], ...]:
    """The meta route's backward: a gradient of each input's shape."""
    return tuple(x.new_empty(x.shape) if n else None
                 for x, n in zip(inputs, needs))


def plain_grads(plain: Callable) -> Callable:
    """The CPU route's backward: autograd of ``plain`` run again on the
    saved inputs."""

    def bwd(inputs, grads, needs):
        with torch.enable_grad():
            xs = [x.detach().requires_grad_(bool(n))
                  for x, n in zip(inputs, needs)]
            outs = plain(*xs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            pairs = [(o, g) for o, g in zip(outs, grads)
                     if g is not None and o.requires_grad]
            wrt = [x for x, n in zip(xs, needs) if n]
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], wrt, [g for _, g in pairs],
                allow_unused=True, materialize_grads=True) if pairs
                else [torch.zeros_like(x) for x in wrt])
        return tuple(next(got) if n else None for n in needs)

    return bwd


def counting_route(x: Tensor) -> bool:
    """Whether a call on ``x`` is counted rather than launched or run
    plainly: always on meta, and on the CPU while a counter runs."""
    return x.device.type == "meta" or (
        x.device.type == "cpu" and op_cost.active() is not None)
