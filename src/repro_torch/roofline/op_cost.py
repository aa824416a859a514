"""Counting a step's FLOPs, bytes and memory (the port's counterpart of
``repro/roofline/hlo_cost.py`` and ``repro/roofline/hlo_parse.py``, which
price a compiled XLA program from its HLO text; the port has no HLO, so it
counts the operations a step issues).

`OpCounter` is a ``TorchDispatchMode``: every aten operation a step runs
passes through it, on any device. Run on the ``meta`` device it needs no
card and allocates nothing, so a full-size step is counted on the CPU; run
on the card or the CPU it counts the same step the same way.

  * FLOPs: every matrix product and convolution, by
    ``torch.utils.flop_counter``'s per-op formulas, kept by the operands'
    type: ``f32`` (cuBLAS and cuDNN with TF32 off, as the port runs) and
    ``bf16`` (bf16 or f16 operands). The hand kernels book their own FLOPs
    (below); those on 3×TF32 ``mma.sync`` under ``tf32x3``, counted as the
    f32 operations they stand for. The compute term of a roofline is then
    Σ flops_type / peak_type (`analysis.HardwareSpec.peaks`).
  * Bytes: each operation reads every tensor it is given and writes every
    tensor it returns, once: the traffic between eager operations, the
    counterpart of XLA's traffic between fusions. Views and metadata
    operations move nothing (the reference's ``_NO_TRAFFIC_OPS``); a
    broadcast (stride-0) dimension counts its elements once; a gather
    (indexing, ``embedding``) moves the elements it selects and an
    in-place scatter three times its updates (the reference's gather and
    scatter rules), each plus its indices.
  * Kernels: a hand kernel's forward or backward is one entry (`kernel`),
    with the FLOPs and bytes of the kernel's own ``cost``; the operations
    inside its wrapper, or inside the plain version that stands for it on
    the CPU, are not counted. So a step counts the same on the CPU, on
    meta and on the card.
  * Memory: the peak of the storages the step makes and still holds (each
    tracked until a weakref finalizer sees it freed): the counterpart of
    ``compiled.memory_analysis()``'s ``temp_size_in_bytes``. What the step
    is given (params, optimizer state, batch) is its argument bytes.
  * Collectives: ``torch.distributed`` operations, by kind, as the bytes
    of their operands (what a rank sends; the reference's rule); under
    `collective_kind` as the kind it names.

``to_dict()`` gives the reference's ``analyze_to_dict`` keys (``flops``,
``bytes``, ``collective_total``, ``collective_<kind>``) with the typed
FLOPs beside them (``flops_f32``, ``flops_tf32x3``, ``flops_bf16``).
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

FLOP_TYPES = ("f32", "tf32x3", "bf16")

aten = torch.ops.aten

# operations that move no data: views, aliases, metadata and allocations
# whose contents are undefined
_NO_TRAFFIC = {
    aten.detach, aten.alias, aten.lift_fresh, aten._unsafe_view,
    aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
    aten.new_empty_strided, aten.set_, aten.resize_,
}

# operations that read only the elements they select (the reference's
# gather / dynamic-slice rule: the selected elements, read and written)
_GATHERS = {aten.index, aten.index_select, aten.gather, aten.embedding}
# in-place scatters: the updated region read and written and the updates
# read (the reference's scatter rule, 3× the updates), plus the indices
_SCATTERS = {aten.index_put_, aten.index_add_, aten.scatter_,
             aten.scatter_add_, aten.scatter_reduce_, aten.index_copy_,
             aten._index_put_impl_}

# torch.distributed operations -> the reference's collective kinds
_COLLECTIVES = {
    "allreduce_": "all-reduce", "all_reduce": "all-reduce",
    "allgather_": "all-gather", "all_gather_into_tensor": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_":
    "reduce-scatter", "reduce_scatter_tensor": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast_": "broadcast",
}

# c10d operations whose first argument is their output: the reference
# books a collective's operand bytes, here the second argument's
_OUTPUT_FIRST = {"alltoall_base_", "alltoall_", "_allgather_base_",
                 "allgather_", "allgather_into_tensor_coalesced_",
                 "allgather_coalesced_", "_reduce_scatter_base_",
                 "reduce_scatter_", "reduce_scatter_tensor_coalesced_"}

_ACTIVE: List["OpCounter"] = []
_KIND: List[str] = []


def tensor_bytes(t: Any) -> int:
    """Bytes of a tensor's distinct elements: a stride-0 (broadcast)
    dimension counts once."""
    if not isinstance(t, torch.Tensor):
        return 0
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if size == 0:
            return 0
        if stride != 0:
            n *= size
    return n * t.element_size()


def flop_type(dtype: torch.dtype) -> str:
    return "bf16" if dtype in (torch.bfloat16, torch.float16) else "f32"


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


class OpCounter(TorchDispatchMode):
    """Counts the operations run under it (``with OpCounter() as c:``)."""

    def __init__(self, args=None):
        super().__init__()
        self.flops: Dict[str, float] = {k: 0.0 for k in FLOP_TYPES}
        self.bytes = 0.0
        self.coll: Dict[str, float] = {}
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._muted = 0
        self._seen = WeakIdKeyDictionary()
        for t in _tensors(args):  # what the step is given: not its memory
            self._seen[t.untyped_storage()] = 0

    # -- the mode -----------------------------------------------------------

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._muted:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        self.ops += 1
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        self._note_storages(ins + outs)
        packet = func._overloadpacket
        ns = packet._qualified_op_name.split("::")[0]
        if ns in ("c10d", "_c10d_functional"):
            name = packet.__name__
            kind = _KIND[-1] if _KIND else _COLLECTIVES.get(name, name)
            operands = args[1] if name in _OUTPUT_FIRST else args[0]
            self.coll[kind] = self.coll.get(kind, 0.0) + sum(
                tensor_bytes(t) for t in _tensors(operands))
            return
        if packet in flop_registry:
            kind = flop_type(ins[0].dtype) if ins else "f32"
            self.flops[kind] += float(flop_registry[packet](
                *args, **kwargs, out_val=out))
        if func.is_view or packet in _NO_TRAFFIC:
            return
        if packet in _GATHERS:
            self.bytes += 2 * sum(tensor_bytes(t) for t in outs) + sum(
                tensor_bytes(t) for t in ins[1:])
        elif packet in _SCATTERS and len(ins) > 1:
            self.bytes += 3 * tensor_bytes(ins[-1]) + sum(
                tensor_bytes(t) for t in ins[1:-1])
        else:
            self.bytes += sum(tensor_bytes(t) for t in ins) + sum(
                tensor_bytes(t) for t in outs)

    # -- memory ---------------------------------------------------------------

    def _note_storages(self, tensors) -> None:
        """Track each storage the first time an operation counted here
        reads or writes it, unless the step was given it (``args``): one
        made inside a kernel's region is seen when the step next uses
        it."""
        for t in tensors:
            st = t.untyped_storage()
            if st in self._seen:
                continue
            nbytes = st.nbytes()
            self._seen[st] = nbytes
            if nbytes:
                self.live_bytes += nbytes
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
                weakref.finalize(st, self._free, nbytes)

    def _free(self, nbytes: int) -> None:
        self.live_bytes -= nbytes

    # -- kernels --------------------------------------------------------------

    def book(self, name: str, flops: Dict[str, float], nbytes: float) -> None:
        row = self.kernels.setdefault(
            name, {"calls": 0.0, "flops": 0.0, "bytes": 0.0})
        row["calls"] += 1
        row["flops"] += sum(flops.values())
        row["bytes"] += nbytes
        for kind, f in flops.items():
            self.flops[kind] += float(f)
        self.bytes += float(nbytes)

    # -- results --------------------------------------------------------------

    @property
    def total_flops(self) -> float:
        return sum(self.flops.values())

    def to_dict(self) -> Dict[str, float]:
        out = {"flops": self.total_flops, "bytes": self.bytes,
               "collective_total": sum(self.coll.values())}
        for k, v in self.coll.items():
            out[f"collective_{k}"] = v
        for k, v in self.flops.items():
            out[f"flops_{k}"] = v
        return out


def active() -> Optional[OpCounter]:
    """The innermost counter running, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def kernel(name: str, cost: Tuple[Dict[str, float], float]) -> Iterator[None]:
    """One call of a hand kernel (its forward or its backward): books
    ``cost`` = (FLOPs by type, bytes) with the running counter and counts
    nothing of what runs inside. A no-op when nothing is counting. The
    counter is global, not per thread: a CUDA backward runs on autograd's
    device thread while the caller waits."""
    c = active()
    if c is None:
        yield
        return
    c.book(name, *cost)
    c._muted += 1
    try:
        yield
    finally:
        c._muted -= 1


@contextlib.contextmanager
def collective_kind(kind: str) -> Iterator[None]:
    """Book every collective run inside as ``kind`` (the ring exchange's
    ``all_to_all_single`` as the reference's ``collective-permute``)."""
    _KIND.append(kind)
    try:
        yield
    finally:
        _KIND.pop()


def count(fn, *args, **kwargs) -> Tuple[Any, OpCounter]:
    """(fn(*args, **kwargs), the counter it ran under); the arguments'
    storages are not the step's memory."""
    with OpCounter(args=(args, kwargs)) as c:
        out = fn(*args, **kwargs)
    return out, c


def tree_bytes(tree) -> int:
    """Bytes of every distinct storage in a tree of tensors (the argument
    bytes of a step: params, optimizer state, batch)."""
    seen = WeakIdKeyDictionary()
    total = 0
    for t in _tensors(tree):
        st = t.untyped_storage()
        if st not in seen:
            seen[st] = True
            total += st.nbytes()
    return total


__all__ = ["FLOP_TYPES", "OpCounter", "active", "collective_kind", "count",
           "flop_type",
           "kernel", "tensor_bytes", "tree_bytes"]
