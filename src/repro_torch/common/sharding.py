"""Logical sharding roles, the active mesh and the partition primitives
(port of ``repro/common/sharding.py``).

The reference's model code calls ``maybe_shard(x, *roles)`` to steer
XLA's partitioner, and its manual regions (the expert-parallel MoE, the
pod step) read the active mesh with ``jax.sharding.get_abstract_mesh()``.
The port has no partitioner: its layouts are explicit, so `maybe_shard`
returns its input. ``with use_mesh(mesh, axes, specs):`` is the port's
counterpart of the reference's ``jax.set_mesh``: those axes of a
``DeviceMesh`` become the active `Partition` — their sizes, this rank's
coordinates, the process group along any tuple of them (`group_of`) and
the spec of every leaf (``launch.shardings.params_shardings``) — and the
model code reads it to run each rank on its own blocks:

  * `gather` — a leaf's block all-gathered along one dim (the FSDP
    gather); the backward reduce-scatters the gradient (``"sum"``: the
    ranks computed on different tokens or on different parts of it) or
    takes this rank's block of it (``"slice"``: they repeated the same
    compute);
  * `tp_enter` / `tp_exit` — the tensor-parallel region's entry (identity
    forward, all-reduce backward) and exit (all-reduce forward, identity
    backward) over 'model';
  * `split_rows` / `gather_rows` — this rank's block of a replicated
    tensor's rows, and its inverse;
  * `vocab_to_rows` — one all-to-all turning a vocabulary-sharded (N,
    V/m) block into whole rows (N/m, V), its backward the inverse.

The strategy follows the reference's ``_apply_sharding_strategy`` (its
dry run's): under ``"tp"`` (the default) the batch splits over ('pod',
'data') and the 'model' axis carries tensor parallelism; under
``"fsdp"`` the batch splits over every axis and every leaf is gathered
whole where it is used. `launch.shardings.apply_sharding_strategy` sets
it through `set_logical_rule` and ``launch.shardings.DEFAULT_ROLES``;
`sharding_strategy` reads it back from the logical rules.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
from typing import (Any, Dict, Iterator, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import torch
import torch.distributed as dist

AxisLike = Union[None, str, Tuple[str, ...]]

# every group the port makes: a rank that raises while its peers wait in a
# collective fails them within a minute instead of hanging them
GROUP_TIMEOUT = datetime.timedelta(seconds=60)

# Logical roles used by model code; launch/shardings.py can override this
# mapping (a §Perf lever — e.g. sequence-sharding long contexts).
_LOGICAL_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "model": "model",
    "expert": "model",
    "fsdp_tokens": ("pod", "data"),  # token/slot dims inside manual regions
    "none": None,
}


def set_logical_rule(role: str, axes: AxisLike) -> None:
    _LOGICAL_RULES[role] = axes


def get_logical_rule(role: str) -> AxisLike:
    return _LOGICAL_RULES.get(role)


def maybe_shard(x: torch.Tensor, *roles: str) -> torch.Tensor:
    """Returns ``x``. The reference constrains dim i of ``x`` to the mesh
    axes of logical role i for XLA's partitioner; the port's layouts are
    explicit: each rank computes on its own block, and the collectives
    that move blocks (`gather`, `tp_enter`, `tp_exit`, `vocab_to_rows`, the
    MoE's all-to-all) are written where the model code needs them."""
    return x


def token_axes(sizes: Mapping[str, int]) -> Tuple[str, ...]:
    """The axes of ``sizes`` that split the batch (the logical 'batch'
    role), of size above 1, in their order."""
    rule = get_logical_rule("batch") or ()
    rule = (rule,) if isinstance(rule, str) else tuple(rule)
    return tuple(a for a in sizes if a in rule and sizes[a] > 1)


def sharding_strategy() -> str:
    """``"fsdp"`` when the logical 'model' role is off (the 'model' axis
    joins data parallelism), else ``"tp"``."""
    return "fsdp" if _LOGICAL_RULES.get("model") is None else "tp"


# ---------------------------------------------------------------------------
# the active mesh
# ---------------------------------------------------------------------------

Spec = Tuple[Any, ...]


@dataclasses.dataclass
class Partition:
    """The active mesh: ``axes`` of ``mesh`` (of ``sizes``), the spec of
    every leaf the ranks hold as blocks (by its name in the bundle's flat
    params; a leaf absent from ``specs`` is whole on every rank), the
    sharding strategy in force when it was made, and ``whole_rows``: the
    code runs on the whole batch on every rank of the token axes (one
    they do not divide, which the reference replicates), not on this
    rank's block of it."""

    mesh: Any
    axes: Tuple[str, ...]
    sizes: Dict[str, int]
    specs: Mapping[str, Spec]
    strategy: str
    whole_rows: bool = False

    @property
    def token_axes(self) -> Tuple[str, ...]:
        return token_axes(self.sizes)

    @property
    def n_token_shards(self) -> int:
        return math.prod(self.sizes[a] for a in self.token_axes)

    @property
    def model(self) -> int:
        return self.sizes.get("model", 1)

    @property
    def tp(self) -> bool:
        """Tensor parallelism over 'model' is on: the ``"tp"`` strategy
        with a 'model' axis above 1, whose ranks share their tokens."""
        return (self.strategy == "tp" and self.model > 1
                and "model" not in self.token_axes)

    def group(self, axes: Sequence[str]):
        return group_of(self.mesh, tuple(axes))

    def index(self, axes: Sequence[str]) -> int:
        return axis_index(self.mesh, tuple(axes))

    def spec(self, name: str, lead: int = 0) -> Spec:
        """The spec of the leaf ``name`` without its first ``lead`` dims
        (a stage's repeats); ``()`` for a whole leaf."""
        spec = self.specs.get(name, ())
        return tuple(spec[lead:]) if spec else ()


_ACTIVE: List[Optional[Partition]] = []


@contextlib.contextmanager
def use_mesh(mesh, axes: Optional[Sequence[str]] = None,
             specs: Optional[Mapping[str, Spec]] = None,
             whole_rows: bool = False) -> Iterator[None]:
    """Make ``axes`` of ``mesh`` (all of them by default) the active mesh
    for the code run inside, the ranks holding the blocks ``specs`` gives
    (None: every leaf whole), on the whole batch if ``whole_rows``
    (`Partition`); ``mesh=None`` makes none active (one device)."""
    if mesh is None:
        part = None
    else:
        names = tuple(mesh.mesh_dim_names)
        axes = names if axes is None else tuple(axes)
        unknown = [a for a in axes if a not in names]
        if unknown:
            raise ValueError(f"axes {unknown} not in the mesh's {names}")
        part = Partition(mesh, axes, mesh_axis_sizes(mesh, axes),
                         dict(specs or {}), sharding_strategy(), whole_rows)
    with _Active(part):
        yield


class _Active:
    """``part`` (a `Partition` or None) active inside; reusable."""

    def __init__(self, part: Optional[Partition]):
        self.part = part

    def __enter__(self):
        _ACTIVE.append(self.part)

    def __exit__(self, *exc):
        _ACTIVE.pop()


def remat_context():
    """``torch.utils.checkpoint``'s ``context_fn``: a rematerialised
    unit's recompute in the backward runs under the partition that was
    active at its forward, whatever is active when the backward runs."""
    return contextlib.nullcontext(), _Active(active_partition())


def active_partition() -> Optional[Partition]:
    """The innermost `use_mesh`'s `Partition`, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def active_mesh():
    """(mesh, axes) of the innermost `use_mesh`, or (None, ())."""
    part = active_partition()
    return (None, ()) if part is None else (part.mesh, part.axes)


def mesh_axis_sizes(mesh=None, axes: Optional[Sequence[str]] = None
                    ) -> Dict[str, int]:
    """{axis: size} of the active mesh (or of ``mesh``'s ``axes``); empty
    when none is active."""
    if mesh is None:
        part = active_partition()
        if part is None:
            return {}
        return dict(part.sizes)
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.mesh.shape))
    return {a: int(sizes[a]) for a in (names if axes is None else axes)}


def axis_index(mesh, axes: Sequence[str]) -> int:
    """This rank's index along ``axes`` of ``mesh``, row-major in the
    order given (the reference's block index over those axes)."""
    sizes = mesh_axis_sizes(mesh)
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + int(mesh.get_local_rank(a))
    return idx


def axis_groups(shape: Sequence[int], dims: Sequence[int]):
    """This rank's process group along the mesh dimensions ``dims`` of a
    ``shape`` mesh over ranks 0…n−1 (its ranks row-major in those
    dimensions): one ``new_group`` for every slice, made by every rank in
    the same order, as the collective ``new_group`` requires; each with
    `GROUP_TIMEOUT`."""
    ids = torch.arange(math.prod(shape)).reshape(tuple(shape))
    rest = [d for d in range(len(shape)) if d not in dims]
    order = ids.permute(*rest, *dims).reshape(
        -1, math.prod(shape[d] for d in dims))
    rank, mine = dist.get_rank(), None
    for ranks in order.tolist():
        g = dist.new_group(ranks, timeout=GROUP_TIMEOUT)
        if rank in ranks:
            mine = g
    return mine


def group_of(mesh, axes: Sequence[str]):
    """The process group of this rank along ``axes`` of ``mesh``: the
    mesh's own group for one axis, else a group made once for the tuple
    (by every rank at its first call, so every rank must ask for the same
    tuples in the same order, as they do running the same step)."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    cache = mesh.__dict__.setdefault("_repro_groups", {})
    if axes not in cache:
        names = tuple(mesh.mesh_dim_names)
        if sorted(names.index(a) for a in axes) != \
                [names.index(a) for a in axes]:
            raise ValueError(f"axes {axes} out of the mesh's order {names}")
        cache[axes] = axis_groups(tuple(mesh.mesh.shape),
                                  [names.index(a) for a in axes])
    return cache[axes]


def spec_axes(spec: Spec) -> set:
    """The mesh axes a spec cuts its leaf along."""
    return {a for e in spec if e is not None
            for a in ((e,) if isinstance(e, str) else e)}


def global_sum_of_squares(grads: Mapping[str, torch.Tensor],
                          part: Partition) -> torch.Tensor:
    """Σ g² over every distinct entry of a gradient that the ranks of
    ``part`` hold as blocks (each leaf's by ``part.specs``, its leading
    dims beyond its spec carried along), each entry counted once: this
    rank's sum of squares of a block weighted by 1 / the number of ranks
    of ``part.axes`` that hold that same block, all-reduced over them. An
    f32 0-d tensor on the device, with no host sync."""
    terms = []
    for k, g in grads.items():
        used = spec_axes(part.specs.get(k, ()))
        holders = math.prod(part.sizes[a] for a in part.axes
                            if a not in used)
        terms.append(g.float().square().sum() / holders)
    total = torch.stack(terms).sum()
    dist.all_reduce(total, group=part.group(part.axes))
    return total


def mean_over_token_shards(grads: Dict[str, torch.Tensor],
                           specs: Mapping[str, Spec], mesh,
                           axes: Sequence[str]) -> None:
    """In place: each gradient made this rank's block of the mean of the
    token shards' gradients over the token ``axes`` of ``mesh`` (the
    sharded steps' objective is that mean). The gathers' backward has
    summed it over the ranks of the axes its spec cuts; it is summed over
    the others and divided by their count. A leaf's leading dims beyond
    its spec (a client stack) are carried along."""
    n = math.prod(mesh_axis_sizes(mesh)[a] for a in axes)
    if n == 1:
        return
    for k, g in grads.items():
        used = spec_axes(specs.get(k, ()))
        rest = tuple(a for a in axes if a not in used)
        if rest:
            dist.all_reduce(g, group=group_of(mesh, rest))
        g.div_(n)


# ---------------------------------------------------------------------------
# the partition primitives (each an autograd.Function over one group)
# ---------------------------------------------------------------------------

def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((n * xs.shape[0], *xs.shape[1:]))
    dist.all_gather_into_tensor(out, xs, group=group)
    return out.movedim(0, dim)


def _block(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    size = x.shape[dim] // n
    return x.narrow(dim, r * size, size)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class AllGather(torch.autograd.Function):
    """x's blocks from every rank of ``group`` concatenated along ``dim``
    in rank order. The backward reduce-scatters the cotangent (``"sum"``:
    sums it over the ranks and gives each its block) or takes this rank's
    block of it (``"slice"``: every rank holds the same cotangent)."""

    @staticmethod
    def forward(ctx, x, group, dim, grad="sum"):
        ctx.group, ctx.dim, ctx.grad = group, dim, grad
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "slice":
            return _block(g, ctx.group, ctx.dim).contiguous(), None, None, \
                None
        n = dist.get_world_size(ctx.group)
        gs = g.movedim(ctx.dim, 0).contiguous()
        out = gs.new_empty((gs.shape[0] // n, *gs.shape[1:]))
        dist.reduce_scatter_tensor(out, gs, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Exit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SplitRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _block(x, group, 0).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, 0), None


def row_blocks(n: int, m: int) -> List[int]:
    """The row counts of ``n`` rows cut into ``m`` blocks in order, the
    first ``n mod m`` one row longer."""
    return [n // m + (1 if r < n % m else 0) for r in range(m)]


def _swap(x: torch.Tensor, group, sizes: List[int],
          to_rows: bool) -> torch.Tensor:
    m, r = len(sizes), dist.get_rank(group)
    if to_rows:  # (N, ..., V/m) -> (sizes[r], ..., V)
        x = x.contiguous()
        out = x.new_empty((m * sizes[r], *x.shape[1:]))
        dist.all_to_all_single(out, x, output_split_sizes=[sizes[r]] * m,
                               input_split_sizes=sizes, group=group)
        out = out.reshape(m, sizes[r], *x.shape[1:])
        return out.movedim(0, -2).flatten(-2)
    # (sizes[r], ..., V) -> (N, ..., V/m)
    parts = x.unflatten(-1, (m, x.shape[-1] // m)).movedim(-2, 0)
    parts = parts.reshape(m * x.shape[0], *x.shape[1:-1],
                          x.shape[-1] // m).contiguous()
    out = parts.new_empty((sum(sizes), *parts.shape[1:]))
    dist.all_to_all_single(out, parts, output_split_sizes=sizes,
                           input_split_sizes=[x.shape[0]] * m, group=group)
    return out


class _VocabToRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, sizes):
        ctx.group, ctx.sizes = group, sizes
        return _swap(x, group, sizes, True)

    @staticmethod
    def backward(ctx, g):
        return _swap(g, ctx.group, ctx.sizes, False), None, None


def gather(x: torch.Tensor, axes: Sequence[str], dim: int,
           grad: str = "sum", part: Optional[Partition] = None
           ) -> torch.Tensor:
    """``x``'s blocks along ``dim`` over the mesh ``axes`` (row-major,
    as `launch.shardings.shard_leaf` cuts them) put together; the
    backward as `AllGather`'s ``grad``. The identity where the axes have
    one rank."""
    part = part or active_partition()
    axes = tuple(a for a in axes if part.sizes[a] > 1)
    if not axes:
        return x
    return AllGather.apply(x, part.group(axes), dim, grad)


def _model_group(part: Optional[Partition]):
    part = part or active_partition()
    return part.group(("model",))


def tp_enter(x: torch.Tensor, part: Optional[Partition] = None
             ) -> torch.Tensor:
    """The tensor-parallel region's entry over 'model': ``x`` forward,
    its cotangent all-reduced backward (each rank's part of the region
    contributed its share of it)."""
    return _Enter.apply(x, _model_group(part))


def tp_exit(x: torch.Tensor, part: Optional[Partition] = None
            ) -> torch.Tensor:
    """The region's exit: the partial sums all-reduced over 'model'
    forward, the cotangent passed through backward."""
    return _Exit.apply(x, _model_group(part))


def split_rows(x: torch.Tensor, part: Optional[Partition] = None
               ) -> torch.Tensor:
    """This 'model' rank's block of ``x``'s rows (dim 0), from a tensor
    every model rank holds whole; the backward all-gathers the blocks'
    cotangents."""
    return _SplitRows.apply(x, _model_group(part))


def gather_rows(x: torch.Tensor, part: Optional[Partition] = None
                ) -> torch.Tensor:
    """Every 'model' rank's block of rows, in rank order (the inverse of
    `split_rows`); the backward takes this rank's block."""
    return AllGather.apply(x, _model_group(part), 0, "slice")


def row_block(n: int, part: Optional[Partition] = None) -> slice:
    """This 'model' rank's block of ``n`` rows (`row_blocks`)."""
    part = part or active_partition()
    sizes, r = row_blocks(n, part.model), part.index(("model",))
    return slice(sum(sizes[:r]), sum(sizes[:r + 1]))


def vocab_to_rows(x: torch.Tensor, part: Optional[Partition] = None
                  ) -> torch.Tensor:
    """(N, …, V/m) blocks of the vocabulary on the m 'model' ranks → this
    rank's `row_block` of the N rows, whole (…, V). One all-to-all; its
    backward the inverse one."""
    part = part or active_partition()
    return _VocabToRows.apply(x, _model_group(part),
                              row_blocks(x.shape[0], part.model))


def all_reduce_max(x: torch.Tensor, part: Optional[Partition] = None
                   ) -> torch.Tensor:
    """The elementwise maximum over 'model' of a constant ``x``."""
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=_model_group(part))
    return out
