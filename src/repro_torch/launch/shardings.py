"""Parameter / optimizer-state / batch / cache sharding rules (port of
``repro/launch/shardings.py``), as pure functions over the port's flat
names.

Strategy (as the reference's): tensor-parallel over 'model' (heads, d_ff,
experts, vocab) + FSDP over 'data' (the other matmul dim), replicated over
'pod'. Every rule is divisibility-checked against the mesh and falls back
to replication per dim, so the same rules serve the full configs on the
256/512-chip meshes and reduced configs on small test meshes.

A spec is a tuple with one entry per dimension: None (replicated), an
axis name, or a tuple of names (the dim split over their product,
row-major) — the reference's ``PartitionSpec`` as a tuple; ``()`` is the
reference's ``P()``, replicated. A mesh is a ``DeviceMesh``, a mapping
``{axis: size}``, or any object with ``axis_names`` and ``devices.shape``
or ``axis_sizes`` (an abstract mesh, as the reference's tests fake one).

`shard_leaf` cuts a leaf into one rank's block by its spec,
`shard_params` every leaf of a flat dict by `partition_specs`, and
`unshard_leaf` puts the blocks back together. A rank of a sharded step
holds exactly these blocks, and runs with them under
``common.sharding.use_mesh(mesh, axes, specs)``.
`apply_sharding_strategy` is the reference's ``_apply_sharding_strategy``
(``"tp"`` | ``"fsdp"``).
"""
from __future__ import annotations

import itertools
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

Spec = Tuple[Any, ...]

# role -> mesh axis name(s); "fsdp" may be retargeted (a §Perf lever)
DEFAULT_ROLES = {
    "fsdp": "data",
    "tp": "model",
    "batch": ("pod", "data"),
}

# (leaf name, base ndim) -> role template. None entries replicate.
_RULES: Dict[Tuple[str, int], Tuple[Optional[str], ...]] = {
    ("embed", 2): ("tp", "fsdp"),
    ("lm_head", 2): ("fsdp", "tp"),
    ("aux_heads", 3): (None, "fsdp", "tp"),
    ("wq", 2): ("fsdp", "tp"),
    ("wk", 2): ("fsdp", "tp"),
    ("wv", 2): ("fsdp", "tp"),
    ("wo", 2): ("tp", "fsdp"),
    ("bq", 1): ("tp",),
    ("bk", 1): ("tp",),
    ("bv", 1): ("tp",),
    ("w_up", 2): ("fsdp", "tp"),
    ("w_gate", 2): ("fsdp", "tp"),
    ("w_down", 2): ("tp", "fsdp"),
    ("router", 2): (None, None),  # tiny; replicated for the manual-EP path
    ("w_up", 3): ("tp", "fsdp", None),
    ("w_gate", 3): ("tp", "fsdp", None),
    ("w_down", 3): ("tp", None, "fsdp"),
    ("in_proj", 2): ("fsdp", "tp"),
    ("out_proj", 2): ("tp", "fsdp"),
    ("w_dq", 2): ("fsdp", "tp"),
    ("w_uq", 2): ("fsdp", "tp"),
    ("w_dkv", 2): ("fsdp", "tp"),
    ("w_uk", 3): ("fsdp", "tp", None),
    ("w_uv", 3): ("fsdp", "tp", None),
    ("vision_proj", 2): ("fsdp", "tp"),
    ("audio_proj", 2): ("fsdp", "tp"),
    ("pos_embed", 2): (None, "tp"),
    ("proj", 2): ("fsdp", "tp"),
}


def apply_sharding_strategy(strategy: str) -> None:
    """How the 'model' axis is used (the reference's dry-run lever).

    * ``"tp"`` (default): tensor parallelism over 'model' + FSDP over
      'data'; the batch splits over ('pod', 'data');
    * ``"fsdp"``: 'model' joins data parallelism — the batch splits over
      every axis, the parameters stay cut over both and are gathered
      whole where they are used."""
    from repro_torch.common.sharding import set_logical_rule

    if strategy == "fsdp":
        set_logical_rule("batch", ("pod", "data", "model"))
        set_logical_rule("model", None)
        set_logical_rule("expert", "model")
        DEFAULT_ROLES["batch"] = ("pod", "data", "model")
        DEFAULT_ROLES["tp"] = ("model",)  # params still sharded over both
    elif strategy == "tp":
        set_logical_rule("batch", ("pod", "data"))
        set_logical_rule("model", "model")
        set_logical_rule("expert", "model")
        DEFAULT_ROLES["batch"] = ("pod", "data")
        DEFAULT_ROLES["tp"] = "model"
    else:
        raise ValueError(strategy)


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis: size} of a DeviceMesh, a mapping or an abstract mesh."""
    if isinstance(mesh, Mapping):
        return {k: int(v) for k, v in mesh.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.mesh.shape)))
    devices = getattr(mesh, "devices", None)
    if devices is not None and hasattr(devices, "shape"):
        return dict(zip(mesh.axis_names, devices.shape))
    return dict(zip(mesh.axis_names, mesh.axis_sizes))


def _resolve(axis_role: Optional[str], dim: int, sizes: Dict[str, int],
             roles) -> Any:
    if axis_role is None:
        return None
    axes = roles[axis_role]
    if isinstance(axes, str):
        axes = (axes,)
    kept = tuple(a for a in axes if a in sizes)
    size = math.prod(sizes[a] for a in kept) if kept else 1
    if not kept or size <= 1 or dim % size != 0:
        return None
    return kept if len(kept) > 1 else kept[0]


def param_pspec(name: str, shape: Sequence[int], mesh,
                roles=None) -> Spec:
    """The spec of the leaf ``name`` ("/"-joined path) of ``shape``."""
    roles = roles or DEFAULT_ROLES
    sizes = mesh_sizes(mesh)
    names = name.split("/")
    leaf_name = names[-1]
    ndim = len(shape)
    # conv params are nested under a "conv" dict with generic w/b leaves
    if len(names) >= 2 and names[-2] == "conv":
        tmpl = (None, "tp") if leaf_name == "w" else ("tp",)
    else:
        stacked_guess = any(n.startswith("stage") for n in names[:-1])
        base_ndim = ndim - 1 if stacked_guess else ndim
        tmpl = _RULES.get((leaf_name, base_ndim))
        if tmpl is None:
            return ()  # replicate (norm scales, biases, scalars, resnet, ...)
    full = (None,) * (ndim - len(tmpl)) + tuple(tmpl)
    return tuple(_resolve(r, shape[i], sizes, roles)
                 for i, r in enumerate(full))


def params_shardings(params: Mapping[str, Any], mesh, roles=None
                     ) -> Dict[str, Spec]:
    """{name: spec} of a flat params (or optimizer-state) dict of tensors
    (meta ones included) or shapes."""
    return {k: param_pspec(k, tuple(v.shape), mesh, roles)
            for k, v in params.items()}


def _batch_axes(sizes: Dict[str, int], batch_dim: int) -> Any:
    axes = DEFAULT_ROLES["batch"]
    if isinstance(axes, str):
        axes = (axes,)
    axes = tuple(a for a in axes if a in sizes)
    total = math.prod(sizes[a] for a in axes) if axes else 1
    if axes and total > 1 and batch_dim % total == 0:
        return axes if len(axes) > 1 else axes[0]
    return None


def batch_shardings(batch: Mapping[str, Any], mesh) -> Dict[str, Spec]:
    """tokens/images: batch dim over (pod, data); rest replicated."""
    sizes = mesh_sizes(mesh)
    out = {}
    for k, v in batch.items():
        nd = len(v.shape)
        out[k] = () if not nd else (
            _batch_axes(sizes, v.shape[0]),) + (None,) * (nd - 1)
    return out


def cache_shardings(cache: Mapping[str, Any], mesh) -> Dict[str, Spec]:
    """Decode caches: batch over (pod,data) when divisible, else sequence
    over 'data' (the long_500k batch=1 case); kv-heads / latent dims over
    'model' when divisible. Stacked leading (repeats) dim replicated. The
    port's ``index`` leaves (a position a row) replicate, as the
    reference's scalar does."""
    sizes = mesh_sizes(mesh)
    model = sizes.get("model", 1)
    out: Dict[str, Spec] = {}
    for key, leaf in cache.items():
        shape = tuple(leaf.shape)
        names = key.split("/")
        name, nd = names[-1], len(shape)
        if name == "index" or nd <= 1:
            out[key] = ()
            continue
        off = 1 if any(n.startswith("stage") for n in names[:-1]) else 0
        dims: list = [None] * nd
        b_axes = _batch_axes(sizes, shape[off])
        dims[off] = b_axes
        seq_on_data = (b_axes is None and "data" in sizes
                       and shape[min(off + 1, nd - 1)] % sizes["data"] == 0)
        if name in ("k", "v") and nd - off == 4:
            # (B, S, KV, hd): S on data when the batch isn't; KV on model
            if seq_on_data:
                dims[off + 1] = "data"
            if shape[off + 2] % model == 0 and model > 1:
                dims[off + 2] = "model"
        elif name in ("c_kv", "k_rope") and nd - off == 3:
            # (B, S, R): S on data when the batch isn't; latent on model
            if seq_on_data:
                dims[off + 1] = "data"
            if shape[off + 2] % model == 0 and model > 1:
                dims[off + 2] = "model"
        elif name == "ssm" and nd - off == 4:
            # (B, H, P, N): heads on model
            if shape[off + 1] % model == 0 and model > 1:
                dims[off + 1] = "model"
        elif name == "conv" and nd - off == 3:
            # (B, W, C): channels on model
            if shape[off + 2] % model == 0 and model > 1:
                dims[off + 2] = "model"
        out[key] = tuple(dims)
    return out


# ---------------------------------------------------------------------------
# a leaf's blocks
# ---------------------------------------------------------------------------

def _dim_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_leaf(x: torch.Tensor, spec: Spec, sizes: Mapping[str, int],
               coords: Mapping[str, int]) -> torch.Tensor:
    """The block of ``x`` the rank at ``coords`` ({axis: index}) holds
    under ``spec`` on a mesh of ``sizes``: each sharded dim cut into the
    product of its axes' sizes, the rank's block at its row-major index
    over them. A view of ``x``."""
    for d, entry in enumerate(spec):
        axes = _dim_axes(entry)
        if not axes:
            continue
        n = math.prod(sizes[a] for a in axes)
        idx = 0
        for a in axes:
            idx = idx * sizes[a] + coords[a]
        size = x.shape[d] // n
        x = x.narrow(d, idx * size, size)
    return x


def unshard_leaf(blocks: Mapping[Tuple[int, ...], torch.Tensor],
                 spec: Spec, sizes: Mapping[str, int],
                 axes: Sequence[str]) -> torch.Tensor:
    """The leaf from its blocks, keyed by each rank's coordinates over
    ``axes`` (a tuple of indices in that order); ranks that hold the same
    block (an axis the spec does not use) give it once."""
    sizes = {a: sizes[a] for a in axes}
    used = [a for e in spec for a in _dim_axes(e)]
    # concatenate along the last sharded dim first, then outwards
    grid = {}
    for key, blk in blocks.items():
        c = dict(zip(axes, key))
        grid[tuple(c[a] for a in used)] = blk
    for d in reversed(range(len(spec))):
        dim_axes = _dim_axes(spec[d])
        if not dim_axes:
            continue
        k = len(used) - len(dim_axes)
        merged = {}
        for head in itertools.product(*(range(sizes[a])
                                         for a in used[:k])):
            parts = [grid[head + tail] for tail in itertools.product(
                *(range(sizes[a]) for a in dim_axes))]
            merged[head] = torch.cat(parts, dim=d)
        grid, used = merged, used[:k]
    return grid[()]


# ---------------------------------------------------------------------------
# a rank's blocks of a flat params dict
# ---------------------------------------------------------------------------

_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def partition_specs(params: Mapping[str, Any], mesh, roles=None
                    ) -> Dict[str, Spec]:
    """{name: spec} of the leaves the rules cut on ``mesh`` (a spec with
    at least one sharded dim); every other leaf is whole on every
    rank."""
    return {k: v for k, v in params_shardings(params, mesh, roles).items()
            if any(e is not None for e in v)}


def expert_specs(params: Mapping[str, Any], cfg, mesh) -> Dict[str, Spec]:
    """The expert weights' part of `partition_specs` for a
    ``moe_impl="a2a"`` config (``w_gate``/``w_up``/``w_down`` with three
    base dims: E over 'model', D over the data axes, each where it
    divides), {} for any other."""
    if getattr(cfg, "moe_impl", "scatter") != "a2a":
        return {}
    out = {}
    for k, spec in partition_specs(params, mesh).items():
        names = k.split("/")
        stacked = any(n.startswith("stage") for n in names[:-1])
        if names[-1] in _EXPERT_LEAVES and \
                len(spec) - int(stacked) == 3:
            out[k] = spec
    return out


def shard_params(params: Mapping[str, torch.Tensor],
                 specs: Mapping[str, Spec], sizes: Mapping[str, int],
                 coords: Mapping[str, int], lead: int = 0
                 ) -> Dict[str, torch.Tensor]:
    """``params`` with each leaf of ``specs`` (`partition_specs` for all
    of them) cut to this rank's block (contiguous copies); ``lead``
    leading dims (a client stack) are kept whole."""
    out = {}
    for k, v in params.items():
        if k in specs:
            v = shard_leaf(v, (None,) * lead + tuple(specs[k]), sizes,
                           coords).contiguous()
        out[k] = v
    return out


def block_shape(shape: Sequence[int], spec: Spec,
                sizes: Mapping[str, int]) -> Tuple[int, ...]:
    """The shape of one rank's block of a leaf of ``shape``."""
    return tuple(n // math.prod(sizes[a] for a in _dim_axes(e))
                 for n, e in zip(shape, tuple(spec) + (None,) * (
                     len(shape) - len(spec))))
