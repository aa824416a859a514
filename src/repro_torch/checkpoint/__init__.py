from repro_torch.checkpoint.io import (
    flatten_with_paths,
    load_pytree,
    params_from_jax,
    params_to_jax,
    save_pytree,
)
from repro_torch.checkpoint.pool import CheckpointPool, PoolEntry

__all__ = [
    "CheckpointPool",
    "PoolEntry",
    "flatten_with_paths",
    "load_pytree",
    "params_from_jax",
    "params_to_jax",
    "save_pytree",
]
