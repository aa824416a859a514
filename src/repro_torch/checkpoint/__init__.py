from repro_torch.checkpoint.io import (
    CheckpointManager,
    flatten_with_paths,
    load_pytree,
    params_from_jax,
    params_to_jax,
    restore_client_states,
    save_client_states,
    save_pytree,
)
from repro_torch.checkpoint.pool import CheckpointPool, PoolEntry

__all__ = [
    "CheckpointManager",
    "CheckpointPool",
    "PoolEntry",
    "flatten_with_paths",
    "load_pytree",
    "params_from_jax",
    "params_to_jax",
    "restore_client_states",
    "save_client_states",
    "save_pytree",
]
