"""Framework-free helpers shared by the port (port of ``repro.common``):
`pytree` (leafwise arithmetic over flat param dicts), `dtypes`
(`DtypePolicy`), `registry`, and `sharding` (the logical roles and the
active mesh that the multi-device modules read)."""
