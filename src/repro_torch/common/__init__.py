"""Framework-free helpers shared by the port (copies of ``repro/common``'s
numpy-free modules)."""
