"""The import guard compares whole top-level names, and no module of the
benchmark imports JAX, the JAX package, or (the reference) the port."""
import ast
from pathlib import Path

from portbench import guard

HERE = Path(__file__).resolve().parents[1]


def test_guard_rejects_jax_and_the_jax_package_and_accepts_the_port():
    names = ["repro", "repro.core.runtime", "jax", "jax.numpy", "jaxlib",
             "flax.linen", "repro_torch", "repro_torch.core", "jaxtyping",
             "reprox", "torch"]
    assert guard.forbidden(names) == ["flax.linen", "jax", "jax.numpy",
                                      "jaxlib", "repro",
                                      "repro.core.runtime"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not guard.forbidden(_imports(path)), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert "repro_torch" not in tops, path
