"""The import guard: a run may not load JAX or the JAX package. Module
names are compared by their top-level name (the part before the first
dot), whole, so the port (``repro_torch``) passes while ``repro`` and
``repro.core`` do not."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden(names: Iterable[str]) -> List[str]:
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def loaded_forbidden() -> List[str]:
    return forbidden(list(sys.modules))
