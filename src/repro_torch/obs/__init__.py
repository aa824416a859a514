"""repro_torch.obs — the span/counter/instant tracer (a copy of
``repro/obs/tracer.py``). The runtime, the bus and the wire call it; it is
disabled, and free, unless ``trace.enable()`` is called."""
from __future__ import annotations

from repro_torch.obs import tracer as trace

__all__ = ["trace"]
