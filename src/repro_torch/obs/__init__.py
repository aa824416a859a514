"""repro_torch.obs — tracing and metrics (port of ``repro.obs``):

  tracer.py   the span/counter/instant tracer; the runtime, the
              scheduler, the bus and the wire call it. Disabled, and
              free, unless ``trace.enable()`` is called.
  export.py   Chrome trace-event JSON (Perfetto, chrome://tracing) and
              the cross-process merge.
  metrics.py  one typed snapshot folding the `CommMeter` books, the
              scheduler's freshness report, the tracer's phase
              attribution and each distill update's roofline, exported
              by `Experiment.run()` under the ``obs/`` metric namespace
              when ``TrainSpec.trace_dir`` is set.
"""
from __future__ import annotations

from repro_torch.obs import tracer as trace
from repro_torch.obs.export import (
    load_trace,
    merge_traces,
    to_chrome_events,
    write_trace,
)
from repro_torch.obs.metrics import ObsSnapshot, collect_obs
from repro_torch.obs.tracer import Tracer, flow_id

__all__ = [
    "ObsSnapshot",
    "Tracer",
    "collect_obs",
    "flow_id",
    "load_trace",
    "merge_traces",
    "to_chrome_events",
    "trace",
    "write_trace",
]
