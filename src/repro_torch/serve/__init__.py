"""repro_torch.serve — the fleet's inference path (port of
``repro/serve``, the same exported names).

A trained gossip fleet is K personalized models; this package serves
them:

  request.py        `ServeRequest` / `ServeResponse` — classify,
                    teacher-window, and generate query kinds.
  router.py         `Router` — client-id / label-affinity / round-robin
                    mapping from request to personalized model, built
                    from the run's `Partition`.
  engine.py         `ContinuousBatchingEngine` + `Prefill` — slot-based
                    greedy decoding over the zoo's ``decode_step`` (one
                    call for every slot, a cache position per row;
                    admit/retire at any tick), with static batching as a
                    one-flag admission policy for the comparison.
  teacher_cache.py  `TeacherPredictionCache` + `CacheLedger` — LRU of
                    ensemble predictions keyed by (public window,
                    teacher set); hits are byte-identical to recompute.
  feedback.py       `TrafficLog` / `attach_traffic` / `run_feedback` —
                    served traffic becomes the public distillation
                    stream of a live trainer (serve→distill loop).
  front.py          `ServeFront` — snapshot-loading front door tying the
                    above together, and `run_serve_scenario`, the
                    train→snapshot→serve→feed-back end-to-end run.

Declared via `ServeSpec` on the `ExperimentSpec` surface (preset
``serve_loop``); run by ``python -m repro_torch.launch.serve``; traced
under the ``serve/*`` spans. Runs on the card unless ``device="cpu"`` is
passed.
"""
from repro_torch.serve.engine import (
    ContinuousBatchingEngine,
    Prefill,
    solo_generate,
)
from repro_torch.serve.feedback import (
    TrafficLog,
    attach_traffic,
    feedback_summary,
    run_feedback,
)
from repro_torch.serve.front import (
    ServeFront,
    ServeScenarioResult,
    build_engine,
    run_serve_scenario,
)
from repro_torch.serve.request import ServeRequest, ServeResponse
from repro_torch.serve.router import Router
from repro_torch.serve.teacher_cache import CacheLedger, TeacherPredictionCache

__all__ = [
    "CacheLedger",
    "ContinuousBatchingEngine",
    "Prefill",
    "Router",
    "ServeFront",
    "ServeRequest",
    "ServeResponse",
    "ServeScenarioResult",
    "TeacherPredictionCache",
    "TrafficLog",
    "attach_traffic",
    "build_engine",
    "feedback_summary",
    "run_feedback",
    "run_serve_scenario",
    "solo_generate",
]
