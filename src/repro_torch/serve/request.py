"""Request/response types of the serving front (a copy of
``repro/serve/request.py``: numpy only).

One `ServeRequest` is one user query against the fleet. Three kinds:

  * ``"classify"`` — an image scored by one *personalized* client model
    (the router picks which; paper: each client "preserves and enhances
    performance on its private task").
  * ``"teacher"`` — the ensemble prediction of a teacher set on one
    public-pool window (what the distillation wire ships); hot windows
    are served from the `TeacherPredictionCache`.
  * ``"generate"`` — greedy LM decoding through the continuous-batching
    engine (`repro_torch.serve.engine`).

Responses carry the payload plus the serving bookkeeping the benchmarks
aggregate (which client served, cache hit, wall latency, engine ticks).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

KINDS = ("classify", "teacher", "generate")


@dataclasses.dataclass
class ServeRequest:
    request_id: int
    kind: str = "classify"
    # classify
    image: Optional[np.ndarray] = None  # (H, W, C)
    label_hint: Optional[int] = None  # routing hint (label affinity)
    client_id: Optional[int] = None  # routing pin (client_id policy)
    # teacher
    window_id: Optional[int] = None  # public-pool step (PublicPool.sample)
    teachers: Optional[Tuple[int, ...]] = None  # None = the whole fleet
    # generate
    prompt: Optional[np.ndarray] = None  # (T,) int32 token ids
    max_new_tokens: int = 16

    def validate(self) -> "ServeRequest":
        if self.kind not in KINDS:
            raise ValueError(f"unknown request kind {self.kind!r}; "
                             f"known: {KINDS}")
        if self.kind == "classify" and self.image is None:
            raise ValueError(f"classify request {self.request_id} "
                             "has no image")
        if self.kind == "teacher" and self.window_id is None:
            raise ValueError(f"teacher request {self.request_id} "
                             "has no window_id")
        if self.kind == "generate":
            if self.prompt is None or np.asarray(self.prompt).ndim != 1:
                raise ValueError(f"generate request {self.request_id} "
                                 "needs a 1-D token prompt")
            if self.max_new_tokens < 1:
                raise ValueError(f"generate request {self.request_id} "
                                 "asks for < 1 new token")
        return self


@dataclasses.dataclass
class ServeResponse:
    request_id: int
    kind: str
    client_id: Optional[int] = None  # who served it (classify/generate)
    label: Optional[int] = None  # classify: argmax class
    logits: Optional[np.ndarray] = None  # classify: (num_labels,)
    predictions: Optional[Dict[str, np.ndarray]] = None  # teacher ensemble
    cache_hit: Optional[bool] = None  # teacher: served from cache?
    tokens: Optional[List[int]] = None  # generate: greedy continuation
    latency_s: float = 0.0  # submit -> complete wall time
    admit_tick: int = -1  # generate: engine tick admitted
    finish_tick: int = -1  # generate: engine tick retired
