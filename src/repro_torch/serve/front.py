"""`ServeFront` — the fleet's inference front door (port of
``repro/serve/front.py``).

One front holds the K personalized models a gossip run trained (loaded
straight from a fleet snapshot — `repro_torch.fleet.snapshot` is the serving
format, no export step), the `Router` that picks who answers, the
`TeacherPredictionCache` for hot-window ensemble queries, the optional
`ContinuousBatchingEngine` for LM generation, and the `TrafficLog` that
turns everything it served into the next distillation stream.

`run_serve_scenario` is the end-to-end story the preset, the launcher and
the smoke all drive: train a fleet → snapshot → serve a mixed request
stream against the snapshot → feed the served traffic back as the public
pool and watch clients distill from production load over the metered
wire.

Runs on the card unless ``device="cpu"`` is passed: the front, its engine
and the training run live on one device. The front's forwards run
eagerly (the reference jits them). The engine's params are drawn from a
CPU torch generator seeded by ``ServeSpec.seed`` (the reference draws
from its own ``PRNGKey(seed)``, which torch cannot replay), then moved to
the device.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.runtime import batch_to_device
from repro_torch.data.pipeline import PublicPool
from repro_torch.obs import tracer as trace
from repro_torch.serve.engine import ContinuousBatchingEngine
from repro_torch.serve.feedback import (TrafficLog, feedback_summary,
                                        run_feedback)
from repro_torch.serve.request import ServeRequest, ServeResponse
from repro_torch.serve.router import Router
from repro_torch.serve.teacher_cache import TeacherPredictionCache


class ServeFront:
    def __init__(self, bundles: List[Any], params: List[Any],
                 router: Router, public: PublicPool,
                 cache: Optional[TeacherPredictionCache] = None,
                 engine: Optional[ContinuousBatchingEngine] = None,
                 log_traffic: bool = True,
                 snapshot_step: Optional[int] = None,
                 device: Optional[Any] = None):
        if len(bundles) != len(params):
            raise ValueError(f"{len(bundles)} bundles, "
                             f"{len(params)} param sets")
        self.device = resolve_device(device)
        self.bundles = bundles
        self.params = [{k: v.to(self.device) for k, v in p.items()}
                       for p in params]
        self.router = router
        self.public = public
        self.cache = cache if cache is not None else TeacherPredictionCache()
        self.engine = engine
        self.traffic = TrafficLog() if log_traffic else None
        self.snapshot_step = snapshot_step
        self._apply_cache: Dict[str, Callable] = {}
        self.served: Dict[str, int] = {"classify": 0, "teacher": 0,
                                       "generate": 0}

    # -- construction ------------------------------------------------------

    @classmethod
    def from_snapshot(cls, spec, snapshot_dir: str,
                      data: Optional[Tuple] = None,
                      engine: Optional[ContinuousBatchingEngine] = None,
                      device: Optional[Any] = None) -> "ServeFront":
        """Serve a trained fleet directly from its snapshot directory.

        ``spec`` is the `ExperimentSpec` the fleet trained under (it
        determines architectures, the partition, and the public pool's
        sample stream); ``data`` forwards a pre-materialized
        ``(arrays, test_arrays, partition)`` triple to skip regenerating
        the dataset. A snapshot written by either package can be served."""
        from repro_torch.exp.runner import build_bundles, materialize_data
        from repro_torch.fleet.snapshot import load_client_params

        dev = resolve_device(device)

        arrays, _test, part = (data if data is not None else
                               materialize_data(spec.data, spec.partition,
                                                spec.num_clients))
        bundles = build_bundles(spec)
        params, steps = [], []
        for i, b in enumerate(bundles):
            # any draw works: load_client_params only needs the keys,
            # shapes, dtypes and device; the loaded values replace every
            # leaf (an LM's is drawn on the device, a ResNet's on the CPU)
            gen = torch.Generator(device=dev if b.is_lm else "cpu")
            like = {k: v.to(dev) for k, v in
                    b.init(gen.manual_seed(spec.train.seed + i)).items()}
            p, s = load_client_params(snapshot_dir, i, like)
            params.append(p)
            steps.append(s)
        serve = getattr(spec, "serve", None)
        router = Router.from_partition(
            part, arrays["labels"], spec.data.num_labels,
            policy=serve.router if serve is not None else "label_affinity")
        public = PublicPool(arrays, part.public_indices,
                            spec.train.public_batch_size,
                            seed=spec.train.seed)
        cache = TeacherPredictionCache(
            serve.cache_windows if serve is not None else 8)
        return cls(bundles, params, router, public, cache=cache,
                   engine=engine, snapshot_step=min(steps), device=dev)

    def _apply(self, bundle) -> Callable:
        if bundle.name not in self._apply_cache:
            @torch.no_grad()
            def apply_fn(params, batch):
                return bundle.apply(params, batch)["logits"]

            self._apply_cache[bundle.name] = apply_fn
        return self._apply_cache[bundle.name]

    # -- the three request kinds ------------------------------------------

    def classify(self, request: ServeRequest) -> ServeResponse:
        t0 = time.perf_counter()
        cid = self.router.route(request)
        with trace.span("serve/classify", request=request.request_id,
                        client=cid):
            logits = self._apply(self.bundles[cid])(
                self.params[cid], batch_to_device(
                    {"images": np.asarray(request.image)[None]},
                    self.device)).cpu().numpy()[0]
        if self.traffic is not None:
            self.traffic.log(request.image)
        self.served["classify"] += 1
        return ServeResponse(
            request_id=request.request_id, kind="classify", client_id=cid,
            label=int(np.argmax(logits)), logits=logits,
            latency_s=time.perf_counter() - t0)

    def teacher_window(self, request: ServeRequest) -> ServeResponse:
        t0 = time.perf_counter()
        teachers = (request.teachers if request.teachers is not None
                    else tuple(range(len(self.bundles))))
        window_id = int(request.window_id)

        def compute() -> Dict[str, np.ndarray]:
            batch = batch_to_device(self.public.sample(window_id),
                                    self.device)
            stacked = np.stack([
                self._apply(self.bundles[t])(
                    self.params[t], batch).cpu().numpy() for t in teachers])
            return {"logits": stacked.mean(axis=0),
                    "sample_ids":
                        self.public.sample_ids(window_id).astype(np.uint64)}

        preds, hit = self.cache.get_or_compute(window_id, teachers, compute)
        if self.traffic is not None and not hit:
            for img in self.public.sample(window_id)["images"]:
                self.traffic.log(img)
        self.served["teacher"] += 1
        return ServeResponse(
            request_id=request.request_id, kind="teacher",
            predictions=preds, cache_hit=hit,
            latency_s=time.perf_counter() - t0)

    def generate(self, requests: List[ServeRequest]) -> List[ServeResponse]:
        if self.engine is None:
            raise ValueError("this front has no decode engine "
                             "(ServeSpec.engine_arch unset)")
        for r in requests:
            self.engine.submit(r)
        out = self.engine.run()
        self.served["generate"] += len(out)
        return out

    def serve(self, request: ServeRequest) -> ServeResponse:
        request.validate()
        if request.kind == "classify":
            return self.classify(request)
        if request.kind == "teacher":
            return self.teacher_window(request)
        return self.generate([request])[0]

    # -- reporting ---------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        out: Dict[str, float] = {
            f"served/{k}": float(v) for k, v in self.served.items()}
        for k, v in self.cache.ledger.summary().items():
            out[f"cache/{k}"] = v
        for k, v in self.router.summary().items():
            out[f"route/{k}"] = v
        if self.engine is not None:
            for k, v in self.engine.summary().items():
                out[f"engine/{k}"] = v
        return out


# -- the end-to-end scenario --------------------------------------------------


@dataclasses.dataclass
class ServeScenarioResult:
    """Everything the serve scenario produced: JSON-safe ``metrics`` plus
    the live front/trainer for drill-downs (never serialized)."""

    spec: Any
    metrics: Dict[str, float]
    responses: List[ServeResponse]
    front: ServeFront = dataclasses.field(repr=False)
    experiment: Any = dataclasses.field(repr=False)


def _request_stream(spec, test_arrays, rng) -> List[ServeRequest]:
    """A mixed stream: classify queries with label hints (drawn from the
    held-out set) interleaved with teacher-window queries cycling over a
    few hot windows — the cycle (not a random draw) guarantees window
    reuse whenever a window is queried twice, so the cache-hit
    acceptance holds even for the 8-request smoke."""
    serve = spec.serve
    n = serve.requests
    hot_windows = max(1, n // 8)
    out: List[ServeRequest] = []
    images, labels = test_arrays["images"], test_arrays["labels"]
    teacher_queries = 0
    for rid in range(n):
        if rid % 3 == 2:  # every third query asks for teacher predictions
            out.append(ServeRequest(
                request_id=rid, kind="teacher",
                window_id=teacher_queries % hot_windows,
                teachers=serve.teachers))
            teacher_queries += 1
        else:
            i = int(rng.integers(0, images.shape[0]))
            out.append(ServeRequest(
                request_id=rid, kind="classify", image=images[i],
                label_hint=int(labels[i])))
    return out


def _generate_stream(spec, vocab_size: int, rng) -> List[ServeRequest]:
    """Mixed-length decode requests — the lengths are deliberately skewed
    so static batching visibly stalls short requests behind long ones."""
    serve = spec.serve
    out = []
    for rid in range(max(serve.num_slots * 2, 4)):
        prompt_len = int(rng.integers(4, 9))
        out.append(ServeRequest(
            request_id=10_000 + rid, kind="generate",
            prompt=rng.integers(0, vocab_size, size=prompt_len,
                                dtype=np.int32),
            max_new_tokens=int(rng.integers(1, serve.max_new_tokens + 1))))
    return out


def build_engine(spec, admission: str = "continuous",
                 device: Optional[Any] = None) -> ContinuousBatchingEngine:
    """The spec's decode engine: a reduced zoo LM with deterministic
    params (`ServeSpec.engine_arch`/``seed``), on ``device``."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.zoo import build_bundle

    serve = spec.serve
    cfg = get_reduced(serve.engine_arch)
    bundle = build_bundle(cfg)
    params = bundle.init(torch.Generator().manual_seed(serve.seed))
    cache_len = 8 + serve.max_new_tokens  # prompt lengths top out at 8
    return ContinuousBatchingEngine(bundle, params,
                                    num_slots=serve.num_slots,
                                    cache_len=cache_len,
                                    admission=admission, device=device)


def run_serve_scenario(spec, workdir: str,
                       device: Optional[Any] = None) -> ServeScenarioResult:
    """Train → snapshot → serve → feed back. The one path behind the
    ``serve_loop`` preset, ``launch/serve.py --preset``, chip_smoke's
    serve phase and the end-to-end tests."""
    from repro_torch.exp.runner import materialize_data, run_spec

    serve = spec.serve
    if serve is None or serve.requests <= 0:
        raise ValueError("spec.serve.requests must be > 0 to serve")
    snap_dir = os.path.join(workdir, "snapshots")
    train = spec.train
    if not train.snapshot_dir:
        train = dataclasses.replace(
            train, snapshot_dir=snap_dir,
            snapshot_every=train.snapshot_every or train.steps)
        spec = dataclasses.replace(spec, train=train)
    if serve.feedback_steps > 0 and spec.optimizer.total_steps is None:
        # the cosine schedule reaches exactly zero at total_steps — the
        # run is really train.steps + feedback_steps long, and feedback
        # updates at lr=0 would "distill" without moving a single param
        spec = dataclasses.replace(spec, optimizer=dataclasses.replace(
            spec.optimizer,
            total_steps=train.steps + serve.feedback_steps))
    spec = spec.validate()

    device = resolve_device(device)
    data = materialize_data(spec.data, spec.partition, spec.num_clients)
    result = run_spec(spec, data=data, device=device)

    engine = None
    if serve.engine_arch is not None:
        engine = build_engine(spec, device=device)
    front = ServeFront.from_snapshot(spec, spec.train.snapshot_dir,
                                     data=data, engine=engine,
                                     device=device)

    rng = np.random.default_rng(serve.seed)
    t_serve = time.perf_counter()
    responses = [front.serve(r)
                 for r in _request_stream(spec, data[1], rng)]
    if engine is not None:
        responses.extend(front.generate(_generate_stream(
            spec, engine.bundle.config.vocab_size, rng)))
    serve_wall = time.perf_counter() - t_serve

    metrics: Dict[str, float] = dict(front.stats())
    metrics["serve/wall_s"] = serve_wall
    metrics["serve/requests_per_s"] = len(responses) / max(serve_wall, 1e-9)
    lat = sorted(r.latency_s for r in responses)
    metrics["serve/p50_ms"] = lat[len(lat) // 2] * 1e3
    metrics["serve/p99_ms"] = lat[min(len(lat) - 1,
                                      int(len(lat) * 0.99))] * 1e3
    metrics["serve/snapshot_step"] = float(front.snapshot_step)

    if serve.feedback_steps > 0:
        trainer = result.trainer
        bytes_before = trainer.meter.total_bytes
        fb = run_feedback(trainer, front.traffic, spec.train.steps,
                          serve.feedback_steps)
        for k, v in feedback_summary(
                fb, spec.num_clients,
                wire_bytes=trainer.meter.total_bytes - bytes_before).items():
            metrics[f"feedback/{k}"] = v

    return ServeScenarioResult(spec=spec, metrics=metrics,
                               responses=responses, front=front,
                               experiment=result)
