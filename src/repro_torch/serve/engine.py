"""Continuous-batching greedy-decode engine over the zoo's ``decode_step``
(port of ``repro/serve/engine.py``).

The unit of batching is a *slot*: one row of the engine's caches. The
caches' ``index`` holds one position per row, so one ``decode_step`` call
advances every slot at its own position: rows sit at *different* decode
positions inside one step, with no loop over the slots through the model
(the reference gets the same from ``jit(vmap(decode_step))`` over
batch-1 lanes). That is what makes the batching continuous: a finished
request retires its slot and a queued request is admitted into it at the
next tick, while the other slots keep decoding — mixed generation lengths
never stall each other.

Admission is a policy on the same engine:

  * ``"continuous"`` — fill any free slot at any tick (the production
    mode).
  * ``"static"`` — admit only when *all* slots are free (classic static
    batching: the batch drains fully before the next one forms). The
    continuous-vs-static comparison flips this one flag, so the two
    modes share all of the compute path.

Prompt ingestion is `Prefill`: the reference's is one jitted
``lax.scan(decode_step)`` over the prompt; here the same steps run in a
loop, bitwise the token-by-token loop (asserted in
tests/test_torch_serve.py).

On the card each step is a CUDA graph of ``decode_step`` (`GraphStep`),
the port's counterpart of the reference's ``jit``: one capture per
(params, batch, cache shapes), then a replay a token. The eager call
issues some 1,700–2,800 kernels a token from the host, and the host is
what a full-width eager step waits on (`ablations/serve_decode.py` times
both). The graph runs the same kernels as the eager call; on the CPU the
engine calls ``decode_step`` itself.

Numerics contract: a slot's cache is written wholesale at admission
(prefill runs at batch 1, exactly the solo path), and nothing in
``decode_step`` couples rows — each row has its own position, ring slot
and mask, and the MoE FFN routes and caps each row on its own — so a
request's greedy tokens do not depend on which other requests share the
engine. A batched matmul may sum in another order than a batch-1 one, so
cross-shape comparisons are argmax-token-exact rather than logit-bitwise.

Runs on the card unless ``device="cpu"`` is passed; the params are moved
to the engine's device.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.obs import tracer as trace
from repro_torch.serve.request import ServeRequest, ServeResponse

ADMISSION = ("continuous", "static")


class GraphStep:
    """``bundle.decode_step`` for one (params, batch, cache shapes) as a
    CUDA graph. The caches live in the graph's own buffers (``caches``),
    which each replay updates in place; ``__call__(params, tokens,
    caches)`` copies ``caches`` in unless they are those buffers, copies
    the tokens in, replays, and returns ``(logits, self.caches)``. The
    logits are a buffer the next replay overwrites."""

    @torch.no_grad()
    def __init__(self, bundle, params, caches):
        self.params = params
        self.caches = {k: v.clone() for k, v in caches.items()}
        self.tokens = torch.zeros((caches["index"].shape[0], 1),
                                  dtype=torch.int32,
                                  device=caches["index"].device)

        def step():
            logits, new = bundle.decode_step(params, self.tokens,
                                             self.caches)
            for k, v in new.items():
                self.caches[k].copy_(v)
            return logits

        # a warm-up on a side stream sets up cuBLAS and the allocator
        # before the capture, as torch.cuda.graph asks
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        # no garbage collection inside the capture: an unreachable cycle
        # that holds another graph would be freed there, and destroying a
        # graph while one is being captured invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph):
                self.logits = step()
        finally:
            if collecting:
                gc.enable()
        for k, v in caches.items():  # the warm-up moved them on a step
            self.caches[k].copy_(v)

    def __call__(self, params, tokens: torch.Tensor, caches):
        if params is not self.params:
            raise ValueError("this graph was captured with other params")
        if caches is not self.caches:
            for k, v in caches.items():
                self.caches[k].copy_(v)
        self.tokens.copy_(tokens)
        self.graph.replay()
        return self.logits, self.caches


def step_fn(bundle, params, caches) -> Callable:
    """The decode step for caches like ``caches``: a `GraphStep` captured
    for them on the card, ``bundle.decode_step`` itself on the CPU."""
    if caches["index"].is_cuda:
        return GraphStep(bundle, params, caches)
    return bundle.decode_step


class Prefill:
    """Full-prompt prefill: ``decode_step`` over the prompt's tokens.

    ``__call__(params, tokens (B, T), caches)`` returns ``(caches, logits
    (T, B, 1, V))`` — the caches warmed through the whole prompt and every
    step's logits (``logits[-1]`` feeds the first generated token); the
    caches passed in are left as they were. On the card the steps replay
    a graph captured at the first call for those params and cache shapes
    and kept for the next."""

    def __init__(self, bundle):
        if not getattr(bundle, "is_lm", False):
            raise ValueError(f"bundle {bundle.name!r} has no decode path")
        self.bundle = bundle
        self._graphs: Dict[tuple, GraphStep] = {}

    def _step(self, params, caches) -> Callable:
        if not caches["index"].is_cuda:
            return self.bundle.decode_step
        # a graph holds its params, so their id names them while it lives
        key = (id(params),) + tuple((k, tuple(v.shape), v.dtype)
                                    for k, v in caches.items())
        if key not in self._graphs:
            self._graphs[key] = GraphStep(self.bundle, params, caches)
        return self._graphs[key]

    @torch.no_grad()
    def __call__(self, params, tokens: torch.Tensor, caches):
        step = self._step(params, caches)
        logits = []
        for t in range(tokens.shape[1]):
            lg, caches = step(params, tokens[:, t:t + 1], caches)
            logits.append(lg.clone())
        if isinstance(step, GraphStep):  # hand out copies of its buffers
            caches = {k: v.clone() for k, v in caches.items()}
        return caches, torch.stack(logits)


@dataclasses.dataclass
class _Lane:
    """One occupied slot: the request plus its accumulated greedy tokens."""

    request: ServeRequest
    tokens: List[int]
    submit_s: float
    admit_tick: int


def _batch_axis(key: str) -> int:
    """A cache leaf's row axis: a stage's leaves lead with their repeats."""
    return 0 if key == "index" else 1


class ContinuousBatchingEngine:
    """Greedy decoding for a stream of `ServeRequest`s over one model.

    ``submit`` enqueues; ``tick`` advances the engine one decode step
    (admitting and retiring slots as it goes) and returns the responses
    completed that tick; ``run`` ticks until drained. One engine serves
    one (bundle, params) pair.
    """

    def __init__(self, bundle, params: Dict[str, torch.Tensor],
                 num_slots: int = 4, cache_len: int = 64,
                 admission: str = "continuous",
                 cache_dtype: torch.dtype = torch.float32,
                 device: Optional[Any] = None):
        if admission not in ADMISSION:
            raise ValueError(f"unknown admission policy {admission!r}; "
                             f"known: {ADMISSION}")
        if num_slots < 1:
            raise ValueError("engine needs at least one slot")
        self.device = resolve_device(device)
        self.bundle = bundle
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.num_slots = num_slots
        self.cache_len = cache_len
        self.admission = admission
        self.cache_dtype = cache_dtype
        self.prefill = Prefill(bundle)
        # one call for every slot: params shared, token and cache per row
        caches = bundle.init_cache(num_slots, cache_len, cache_dtype,
                                   device=self.device)
        self.decode = step_fn(bundle, self.params, caches)
        # on the card, the graph's own buffers
        self.caches = getattr(self.decode, "caches", caches)
        self.tokens = torch.zeros((num_slots, 1), dtype=torch.int32,
                                  device=self.device)
        self.lanes: List[Optional[_Lane]] = [None] * num_slots
        self.queue: Deque[ServeRequest] = deque()
        self._submit_s: Dict[int, float] = {}
        # occupancy/throughput counters
        self.ticks = 0
        self.decode_ticks = 0
        self.prefills = 0
        self.completed = 0
        self.lane_ticks_busy = 0
        self.lane_ticks_total = 0

    # -- request intake ----------------------------------------------------

    def submit(self, request: ServeRequest) -> None:
        request.validate()
        if request.kind != "generate":
            raise ValueError(f"engine only decodes; request "
                             f"{request.request_id} is {request.kind!r}")
        total = len(np.asarray(request.prompt)) + request.max_new_tokens
        if total > self.cache_len:
            raise ValueError(
                f"request {request.request_id} needs {total} cache "
                f"positions, engine has {self.cache_len} (ring wrap "
                "would corrupt full attention)")
        self._submit_s[request.request_id] = time.perf_counter()
        self.queue.append(request)

    # -- lane lifecycle ----------------------------------------------------

    def _write_lane(self, slot: int, caches, tok0: int) -> None:
        for k, full in self.caches.items():
            ax = _batch_axis(k)
            full.select(ax, slot).copy_(caches[k].select(ax, 0))
        self.tokens[slot, 0] = tok0

    def _retire(self, slot: int, done: List[ServeResponse]) -> None:
        lane = self.lanes[slot]
        self.lanes[slot] = None
        self.completed += 1
        done.append(ServeResponse(
            request_id=lane.request.request_id, kind="generate",
            tokens=list(lane.tokens),
            latency_s=time.perf_counter() - lane.submit_s,
            admit_tick=lane.admit_tick, finish_tick=self.ticks))

    def _admit(self, done: List[ServeResponse]) -> None:
        free = [i for i, lane in enumerate(self.lanes) if lane is None]
        if self.admission == "static" and len(free) != self.num_slots:
            return  # static batching: drain the whole batch first
        while free and self.queue:
            slot = free.pop(0)
            req = self.queue.popleft()
            prompt = torch.from_numpy(np.asarray(
                req.prompt, dtype=np.int32)[None, :]).to(self.device)
            with trace.span("serve/prefill", request=req.request_id,
                            slot=slot, prompt_len=int(prompt.shape[1])):
                caches = self.bundle.init_cache(1, self.cache_len,
                                                self.cache_dtype,
                                                device=self.device)
                caches, logits = self.prefill(self.params, prompt, caches)
                tok0 = int(logits[-1][0, -1].argmax())
            self.prefills += 1
            self._write_lane(slot, caches, tok0)
            self.lanes[slot] = _Lane(
                request=req, tokens=[tok0],
                submit_s=self._submit_s.pop(req.request_id,
                                            time.perf_counter()),
                admit_tick=self.ticks)
            if req.max_new_tokens == 1:
                self._retire(slot, done)  # prompt-only ask: done at admit

    # -- stepping ----------------------------------------------------------

    def tick(self) -> List[ServeResponse]:
        """One engine tick: admit into free slots, then one decode step
        for every slot (idle slots decode garbage that nobody reads).
        Returns the requests completed this tick."""
        done: List[ServeResponse] = []
        self._admit(done)
        active = [i for i, lane in enumerate(self.lanes) if lane is not None]
        if active:
            with trace.span("serve/decode", active=len(active),
                            tick=self.ticks):
                with torch.no_grad():
                    logits, self.caches = self.decode(
                        self.params, self.tokens, self.caches)
                nxt = logits[:, -1].argmax(-1)  # (slots,)
                self.tokens = nxt[:, None].to(torch.int32)
                nxt_np = nxt.cpu().numpy()
            self.decode_ticks += 1
            self.lane_ticks_busy += len(active)
            self.lane_ticks_total += self.num_slots
            for slot in active:
                lane = self.lanes[slot]
                lane.tokens.append(int(nxt_np[slot]))
                if len(lane.tokens) >= lane.request.max_new_tokens:
                    self._retire(slot, done)
        self.ticks += 1
        return done

    def run(self, max_ticks: Optional[int] = None) -> List[ServeResponse]:
        """Tick until every queued and in-flight request completes."""
        out: List[ServeResponse] = []
        while self.queue or any(lane is not None for lane in self.lanes):
            out.extend(self.tick())
            if max_ticks is not None and self.ticks >= max_ticks:
                raise RuntimeError(
                    f"engine did not drain within {max_ticks} ticks "
                    f"({len(self.queue)} queued, "
                    f"{sum(l is not None for l in self.lanes)} in flight)")
        return out

    # -- reporting ---------------------------------------------------------

    def occupancy(self) -> float:
        """Busy lane-ticks / total lane-ticks over decode ticks — the
        number static batching loses on mixed generation lengths."""
        return (self.lane_ticks_busy / self.lane_ticks_total
                if self.lane_ticks_total else 0.0)

    def summary(self) -> Dict[str, float]:
        return {"ticks": float(self.ticks),
                "decode_ticks": float(self.decode_ticks),
                "prefills": float(self.prefills),
                "completed": float(self.completed),
                "occupancy": self.occupancy()}


@torch.no_grad()
def solo_generate(bundle, params: Dict[str, torch.Tensor],
                  prompt: np.ndarray, max_new_tokens: int,
                  cache_len: int) -> List[int]:
    """Reference single-request greedy decode on the params' device:
    prefill + a ``decode_step`` loop at B = 1, no slot engine — the
    determinism oracle the continuous-batch tests compare against."""
    device = next(iter(params.values())).device
    tokens = torch.from_numpy(np.asarray(prompt, dtype=np.int32)[None, :]
                              ).to(device)
    caches = bundle.init_cache(1, cache_len, torch.float32, device=device)
    prefill = Prefill(bundle)
    caches, logits = prefill(params, tokens, caches)
    step = prefill._step(params, caches)  # the prefill's own step
    tok = logits[-1][:, -1:].argmax(-1).to(torch.int32)
    out = [int(tok[0, 0])]
    while len(out) < max_new_tokens:
        logits, caches = step(params, tok, caches)
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        out.append(int(tok[0, 0]))
    return out
