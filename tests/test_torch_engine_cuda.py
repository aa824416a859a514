"""The serving engine's CUDA-graph step on the card (marked ``cuda``;
skips without a card): for every reduced LM family, `GraphStep` gives the
eager ``decode_step``'s logits and caches on rows at different positions,
a capture survives an earlier graph turning into cyclic garbage while it
runs, and the engine on the card gives `solo_generate`'s tokens.

Run on a card with ``PYTHONPATH=src python3 -m pytest -q -m cuda
tests/test_torch_engine_cuda.py``. The CPU tests of the same code paths'
numbers are in tests/test_torch_decode.py and tests/test_torch_serve.py.
"""
import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.models import build_bundle
from repro_torch.serve import (ContinuousBatchingEngine, ServeRequest,
                               solo_generate)
from repro_torch.serve.engine import GraphStep
import test_torch_threads

test_torch_threads.share_cores()

FAMILIES = ["minitron-4b", "gemma3-12b", "mamba2-370m", "zamba2-7b",
            "arctic-480b", "deepseek-v3-671b", "whisper-large-v3",
            "llama-3.2-vision-90b"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph is captured only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(name, dev):
    cfg = get_reduced(name)
    bundle = build_bundle(cfg)
    params = {k: v.to(dev) for k, v in
              bundle.init(torch.Generator().manual_seed(0)).items()}
    return cfg, bundle, params


@pytest.mark.cuda
@pytest.mark.parametrize("name", FAMILIES)
@torch.no_grad()
def test_graph_step_equals_eager_step(cuda, name):
    cfg, bundle, params = _model(name, cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    B = 3

    def tokens():
        return torch.randint(0, cfg.vocab_size, (B, 1), generator=g,
                             device=cuda, dtype=torch.int32)

    caches = bundle.init_cache(B, 24, torch.float32, device=cuda)
    for _ in range(3):
        _, caches = bundle.decode_step(params, tokens(), caches)
    shift = 5 * torch.arange(B, dtype=torch.int32, device=cuda)
    caches = {k: v + shift if k.endswith("index") else v
              for k, v in caches.items()}
    tok = tokens()
    want, want_c = bundle.decode_step(params, tok, caches)
    graph = GraphStep(bundle, params, caches)
    for _ in range(2):  # a replay from the same caches repeats itself
        got, got_c = graph(params, tok, caches)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        for k, v in want_c.items():
            torch.testing.assert_close(got_c[k], v, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@torch.no_grad()
def test_capture_survives_a_graph_collected_meanwhile(cuda):
    """An earlier graph that becomes unreachable in a reference cycle
    while a capture runs, followed by enough allocations to make the
    collector due, is freed after the capture and not inside it
    (destroying a graph during a capture invalidates the capture)."""
    cfg, bundle, params = _model("minitron-4b", cuda)
    caches = bundle.init_cache(2, 16, torch.float32, device=cuda)
    holder = [GraphStep(bundle, params, caches)]
    dead = weakref.ref(holder[0])

    class DroppingBundle:
        """``bundle``, but its first call inside a capture leaves the
        earlier graph in an unreachable cycle, then allocates past the
        collector's threshold."""

        def decode_step(self, *args):
            if holder and torch.cuda.is_current_stream_capturing():
                cycle = [holder.pop()]
                cycle.append(cycle)
                del cycle
                due = [[] for _ in range(2 * gc.get_threshold()[0] + 2)]
                del due
            return bundle.decode_step(*args)

    graph = GraphStep(DroppingBundle(), params, caches)
    assert not holder
    gc.collect()
    assert dead() is None
    tok = torch.randint(0, cfg.vocab_size, (2, 1), dtype=torch.int32,
                        device=cuda)
    want, want_c = bundle.decode_step(params, tok, caches)
    got, got_c = graph(params, tok, caches)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for k, v in want_c.items():
        torch.testing.assert_close(got_c[k], v, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["minitron-4b", "mamba2-370m",
                                  "arctic-480b"])
def test_engine_on_the_card_equals_solo(cuda, name):
    cfg, bundle, params = _model(name, cuda)
    rng = np.random.default_rng(2)
    engine = ContinuousBatchingEngine(bundle, params, num_slots=3,
                                      cache_len=20, device=cuda)
    reqs = [ServeRequest(request_id=i, kind="generate",
                         prompt=rng.integers(0, cfg.vocab_size,
                                             int(rng.integers(3, 9)),
                                             dtype=np.int32),
                         max_new_tokens=int(rng.integers(1, 10)))
            for i in range(6)]
    for r in reqs:
        engine.submit(r)
    out = {r.request_id: r.tokens for r in engine.run()}
    for r in reqs:
        assert out[r.request_id] == solo_generate(
            bundle, engine.params, r.prompt, r.max_new_tokens, 20)
