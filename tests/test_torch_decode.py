"""The port's LM decode path against the JAX package, on the CPU, at the
reduced configs, from the reference's params (drawn by its own init and
carried over by `params_from_jax`).

Covers ``decode_step`` and the caches beneath it for eight families:
minitron-4b (full attention, squared ReLU), gemma3-12b (sliding-window
ring caches of 32 slots, decoded past the window so the ring wraps),
mamba2-370m (the SSM and conv states), zamba2-7b (the shared attention
block's cache), arctic-480b (the MoE FFN in decode), deepseek-v3-671b (the
absorbed MLA decode), whisper-large-v3 (`prefill_cross_caches` from audio
frames, learned positions) and llama-3.2-vision-90b (the vision cross
caches, every ``cross_gate`` at 0.5: at its initial 0 the cross layer is
multiplied away). Each case feeds a prompt token by token, then its own
greedy tokens: the logits of every step, the greedy tokens and every
cache leaf are held against the reference's jitted ``decode_step``.

Then the port's own contract, which the reference meets through
``vmap`` over the engine's slots: one batched call whose rows sit at
different positions equals B = 1 calls, row for row, and the MoE FFN
routes and caps each row on its own (`moe_apply_lanes` against one
`moe_apply` call a row).

Tolerance: 1e-4 of the largest magnitude of each compared array (logits
of a step, a cache leaf): float32 CPU matmuls summed in another order by
the two frameworks, carried through up to 40 decode steps.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as JIO
from repro.configs import get_reduced as jax_reduced
from repro.models import transformer as JTF
from repro_torch.checkpoint import io as TIO
from repro_torch.configs import get_reduced
from repro_torch.models import build_bundle
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TTF
import test_torch_threads

test_torch_threads.share_cores()

for _op in (torch.exp, torch.log, torch.sqrt, torch.tanh):
    _op(torch.ones(1))

TOL = 1e-4
GATE = 0.5
# (batch, prompt tokens, greedy tokens, cache_len); whisper's cache_len is
# its encoder's frame count, its self cache the decoder's 32 positions
CASES = {
    "minitron-4b": (2, 7, 6, 16),
    "gemma3-12b": (2, 24, 16, 48),  # 40 positions through a 32-slot ring
    "mamba2-370m": (2, 7, 6, 16),
    "zamba2-7b": (2, 6, 5, 16),
    "arctic-480b": (2, 7, 6, 16),
    "deepseek-v3-671b": (2, 7, 6, 16),
    "whisper-large-v3": (2, 6, 6, 20),
    "llama-3.2-vision-90b": (2, 6, 5, 16),
}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@functools.lru_cache(maxsize=None)
def reference(name: str):
    """One reference a config for the whole module: its config, its params
    (its own init under jit; every cross_gate at GATE) and its jitted
    decode_step."""
    jcfg = jax_reduced(name)
    params = jax.jit(lambda k: JTF.init_lm(k, jcfg))(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v)
            for k, v in JIO.flatten_with_paths(params).items()}
    for k in flat:
        if k.endswith("cross_gate"):
            flat[k] = np.full_like(flat[k], GATE)
    params = jax.tree_util.tree_map(jnp.asarray, nested(flat))
    step = jax.jit(lambda p, tok, c: JTF.decode_step(p, jcfg, tok, c))
    return jcfg, params, flat, step


def nested(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        *parents, leaf = k.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def extras(name: str, B: int, cache_len: int):
    """The modality source of a cross-attention config, as numpy."""
    cfg = get_reduced(name)
    rng = np.random.default_rng(7)
    if cfg.vision is not None:
        return {"vision_embeds": rng.standard_normal(
            (B, cfg.vision.num_patches, cfg.vision.embed_dim)).astype(
            np.float32)}
    if cfg.audio is not None:
        return {"audio_frames": rng.standard_normal(
            (B, cache_len, cfg.audio.frame_dim)).astype(np.float32)}
    return {}


def run_reference(name, prompt, gen, cache_len, src):
    jcfg, params, _, step = reference(name)
    B = prompt.shape[0]
    caches = JTF.init_lm_cache(jcfg, B, cache_len, jnp.float32)
    if src:
        caches = JTF.prefill_cross_caches(
            params, jcfg, caches,
            **{k: jnp.asarray(v) for k, v in src.items()})
    logits, tokens = [], []
    for t in range(prompt.shape[1]):
        lg, caches = step(params, jnp.asarray(prompt[:, t:t + 1]), caches)
        logits.append(np.asarray(lg))
    for _ in range(gen):
        tok = np.argmax(logits[-1][:, -1], axis=-1).astype(np.int32)
        tokens.append(tok)
        lg, caches = step(params, jnp.asarray(tok[:, None]), caches)
        logits.append(np.asarray(lg))
    flat = {k: np.asarray(v)
            for k, v in JIO.flatten_with_paths(caches).items()}
    return np.stack(logits), np.stack(tokens), flat


def port_params(name: str) -> dict:
    return TIO.params_from_jax(reference(name)[2], device="cpu")


def run_port(name, params, prompt, gen, cache_len, src):
    cfg = get_reduced(name)
    B = prompt.shape[0]
    caches = TTF.init_lm_cache(cfg, B, cache_len, torch.float32,
                               device="cpu")
    if src:
        caches = TTF.prefill_cross_caches(
            params, cfg, caches,
            **{k: torch.from_numpy(v) for k, v in src.items()})
    logits, tokens = [], []
    with torch.no_grad():
        for t in range(prompt.shape[1]):
            lg, caches = TTF.decode_step(
                params, cfg, torch.from_numpy(prompt[:, t:t + 1]), caches)
            logits.append(lg.numpy())
        for _ in range(gen):
            tok = np.argmax(logits[-1][:, -1], axis=-1).astype(np.int32)
            tokens.append(tok)
            lg, caches = TTF.decode_step(
                params, cfg, torch.from_numpy(tok[:, None]), caches)
            logits.append(lg.numpy())
    return (np.stack(logits), np.stack(tokens),
            {k: v.numpy() for k, v in caches.items()})


def prompts(name: str, B: int, T: int) -> np.ndarray:
    rng = np.random.default_rng(sum(map(ord, name)))
    return rng.integers(0, get_reduced(name).vocab_size, (B, T),
                        dtype=np.int32)


@pytest.mark.parametrize("name", list(CASES))
def test_decode_step_matches_jax(name):
    B, P, G, cache_len = CASES[name]
    prompt = prompts(name, B, P)
    src = extras(name, B, cache_len)
    lg_j, tok_j, cache_j = run_reference(name, prompt, G, cache_len, src)
    lg_t, tok_t, cache_t = run_port(name, port_params(name), prompt, G,
                                    cache_len, src)
    assert lg_t.shape == lg_j.shape == (P + G, B, 1,
                                        get_reduced(name).vocab_size)
    for t in range(P + G):
        assert _rel(lg_t[t], lg_j[t]) < TOL, (name, t)
    np.testing.assert_array_equal(tok_t, tok_j)
    assert set(cache_t) == set(cache_j)
    for k, ref in cache_j.items():
        got = cache_t[k]
        if k.endswith("index"):
            # the reference's scalar a layer (or one at the top) is every
            # row's position here
            assert got.shape == ref.shape + (B,), k
            np.testing.assert_array_equal(got, np.broadcast_to(
                ref[..., None], got.shape))
            assert int(got.reshape(-1)[0]) == P + G
        else:
            assert got.shape == ref.shape, k
            assert _rel(got, ref) < TOL, k


def test_window_ring_wraps_in_the_gemma3_case():
    """The gemma3 case really decodes past its sliding window: its swa
    caches hold 32 slots and the case writes 40 positions."""
    cfg = get_reduced("gemma3-12b")
    B, P, G, cache_len = CASES["gemma3-12b"]
    caches = TTF.init_lm_cache(cfg, 1, cache_len, device="cpu")
    assert cfg.window_size == 32 and P + G > cfg.window_size
    swa = [li for li, sp in enumerate(cfg.stages[0].block)
           if sp.attn == "swa"]
    assert caches[f"stage0/layer{swa[0]}/attn/k"].shape[2] == 32
    full = [li for li, sp in enumerate(cfg.stages[0].block)
            if sp.attn == "full"]
    assert caches[f"stage0/layer{full[0]}/attn/k"].shape[2] == cache_len


def _rows(caches: dict, b: int) -> dict:
    """Row b of a batch's caches, as a batch of one."""
    return {k: (v[b:b + 1] if k == "index" else v[:, b:b + 1])
            for k, v in caches.items()}


def _stack_rows(rows) -> dict:
    return {k: torch.cat([r[k] for r in rows],
                         dim=0 if k == "index" else 1) for k in rows[0]}


@pytest.mark.parametrize("name", ["minitron-4b", "gemma3-12b",
                                  "mamba2-370m", "arctic-480b",
                                  "deepseek-v3-671b"])
def test_batched_rows_at_different_positions_equal_solo_calls(name):
    """Three rows warmed through prompts of 3, 9 and 37 tokens (gemma3's
    third row past its window), then one batched call: each row's logits
    and cache equal its own B = 1 call's, and the greedy tokens agree."""
    cfg = get_reduced(name)
    params = port_params(name)
    rng = np.random.default_rng(11)
    lens = (3, 9, 37)
    solo, nxt = [], []
    with torch.no_grad():
        for n in lens:
            c = TTF.init_lm_cache(cfg, 1, 48, torch.float32, device="cpu")
            toks = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (1, n + 1), dtype=np.int32))
            for t in range(n):
                _, c = TTF.decode_step(params, cfg, toks[:, t:t + 1], c)
            solo.append(c)
            nxt.append(toks[:, n:])
        batch = _stack_rows(solo)
        assert batch["index"].tolist() == list(lens)
        lg_b, c_b = TTF.decode_step(params, cfg, torch.cat(nxt), batch)
        for b, (c, tok) in enumerate(zip(solo, nxt)):
            lg_s, c_s = TTF.decode_step(params, cfg, tok, c)
            assert _rel(lg_b[b:b + 1], lg_s) < TOL, (name, b)
            assert int(lg_b[b, -1].argmax()) == int(lg_s[0, -1].argmax())
            for k, v in _rows(c_b, b).items():
                if v.dtype == torch.int32:
                    assert torch.equal(v, c_s[k]), k
                else:
                    assert _rel(v, c_s[k]) < TOL, (name, b, k)


def test_moe_lanes_cap_each_row_on_its_own():
    """Arctic's MoE at a capacity that drops pairs: `moe_apply_lanes` over
    (B, T, D) equals one `moe_apply` call a row (C counted over the row's
    own T tokens), and differs from one call over all B·T tokens, whose
    larger capacity keeps other pairs."""
    cfg = get_reduced("arctic-480b")
    params = {k[len("stage0/layer0/ffn/"):]: v[0]
              for k, v in port_params("arctic-480b").items()
              if k.startswith("stage0/layer0/ffn/")}
    g = torch.Generator().manual_seed(3)
    x = torch.randn(3, 8, cfg.d_model, generator=g)
    y, aux = TMOE.moe_apply_lanes(params, x, cfg.moe, cfg.act)
    rows = [TMOE.moe_apply(params, x[b:b + 1], cfg.moe, cfg.act)
            for b in range(3)]
    for b, (yb, auxb) in enumerate(rows):
        assert _rel(y[b:b + 1], yb) < 1e-6, b
        assert abs(float(aux[b]) - float(auxb)) < 1e-6
    # the rows really drop pairs at C = capacity(8) = 6 a row
    ids = TMOE.router_topk(x.reshape(-1, cfg.d_model)
                           @ params["router"], cfg.moe.top_k)[1]
    per_row = [np.bincount(r.reshape(-1).numpy(), minlength=4).max()
               for r in ids.reshape(3, -1)]
    assert max(per_row) > TMOE.capacity(8, cfg.moe)
    whole, _ = TMOE.moe_apply(params, x.reshape(1, -1, cfg.d_model),
                              cfg.moe, cfg.act)
    assert _rel(whole.reshape(x.shape), y) > 1e-3


def test_idle_lanes_cannot_push_out_a_live_lanes_pair():
    """Six one-token lanes that all route to the same experts, as idle
    lanes repeating one garbage token would: one `moe_apply` over the six
    tokens (C = 5) drops a pair, while each lane of `moe_apply_lanes`
    (C = max(ceil(k·cf/E), 1) = 1 for its one token) keeps both of its
    own and equals the lane's call alone."""
    cfg = get_reduced("arctic-480b")
    params = {k[len("stage0/layer0/ffn/"):]: v[0]
              for k, v in port_params("arctic-480b").items()
              if k.startswith("stage0/layer0/ffn/")}
    x = torch.randn(1, 1, cfg.d_model,
                    generator=torch.Generator().manual_seed(4)).expand(
        6, 1, cfg.d_model).contiguous()
    assert TMOE.capacity(6, cfg.moe) == 5 and TMOE.capacity(1, cfg.moe) == 1
    y, _ = TMOE.moe_apply_lanes(params, x, cfg.moe, cfg.act)
    alone, _ = TMOE.moe_apply(params, x[:1], cfg.moe, cfg.act)
    for b in range(6):
        assert _rel(y[b:b + 1], alone) < 1e-6, b
    whole, _ = TMOE.moe_apply(params, x.reshape(1, 6, -1), cfg.moe, cfg.act)
    assert _rel(whole[0, -1], alone[0, 0]) > 1e-3  # the sixth lost a pair


def test_softcap_decode_raises_naming_its_item():
    from repro_torch.models import layers as TL

    dims = TL.AttnDims(d_model=16, num_heads=2, num_kv_heads=2, head_dim=8)
    params = TL.init_attention(torch.Generator().manual_seed(0), dims)
    cache = TL.init_kv_cache(1, 4, 2, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="item 2.5"):
        TL.attention_decode(params, dims, torch.zeros(1, 1, 16), cache,
                            logit_softcap=30.0)


def test_bundle_decodes_and_caches_default_to_bfloat16():
    cfg = get_reduced("minitron-4b")
    bundle = build_bundle(cfg)
    caches = bundle.init_cache(2, 8, device="cpu")
    assert caches["stage0/layer0/attn/k"].dtype == torch.bfloat16
    assert caches["index"].dtype == torch.int32
    params = port_params("minitron-4b")
    with torch.no_grad():
        logits, new = bundle.decode_step(
            params, torch.zeros(2, 1, dtype=torch.int32), caches)
    assert logits.shape == (2, 1, cfg.vocab_size)
    assert logits.dtype == torch.float32
    assert new["index"].tolist() == [1, 1]
    assert caches["index"].tolist() == [0, 0]  # the old caches stand
    assert bool(torch.isfinite(logits).all())
