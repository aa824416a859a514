"""The port's LM wire (`repro_torch.lm`: the entropy-adaptive codec on the
``topk_wire`` kernel's plain version, and the delta-compressed wrapper)
against the JAX package's, and the cases of tests/test_lm_wire.py on the
port.

Frames encoded by the two packages from the same logits are identical
array for array and byte for byte outside the lse lane, which may differ
by 2 ulp (the order of the logsumexp sum, as for the fixed codec in
tests/test_torch_wire.py); ``k_per_token`` is identical. Frames decode
across packages in both directions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import CommConfig as JCommConfig
from repro.comm import make_codec as jax_make_codec
from repro_torch.comm import CommConfig, NonFiniteError, make_codec
from repro_torch.comm.wire import DenseCodec, TopKCodec
from repro_torch.lm import (
    AdaptiveTopKCodec,
    CompressedCodec,
    adaptive_frame_max_nbytes,
    densify_adaptive,
    pack_bits,
    unpack_bits,
)
import test_torch_threads

test_torch_threads.share_cores()

for _op in (torch.exp, torch.log, torch.sqrt):
    _op(torch.ones(1))


def _window_outs(W=2, B=4, E=8, C=10, m=2, seed=0, peaked=None, scale=1.0):
    rng = np.random.default_rng(seed)
    outs = {
        "embedding": rng.normal(size=(W, B, E)).astype(np.float32),
        "logits": (rng.normal(size=(W, B, C)) * scale).astype(np.float32),
        "aux_logits": (rng.normal(size=(W, m, B, C)) * scale
                       ).astype(np.float32),
    }
    if peaked is not None:
        # the first `peaked` tokens of each window near-deterministic
        outs["logits"][:, :peaked, 0] = 30.0
    return outs


def _ids(W, B):
    return (np.arange(W * B, dtype=np.uint64).reshape(W, B) * 977) + 3


def _assert_same_frame(a, b):
    """Two decoded messages: same header, same arrays in the same order,
    byte-identical except the lse lane (within 2 ulp)."""
    assert (a.src, a.sent_step, a.t0, a.num_classes) == \
        (b.src, b.sent_step, b.t0, b.num_classes)
    assert list(a.arrays) == list(b.arrays)
    for name, x in a.arrays.items():
        y = b.arrays[name]
        assert x.dtype == y.dtype and x.shape == y.shape, name
        if name == "lse":
            np.testing.assert_allclose(x, y, rtol=2.5e-7, atol=0)
        else:
            assert x.tobytes() == y.tobytes(), name


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("exchange,budget,compression,emb,C", [
    ("prediction_adaptive", 24, "delta", "none", 512),
    ("prediction_adaptive", 24, "none", "none", 512),
    ("prediction_adaptive", 14, "none", "int8", 64),
    ("prediction_adaptive", 0, "delta", "int8", 64),
    ("prediction_topk", 0, "delta", "none", 512),
])
def test_frames_match_jax_and_decode_across(exchange, budget, compression,
                                            emb, C):
    outs = _window_outs(W=2, B=16, E=8, C=C, m=2, seed=7, peaked=4,
                        scale=3.0)
    ids = _ids(2, 16)
    kw = dict(topk=8, val_dtype="float16", emb_encoding=emb,
              budget_bytes_per_token=budget, compression=compression)
    port, ref = (make_codec(exchange, CommConfig(**kw)),
                 jax_make_codec(exchange, JCommConfig(**kw)))
    p_port = port.encode(1, 4, 4, ids, outs)
    p_ref = ref.encode(1, 4, 4, ids, outs)
    assert len(p_port) == len(p_ref)
    m_port, m_ref = port.decode(p_port), ref.decode(p_ref)
    _assert_same_frame(m_port, m_ref)
    # the tensor path gives the numpy path's bytes
    assert port.encode(1, 4, 4, ids, {k: torch.from_numpy(v)
                                      for k, v in outs.items()}) == p_port
    # across packages: each decodes the other's frame to the same arrays
    _assert_same_frame(ref.decode(p_port), m_port)
    _assert_same_frame(port.decode(p_ref), m_ref)
    d_port, d_ref = port.densify(port.decode(p_ref)), ref.densify(m_ref)
    for key in d_ref:
        np.testing.assert_array_equal(d_port[key], d_ref[key])


DEEPSEEK_VOCAB = 129_280  # deepseek-v3-671b: idx travel as u32 above 65,535


@pytest.mark.parametrize("exchange,budget,compression", [
    ("prediction_topk", 0, "none"), ("prediction_adaptive", 24, "delta")],
    ids=["fixed_topk", "adaptive_delta"])
def test_u32_frames_match_jax_at_deepseek_vocab(exchange, budget,
                                                compression):
    """The fixed top-k frame and the adaptive delta frame at deepseek-v3's
    vocabulary, where each index is a u32 (6 B an f16 entry, not 4): byte
    for byte the reference's outside the lse lane, from the numpy and the
    tensor paths, and decoded across both ways to the same arrays and
    dense teacher rows. Indices above 65,535 are on the wire."""
    outs = _window_outs(W=1, B=6, E=8, C=DEEPSEEK_VOCAB, m=2, seed=13,
                        peaked=2, scale=3.0)
    ids = _ids(1, 6)
    kw = dict(topk=8, val_dtype="float16", emb_encoding="none",
              budget_bytes_per_token=budget, compression=compression)
    port, ref = (make_codec(exchange, CommConfig(**kw)),
                 jax_make_codec(exchange, JCommConfig(**kw)))
    p_port, p_ref = port.encode(1, 4, 4, ids, outs), ref.encode(1, 4, 4, ids,
                                                                outs)
    assert len(p_port) == len(p_ref)
    assert port.encode(1, 4, 4, ids, {k: torch.from_numpy(v)
                                      for k, v in outs.items()}) == p_port
    m_port, m_ref = port.decode(p_port), ref.decode(p_ref)
    _assert_same_frame(m_port, m_ref)
    idx = m_port.arrays["idx"]
    assert idx.dtype == np.uint32 and idx.max() > 0xFFFF
    _assert_same_frame(ref.decode(p_port), m_port)
    _assert_same_frame(port.decode(p_ref), m_ref)
    d_port, d_ref = port.densify(port.decode(p_ref)), ref.densify(m_ref)
    assert d_port.keys() == d_ref.keys()
    for key in d_ref:
        np.testing.assert_array_equal(d_port[key], d_ref[key])


def test_device_graph_k_per_token_matches_jax():
    """The retention plan from the port's frame function equals the JAX
    graph's on LM-like logits (two windows of 64 tokens, vocab 512)."""
    from repro.kernels.ops import adaptive_topk_wire_frame as jax_frame
    from repro_torch.kernels import ops

    rng = np.random.default_rng(11)
    heads = (rng.normal(size=(2, 3, 64, 512)) * 2).astype(np.float32)
    heads[:, :, :8, 3] = 25.0
    kw = dict(k_min=1, budget_bytes_per_token=24, entry_bytes=4,
              val_dtype="float16")
    ref, _ = jax_frame(jnp.asarray(heads), None, 8, idx_dtype="uint16",
                       emb_encoding="none", use_pallas=False, **kw)
    out, finite = ops.adaptive_topk_wire_frame(torch.from_numpy(heads), None,
                                               8, emb_encoding="none", **kw)
    assert bool(finite)
    np.testing.assert_array_equal(out["k_per_token"].numpy(),
                                  np.asarray(ref["k_per_token"]))
    np.testing.assert_array_equal(out["idx"].numpy(), np.asarray(ref["idx"]))
    assert out["vals"].numpy().tobytes() == np.asarray(ref["vals"]).tobytes()


# ---------------------------------------------------------------------------
# the cases of tests/test_lm_wire.py, on the port
# ---------------------------------------------------------------------------

def test_unbounded_budget_is_topk_codec_bitwise():
    outs = _window_outs()
    ids = _ids(2, 4)
    fixed = TopKCodec(k=4, emb_encoding="int8")
    adap = AdaptiveTopKCodec(k=4, budget_bytes_per_token=0,
                             emb_encoding="int8")
    pf = fixed.encode(1, 5, 5, ids, outs)
    assert adap.encode(1, 5, 5, ids, outs) == pf
    dev = {k: torch.from_numpy(v) for k, v in outs.items()}
    assert adap.encode(1, 5, 5, ids, dev) == pf
    df = fixed.densify(fixed.decode(pf))
    da = adap.densify(adap.decode(pf))
    for key in df:
        np.testing.assert_array_equal(df[key], da[key])


def test_adaptive_roundtrip_budget_and_entropy_allocation():
    W, B, C, m = 2, 6, 32, 2
    outs = _window_outs(W=W, B=B, C=C, m=m, seed=1, peaked=3)
    ids = _ids(W, B)
    budget = 16
    codec = AdaptiveTopKCodec(k=8, budget_bytes_per_token=budget,
                              emb_encoding="none")
    msg = codec.decode(codec.encode(4, 9, 9, ids, outs))
    assert (msg.src, msg.sent_step, msg.t0) == (4, 9, 9)
    np.testing.assert_array_equal(msg.arrays["sample_ids"], ids)
    kt = msg.arrays["k_per_token"]
    assert kt.dtype == np.uint16 and kt.shape == (W, B)
    H, N, entry = m + 1, W * B, 2 + 2
    T = int(kt.sum())
    assert msg.arrays["vals"].shape == (H, T)
    assert msg.arrays["idx"].shape == (H, T)
    assert H * T * entry <= budget * N  # the hard budget
    flat = kt.astype(int)
    assert flat[:, :3].max() <= flat[:, 3:].min()  # entropy steering
    assert flat.min() >= 1
    dense = codec.densify(msg)
    col = np.repeat(np.arange(N), kt.reshape(-1))
    lg = dense["logits"].reshape(N, C)
    np.testing.assert_array_equal(
        lg[col, msg.arrays["idx"][0].astype(np.int64)],
        msg.arrays["vals"][0].astype(np.float32))


def test_budget_exhaustion_floors_at_k_min():
    outs = _window_outs(C=50)
    codec = AdaptiveTopKCodec(k=8, budget_bytes_per_token=1,
                              emb_encoding="none")
    msg = codec.decode(codec.encode(0, 0, 0, _ids(2, 4), outs))
    assert (msg.arrays["k_per_token"] == 1).all()
    top1 = codec.densify(msg)["logits"].argmax(-1)
    np.testing.assert_array_equal(top1.reshape(-1),
                                  msg.arrays["idx"][0].astype(np.int64))


@pytest.mark.parametrize("k,C", [(1, 10), (10, 10)])
def test_k_edges_round_trip(k, C):
    outs = _window_outs(C=C)
    codec = AdaptiveTopKCodec(k=k, budget_bytes_per_token=1000,
                              emb_encoding="none")
    msg = codec.decode(codec.encode(0, 0, 0, _ids(2, 4), outs))
    assert msg.arrays["idx"].dtype == np.uint16
    dense = codec.densify(msg)
    if k == C:  # full k: lossless up to the f16 values
        np.testing.assert_allclose(dense["logits"], outs["logits"],
                                   rtol=1e-3, atol=1e-3)


def test_forced_u32_vocab():
    C = 2 ** 16 + 7
    outs = _window_outs(W=1, B=2, C=C, m=1, seed=1)
    outs["logits"][..., C - 3] = 100.0  # winner beyond u16 range
    codec = AdaptiveTopKCodec(k=4, budget_bytes_per_token=12,
                              emb_encoding="none")
    msg = codec.decode(codec.encode(0, 0, 0, _ids(1, 2), outs))
    assert msg.arrays["idx"].dtype == np.uint32
    kt = msg.arrays["k_per_token"].reshape(-1).astype(np.int64)
    col0 = np.concatenate([[0], np.cumsum(kt)[:-1]])
    assert (msg.arrays["idx"][0][col0] == C - 3).all()


@pytest.mark.parametrize("poison", ["logits", "aux_logits"])
@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_adaptive_rejects_non_finite(poison, bad):
    outs = _window_outs()
    outs[poison].flat[outs[poison].size // 2] = bad
    codec = AdaptiveTopKCodec(k=4, budget_bytes_per_token=8,
                              emb_encoding="none")
    for o in (outs, {k: torch.from_numpy(v) for k, v in outs.items()}):
        with pytest.raises(NonFiniteError, match="non-finite"):
            codec.encode(0, 0, 0, _ids(2, 4), o)


def test_adaptive_rejects_f16_overflow():
    outs = _window_outs()
    outs["logits"][0, 0, 0] = 1e5
    codec = AdaptiveTopKCodec(k=4, budget_bytes_per_token=8,
                              val_dtype="float16", emb_encoding="none")
    with pytest.raises(NonFiniteError):
        codec.encode(0, 0, 0, _ids(2, 4), outs)
    AdaptiveTopKCodec(k=4, budget_bytes_per_token=8, val_dtype="float32",
                      emb_encoding="none").encode(0, 0, 0, _ids(2, 4), outs)


def test_densify_adaptive_preserves_lse_and_confidence():
    rng = np.random.default_rng(2)
    W, H, N, C = 1, 1, 6, 40
    logits = (rng.normal(size=(N, C)) * 3).astype(np.float32)
    kt = np.array([[1, 2, 3, 5, 8, 40]], np.uint16)
    order = np.argsort(-logits, axis=-1, kind="stable")
    vals = np.concatenate([logits[i, order[i, :k]]
                           for i, k in enumerate(kt.reshape(-1))])[None]
    idx = np.concatenate([order[i, :k]
                          for i, k in enumerate(kt.reshape(-1))])[None]
    lse = torch.logsumexp(torch.from_numpy(logits), -1).numpy()
    recon = densify_adaptive(vals, idx, lse.reshape(W, H, N), kt,
                             C).reshape(N, C)
    np.testing.assert_allclose(
        torch.logsumexp(torch.from_numpy(recon), -1).numpy(), lse,
        rtol=1e-5)
    p = torch.softmax(torch.from_numpy(recon), -1).numpy()
    p_true = torch.softmax(torch.from_numpy(logits), -1).numpy()
    np.testing.assert_allclose(p.max(-1), p_true.max(-1), rtol=1e-5)


@pytest.mark.parametrize("budget", [4, 12, 24, 48])
def test_adaptive_frame_max_nbytes_is_a_ceiling(budget):
    W, B, C, m = 2, 8, 64, 2
    outs = _window_outs(W=W, B=B, C=C, m=m, E=16)
    codec = AdaptiveTopKCodec(k=8, budget_bytes_per_token=budget,
                              emb_encoding="int8")
    p = codec.encode(0, 0, 0, _ids(W, B), outs)
    assert len(p) <= adaptive_frame_max_nbytes(W, B, B, m + 1, budget,
                                               emb_dim=16)


@pytest.mark.parametrize("width", [1, 3, 7, 11, 17, 32])
def test_pack_bits_roundtrip(width):
    v = np.random.default_rng(0).integers(0, 2 ** width, size=101,
                                          dtype=np.uint64)
    packed = pack_bits(v, width)
    assert packed.dtype == np.uint8
    assert len(packed) == (101 * width + 7) // 8
    np.testing.assert_array_equal(unpack_bits(packed, 101, width), v)


@pytest.mark.parametrize("inner", [
    lambda: AdaptiveTopKCodec(k=6, budget_bytes_per_token=14,
                              emb_encoding="int8"),
    lambda: AdaptiveTopKCodec(k=6, budget_bytes_per_token=0,
                              emb_encoding="int8"),
    lambda: TopKCodec(k=6, emb_encoding="int8"),
], ids=["adaptive", "adaptive_unbounded", "fixed"])
def test_compressed_codec_is_decode_exact(inner):
    outs = _window_outs(C=64, seed=5)
    ids = _ids(2, 4)
    raw, comp = inner(), CompressedCodec(inner())
    m_raw = raw.decode(raw.encode(3, 11, 11, ids, outs))
    m_comp = comp.decode(comp.encode(3, 11, 11, ids, outs))
    assert set(m_raw.arrays) == set(m_comp.arrays)
    for key in m_raw.arrays:
        np.testing.assert_array_equal(m_raw.arrays[key], m_comp.arrays[key])
        assert m_raw.arrays[key].dtype == m_comp.arrays[key].dtype
    d_raw, d_comp = raw.densify(m_raw), comp.densify(m_comp)
    for key in d_raw:
        np.testing.assert_array_equal(d_raw[key], d_comp[key])


def test_compression_off_and_dense_passthrough():
    outs = _window_outs()
    ids = _ids(2, 4)
    codec = make_codec("prediction_topk", CommConfig(topk=5))
    assert isinstance(codec, TopKCodec)
    assert codec.encode(0, 0, 0, ids, outs) == \
        TopKCodec(k=5).encode(0, 0, 0, ids, outs)
    inner = DenseCodec(logit_dtype="float32", emb_encoding="float32")
    comp = CompressedCodec(DenseCodec(logit_dtype="float32",
                                      emb_encoding="float32"))
    p = comp.encode(0, 0, 0, ids, outs)
    assert p == inner.encode(0, 0, 0, ids, outs)
    np.testing.assert_array_equal(comp.decode(p).arrays["heads"],
                                  inner.decode(p).arrays["heads"])


def test_compressed_u32_index_stream():
    C = 2 ** 16 + 7
    outs = _window_outs(W=1, B=3, C=C, m=1, seed=2)
    ids = _ids(1, 3)
    raw = AdaptiveTopKCodec(k=4, budget_bytes_per_token=18,
                            emb_encoding="none")
    comp = CompressedCodec(AdaptiveTopKCodec(k=4, budget_bytes_per_token=18,
                                             emb_encoding="none"))
    m_raw = raw.decode(raw.encode(0, 0, 0, ids, outs))
    m_comp = comp.decode(comp.encode(0, 0, 0, ids, outs))
    assert m_comp.arrays["idx"].dtype == np.uint32
    np.testing.assert_array_equal(m_raw.arrays["idx"], m_comp.arrays["idx"])


def test_make_codec_dispatch_and_validation():
    codec = make_codec("prediction_adaptive", CommConfig(
        topk=7, budget_bytes_per_token=20, compression="delta"))
    assert isinstance(codec, CompressedCodec)
    assert isinstance(codec.inner, AdaptiveTopKCodec)
    assert codec.inner.k == 7 and codec.inner.budget == 20
    with pytest.raises(ValueError, match="compression"):
        make_codec("prediction_topk", CommConfig(compression="gzip"))
