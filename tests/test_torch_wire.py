"""The port's wire (repro_torch.comm.wire) against the JAX package's
``repro.comm``: from the same logits the frames are byte-identical, each
package decodes the other's frames, and the codecs refuse the same inputs.

Each encode path is covered: the port's numpy host path, its tensor path
(the fused frame encode, here on the topk_wire kernel's plain version) and
the JAX package's numpy and device paths. Where the two frameworks' lse
lane differs (the order of the logsumexp sum), every other byte is
identical and the lse is within 2 ulp.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.comm as RC
import repro_torch.comm as TC
from repro_torch.comm import wire as TW

# PyTorch's CPU build picks each vectorized math kernel at its first call,
# and a first call spread over several threads was seen to compute
# exp / log / sqrt with another variant (up to 1e-4 relative, 37 ulp on a
# logsumexp). One single-element call of each, made while pytest collects
# this file, settles the choice for the whole process.
for _op in (torch.exp, torch.log, torch.sqrt):
    _op(torch.ones(1))

W, M, B, C, E = 2, 2, 4, 50, 8


def _outs(seed=0, C=C, scale=3.0):
    rng = np.random.default_rng(seed)
    return {"embedding": rng.normal(size=(W, B, E)).astype(np.float32),
            "logits": (rng.normal(size=(W, B, C)) * scale).astype(np.float32),
            "aux_logits": (rng.normal(size=(W, M, B, C))
                           * scale).astype(np.float32)}


def _ids():
    return (np.arange(W * B, dtype=np.uint64).reshape(W, B) * 7919) + 3


def _assert_same_frame(port: bytes, ref: bytes):
    """Byte-identical, or identical outside an lse lane within 2 ulp."""
    if port == ref:
        return
    assert len(port) == len(ref)
    pm, rm = TC.TopKCodec(1).decode(port), RC.TopKCodec(1).decode(ref)
    assert list(pm.arrays) == list(rm.arrays)
    for name in rm.arrays:
        if name == "lse":
            np.testing.assert_array_max_ulp(pm.arrays[name], rm.arrays[name],
                                            maxulp=2)
        else:
            assert pm.arrays[name].tobytes() == rm.arrays[name].tobytes(), \
                name
    assert port[:40] == ref[:40]


CODECS = [
    ("k8_f16_int8", dict(k=8, val_dtype="float16", emb_encoding="int8")),
    ("k8_f32_f32", dict(k=8, val_dtype="float32", emb_encoding="float32")),
    ("k5_f16_none", dict(k=5, val_dtype="float16", emb_encoding="none")),
    ("k=C", dict(k=C, val_dtype="float32", emb_encoding="int8")),
    ("k>C", dict(k=C + 7, val_dtype="float16", emb_encoding="int8")),
]


@pytest.mark.parametrize("name,kw", CODECS, ids=[c[0] for c in CODECS])
def test_topk_frames_byte_identical_to_reference(name, kw):
    outs = _outs()
    ref_np = RC.TopKCodec(**kw).encode(1, 4, 4, _ids(), outs)
    ref_dev = RC.TopKCodec(**kw).encode(
        1, 4, 4, _ids(), {k: jnp.asarray(v) for k, v in outs.items()})
    codec = TC.TopKCodec(**kw)
    port_np = codec.encode(1, 4, 4, _ids(), outs)
    port_t = codec.encode(1, 4, 4, _ids(),
                          {k: torch.from_numpy(v) for k, v in outs.items()})
    assert ref_np == ref_dev
    _assert_same_frame(port_np, ref_np)
    _assert_same_frame(port_t, ref_np)


@pytest.mark.parametrize("name,kw", CODECS, ids=[c[0] for c in CODECS])
def test_frames_decode_across_packages(name, kw):
    """Each package turns the other's bytes into the same dense teacher
    outputs as the writer's own decoder does, bit for bit."""
    outs = _outs(1)
    ref_codec, port_codec = RC.TopKCodec(**kw), TC.TopKCodec(**kw)
    for frame in (ref_codec.encode(0, 2, 2, _ids(), outs),
                  port_codec.encode(0, 2, 2, _ids(), outs)):
        in_port = port_codec.densify(port_codec.decode(frame))
        in_ref = ref_codec.densify(ref_codec.decode(frame))
        assert in_port.keys() == in_ref.keys()
        for k in in_ref:
            np.testing.assert_array_equal(in_port[k], in_ref[k])
    msg = port_codec.decode(ref_codec.encode(5, 6, 7, _ids(), outs))
    assert (msg.src, msg.sent_step, msg.t0, msg.num_classes) == (5, 6, 7, C)
    np.testing.assert_array_equal(msg.arrays["sample_ids"], _ids())


def test_dense_frames_byte_identical_and_cross_decode():
    outs = _outs(2)
    for kw in (dict(), dict(logit_dtype="float16", emb_encoding="int8")):
        ref = RC.DenseCodec(**kw).encode(0, 0, 0, _ids(), outs)
        port = TC.DenseCodec(**kw).encode(0, 0, 0, _ids(), outs)
        assert port == ref
        port_t = TC.DenseCodec(**kw).encode(
            0, 0, 0, _ids(), {k: torch.from_numpy(v) for k, v in outs.items()})
        assert port_t == ref
        d = TC.DenseCodec(**kw)
        got = d.densify(d.decode(ref))
        np.testing.assert_array_equal(got["logits"],
                                      RC.DenseCodec(**kw).densify(
                                          RC.DenseCodec(**kw).decode(ref))
                                      ["logits"])


def test_forced_u32_indices_for_large_vocab():
    C_big = 70_000
    rng = np.random.default_rng(3)
    outs = {"logits": rng.normal(size=(1, 2, C_big)).astype(np.float32),
            "aux_logits": rng.normal(size=(1, 1, 2, C_big)).astype(
                np.float32)}
    ids = np.arange(2, dtype=np.uint64).reshape(1, 2)
    ref = RC.TopKCodec(4, emb_encoding="none").encode(0, 0, 0, ids, outs)
    port_t = TC.TopKCodec(4, emb_encoding="none").encode(
        0, 0, 0, ids, {k: torch.from_numpy(v) for k, v in outs.items()})
    _assert_same_frame(port_t, ref)
    msg = TC.TopKCodec(4).decode(port_t)
    assert msg.arrays["idx"].dtype == np.dtype("<u4")


@pytest.mark.parametrize("path", ["numpy", "tensor"])
@pytest.mark.parametrize("poison", ["nan_logit", "inf_aux", "nan_emb",
                                    "f16_overflow"])
def test_non_finite_and_f16_overflow_rejected(path, poison):
    outs = _outs(4)
    if poison == "nan_logit":
        outs["logits"][0, 1, 3] = np.nan
    elif poison == "inf_aux":
        outs["aux_logits"][1, 0, 2, 5] = np.inf
    elif poison == "nan_emb":
        outs["embedding"][1, 2, 0] = np.nan
    else:  # finite in f32, beyond ±65504 in the f16 wire cast
        outs["logits"][0, 0, 0] = 1e5
    with pytest.raises(RC.NonFiniteError):
        RC.TopKCodec(8).encode(0, 0, 0, _ids(), outs)
    given = outs if path == "numpy" else {
        k: torch.from_numpy(v) for k, v in outs.items()}
    with pytest.raises(TC.NonFiniteError):
        TC.TopKCodec(8).encode(0, 0, 0, _ids(), given)


def test_int8_embedding_lane_is_bit_exact():
    emb = np.random.default_rng(5).normal(size=(3, 7, 33)).astype(np.float32)
    emb[0, 0] = 0.0  # all-zero row: scale is 1e-30, q stays 0
    q, scale = TW.quantize_emb_int8(emb)
    from repro.comm.wire import quantize_emb_int8
    rq, rscale = quantize_emb_int8(emb)
    assert q.tobytes() == rq.tobytes() and scale.tobytes() == rscale.tobytes()
    from repro_torch.kernels import ops
    heads = torch.zeros(3, 1, 7, 4)
    arrays, finite = ops.topk_wire_frame(heads, torch.from_numpy(emb), 2)
    assert bool(finite)
    assert arrays["emb_q"].numpy().tobytes() == rq.tobytes()
    assert arrays["emb_scale"].numpy().tobytes() == rscale.tobytes()


def test_densify_and_byte_accounting_match_reference():
    from repro.comm.wire import densify_topk as rd
    rng = np.random.default_rng(6)
    vals = -np.sort(-rng.normal(size=(3, 5)).astype(np.float32), axis=-1)
    idx = np.stack([rng.permutation(20)[:5] for _ in range(3)])
    lse = np.full(3, 3.0, np.float32)
    for tail in ("uniform", "drop"):
        np.testing.assert_array_equal(
            TC.densify_topk(vals, idx, lse, 20, tail),
            rd(vals, idx, lse, 20, tail))
    kw = dict(batch=32, k=32, num_heads=5, emb_dim=512, val_bytes=2,
              idx_bytes=2, lse_bytes=4)
    assert TC.topk_frame_nbytes(**kw) == RC.topk_frame_nbytes(**kw)
    assert TC.dense_frame_nbytes(32, 1000, 5) == RC.dense_frame_nbytes(
        32, 1000, 5)
    payload = TC.TopKCodec(8).encode(0, 0, 0, _ids(), _outs())
    assert len(payload) == W * TC.topk_frame_nbytes(
        B, 8, num_heads=M + 1, emb_dim=E, val_bytes=2, idx_bytes=2,
        lse_bytes=4) + TC.frame_overhead_nbytes(
        {"sample_ids": 2, "vals": 4, "idx": 4, "lse": 3, "emb_q": 3,
         "emb_scale": 2})
