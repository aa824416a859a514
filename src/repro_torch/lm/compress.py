"""Window compression for prediction frames (a copy of
``repro/lm/compress.py``: numpy only).

`CompressedCodec` wraps ANY inner prediction codec: it encodes through
the inner codec, then rewrites the frame's index stream — the one array
whose values are small integers with heavy structure — as

  1. an XOR delta: consecutive windows of a rectangular top-k frame
     (axis 0), or consecutive entries of an adaptive frame's packed
     per-head stream (last axis). XOR (not subtraction) keeps the
     transform closed over the unsigned wire dtypes — bijective, so the
     decode is exact by construction.
  2. a fixed-width bit-pack: the delta stream is stored at the minimal
     bit width that holds its maximum value (e.g. a 512-vocab fleet's
     u16 indices travel at <= 10 bits after the delta).

The rewritten frame is re-serialized under codec_id 4 with the original
"idx" replaced in place by "idx_meta" (inner codec id, dtype, bit
width, delta axis, shape) + "idx_bits" (the packed bytes), preserving
array order; every other array is untouched. ``decode`` reconstructs
the inner frame bit-for-bit and ``densify`` delegates to the inner
codec — compression is invisible above the wire, visible only in the
`CommMeter` ledger.

Anchors: compression "none" never constructs this wrapper (today's
frames, byte-for-byte — see `repro_torch.comm.make_codec`); an inner frame
without an index stream (dense layout) passes through unchanged, and
``decode`` accepts such passthrough frames via the inner codec.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.comm.wire import (_DTYPES, _DTYPE_CODES, Codec,
                             PredictionMessage, _deserialize, _serialize)


def pack_bits(values: np.ndarray, width: int) -> np.ndarray:
    """Pack non-negative integers into a little-endian bitstream of
    ``width`` bits each. Returns a u8 array of ceil(n*width/8) bytes."""
    v = np.ascontiguousarray(values, np.uint64).reshape(-1)
    if v.size == 0:
        return np.zeros(0, np.uint8)
    shifts = np.arange(width, dtype=np.uint64)
    bits = ((v[:, None] >> shifts[None, :]) & np.uint64(1)).astype(
        np.uint8)
    return np.packbits(bits.reshape(-1), bitorder="little")


def unpack_bits(packed: np.ndarray, count: int, width: int) -> np.ndarray:
    """Inverse of `pack_bits`: the first ``count`` ``width``-bit values."""
    if count == 0:
        return np.zeros(0, np.uint64)
    bits = np.unpackbits(np.asarray(packed, np.uint8),
                         count=count * width,
                         bitorder="little").reshape(count, width)
    shifts = np.arange(width, dtype=np.uint64)
    return (bits.astype(np.uint64) << shifts[None, :]).sum(
        axis=1, dtype=np.uint64)


def _xor_delta(idx: np.ndarray, axis: int) -> np.ndarray:
    out = idx.copy()
    head = [slice(None)] * idx.ndim
    tail = [slice(None)] * idx.ndim
    head[axis] = slice(1, None)
    tail[axis] = slice(0, -1)
    out[tuple(head)] = idx[tuple(head)] ^ idx[tuple(tail)]
    return out


class CompressedCodec(Codec):
    """Delta + bit-pack the index stream of an inner prediction codec."""

    codec_id = 4

    def __init__(self, inner: Codec):
        self.inner = inner
        self.emb_encoding = getattr(inner, "emb_encoding", "none")

    def encode(self, src, sent_step, t0, sample_ids, outs) -> bytes:
        payload = self.inner.encode(src, sent_step, t0, sample_ids, outs)
        msg, inner_id = _deserialize(payload)
        idx = msg.arrays.get("idx")
        if idx is None:  # no index stream (dense frame): passthrough
            return payload
        # rectangular frames delta across the window (axis 0);
        # adaptive packed streams delta along each head's stream
        axis = 0 if idx.ndim >= 3 else idx.ndim - 1
        delta = _xor_delta(idx, axis)
        width = max(1, int(delta.max()).bit_length()) if delta.size else 1
        dt = np.dtype(idx.dtype.newbyteorder("<"))
        arrays: Dict[str, np.ndarray] = {}
        for name, arr in msg.arrays.items():
            if name != "idx":
                arrays[name] = arr
                continue
            arrays["idx_meta"] = np.array(
                [inner_id, _DTYPE_CODES[dt], width, axis, idx.ndim]
                + list(idx.shape), "<u4")
            arrays["idx_bits"] = pack_bits(delta, width)
        return _serialize(
            PredictionMessage(msg.src, msg.sent_step, msg.t0,
                              msg.num_classes, arrays), self.codec_id)

    def decode(self, payload: bytes) -> PredictionMessage:
        head, codec_id = _deserialize(payload)
        if codec_id != self.codec_id:
            # an uncompressed passthrough frame: the inner codec owns it
            return self.inner.decode(payload)
        meta = np.asarray(head.arrays["idx_meta"], np.int64)
        inner_id, dt_code, width, axis, ndim = (int(v) for v in meta[:5])
        shape = tuple(int(v) for v in meta[5:5 + ndim])
        count = int(np.prod(shape)) if ndim else 1
        delta = unpack_bits(head.arrays["idx_bits"], count,
                            width).astype(_DTYPES[dt_code]).reshape(shape)
        idx = np.bitwise_xor.accumulate(delta, axis=axis)
        arrays: Dict[str, np.ndarray] = {}
        for name, arr in head.arrays.items():
            if name == "idx_meta":
                arrays["idx"] = idx
            elif name != "idx_bits":
                arrays[name] = arr
        return PredictionMessage(head.src, head.sent_step, head.t0,
                                 head.num_classes, arrays)

    def densify(self, msg: PredictionMessage) -> Dict[str, np.ndarray]:
        return self.inner.densify(msg)
