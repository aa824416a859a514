"""Wire codecs for teacher predictions (port of ``repro/comm/wire.py``).

The MHDW format is framework-free: raw little-endian arrays behind a
fixed header. Frames written here are byte-identical to the JAX package's
and decode there, and the other way round (tests/test_torch_wire.py).

`TopKCodec.encode` dispatches on what it is given:
  * a CUDA tensor → the fused device encode (`kernels.ops.topk_wire_frame`
    on the ``topk_wire`` kernel): only wire-dtype arrays reach the host;
  * a CPU tensor → the same encode, on the kernel's plain version;
  * numpy → the host path (`TopKCodec._pack`), as in the reference.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs import tracer as trace

_MAGIC = b"MHDW"
_VERSION = 1
_HEADER_BYTES = 4 + 4 + 32  # magic + <BBH> + <qqqq>

# dtype codes used in the array header (wire is always little-endian)
_DTYPES = {
    0: np.dtype("<f4"),
    1: np.dtype("<f2"),
    2: np.dtype("<i4"),
    3: np.dtype("<u2"),
    4: np.dtype("<i1"),
    5: np.dtype("<u8"),
    6: np.dtype("<u4"),
    7: np.dtype("<u1"),
}
_DTYPE_CODES = {v: k for k, v in _DTYPES.items()}


class NonFiniteError(ValueError):
    """Raised when a codec refuses to put NaN/±inf on the wire."""


def _check_finite(name: str, arr: np.ndarray) -> None:
    """Codecs refuse to put NaN/±inf on the wire: a diverged teacher would
    poison every student that decodes it. Checked on the wire-dtype arrays
    as well as the inputs — a finite f32 logit beyond ±65504 overflows to
    inf in an f16 cast."""
    if not np.all(np.isfinite(arr)):
        raise NonFiniteError(
            f"non-finite values in {name!r}: refusing to encode")


def _to_numpy(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# dense reconstruction
# ---------------------------------------------------------------------------

def densify_topk(vals: np.ndarray, idx: np.ndarray, lse: np.ndarray,
                 num_classes: int, tail: str = "uniform") -> np.ndarray:
    """Reconstruct dense logits from a (vals, idx, lse) pack.

    tail="uniform": the truncated probability mass exp(lse)−Σexp(vals) is
    spread uniformly over the non-retained classes, so logsumexp(recon) ==
    lse and the top-1 confidence Λ stays exact. tail="drop": non-retained
    classes get −1e30. With k == num_classes both are exact.
    """
    vals = np.asarray(vals, np.float32)
    idx = np.asarray(idx, np.int64)
    lse = np.asarray(lse, np.float32)
    k = vals.shape[-1]
    lead = vals.shape[:-1]
    if tail == "drop" or k >= num_classes:
        fill = np.full(lead + (1,), -1e30, np.float32)
    else:
        retained = np.exp(vals - lse[..., None]).sum(axis=-1)
        tail_mass = np.clip(1.0 - retained, 1e-30, None)
        fill = (lse + np.log(tail_mass / (num_classes - k)))[..., None]
    out = np.broadcast_to(fill, lead + (num_classes,)).copy()
    np.put_along_axis(out, idx, vals, axis=-1)
    return out


# ---------------------------------------------------------------------------
# embedding quantization
# ---------------------------------------------------------------------------

def quantize_emb_int8(emb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-vector int8: q = round(x·127/max|x|). Returns (q, scale)
    with scale shaped like emb without its last axis."""
    emb = np.asarray(emb, np.float32)
    amax = np.max(np.abs(emb), axis=-1)
    scale = (amax / 127.0 + 1e-30).astype(np.float32)
    q = np.clip(np.rint(emb / scale[..., None]), -127, 127).astype(np.int8)
    return q, scale


def dequantize_emb_int8(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return q.astype(np.float32) * np.asarray(scale, np.float32)[..., None]


# ---------------------------------------------------------------------------
# message + raw-array serialization
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PredictionMessage:
    """One client's predictions for public steps [t0, t0 + W).

    arrays: sample_ids (W, B) u64 plus either packed {vals/idx/lse} or
    dense head logits, and an optional (possibly quantized) embedding.
    """
    src: int
    sent_step: int
    t0: int
    num_classes: int
    arrays: Dict[str, np.ndarray]

    @property
    def window(self) -> int:
        return int(self.arrays["sample_ids"].shape[0])


def frame_overhead_nbytes(arrays: Dict[str, int]) -> int:
    """Header bytes of a serialized message holding arrays of the given
    ``{name: ndim}``: the fixed header plus each array's name, dtype code,
    rank and shape."""
    return _HEADER_BYTES + sum(1 + len(name.encode()) + 2 + 8 * ndim
                               for name, ndim in arrays.items())


def _serialize(msg: PredictionMessage, codec_id: int) -> bytes:
    """One preallocated buffer: headers via ``pack_into``, each array's
    payload copied once, dtype-converted in place."""
    t0 = trace.now()
    pending = []
    total = _HEADER_BYTES
    for name, arr in msg.arrays.items():
        arr = np.ascontiguousarray(arr)
        dt = np.dtype(arr.dtype.newbyteorder("<"))
        nm = name.encode()
        total += 1 + len(nm) + 2 + 8 * arr.ndim + arr.size * dt.itemsize
        pending.append((nm, arr, dt))
    buf = bytearray(total)
    buf[0:4] = _MAGIC
    struct.pack_into("<BBH", buf, 4, _VERSION, codec_id, len(pending))
    struct.pack_into("<qqqq", buf, 8, msg.src, msg.sent_step, msg.t0,
                     msg.num_classes)
    off = _HEADER_BYTES
    for nm, arr, dt in pending:
        struct.pack_into("<B", buf, off, len(nm))
        off += 1
        buf[off:off + len(nm)] = nm
        off += len(nm)
        struct.pack_into("<BB", buf, off, _DTYPE_CODES[dt], arr.ndim)
        off += 2
        struct.pack_into(f"<{arr.ndim}q", buf, off, *arr.shape)
        off += 8 * arr.ndim
        nbytes = arr.size * dt.itemsize
        np.frombuffer(buf, dtype=np.uint8, count=nbytes, offset=off)[:] = \
            arr.astype(dt, copy=False).reshape(-1).view(np.uint8)
        off += nbytes
    payload = bytes(buf)
    trace.complete("wire/serialize", t0, src=msg.src, nbytes=len(payload))
    return payload


def _deserialize(payload: bytes) -> Tuple[PredictionMessage, int]:
    t_start = trace.now()
    if payload[:4] != _MAGIC:
        raise ValueError("not a MHDW prediction message")
    ver, codec_id, n_arrays = struct.unpack_from("<BBH", payload, 4)
    if ver != _VERSION:
        raise ValueError(f"wire version {ver} != {_VERSION}")
    src, sent_step, t0, num_classes = struct.unpack_from("<qqqq", payload, 8)
    off = _HEADER_BYTES
    arrays: Dict[str, np.ndarray] = {}
    for _ in range(n_arrays):
        (nlen,) = struct.unpack_from("<B", payload, off)
        off += 1
        name = payload[off:off + nlen].decode()
        off += nlen
        code, ndim = struct.unpack_from("<BB", payload, off)
        off += 2
        shape = struct.unpack_from(f"<{ndim}q", payload, off)
        off += 8 * ndim
        dt = _DTYPES[code]
        count = int(np.prod(shape))
        arrays[name] = np.frombuffer(payload, dtype=dt, count=count,
                                     offset=off).reshape(shape)
        off += count * dt.itemsize
    trace.complete("wire/deserialize", t_start, src=int(src),
                   nbytes=len(payload))
    return PredictionMessage(int(src), int(sent_step), int(t0),
                             int(num_classes), arrays), codec_id


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

def _stack_heads(outs: Dict[str, Any]) -> np.ndarray:
    """{"logits": (W,B,C), "aux_logits": (W,m,B,C)} -> (W,H,B,C), H=m+1."""
    main = _to_numpy(outs["logits"])[:, None]
    aux = _to_numpy(outs["aux_logits"])
    return np.concatenate([main, aux], axis=1)


def _split_heads(heads: np.ndarray) -> Dict[str, np.ndarray]:
    return {"logits": heads[:, 0], "aux_logits": heads[:, 1:]}


class Codec:
    """encode: window outputs -> bytes; decode: bytes -> message;
    densify: message -> dense window outputs (the student-side view)."""

    codec_id: int = 0
    emb_encoding: str = "none"

    def encode(self, src: int, sent_step: int, t0: int,
               sample_ids: np.ndarray, outs: Dict[str, Any]) -> bytes:
        raise NotImplementedError

    def decode(self, payload: bytes) -> PredictionMessage:
        msg, codec_id = _deserialize(payload)
        if codec_id != self.codec_id:
            raise ValueError(
                f"payload codec id {codec_id} != {self.codec_id}")
        return msg

    def densify(self, msg: PredictionMessage) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def _encode_emb(self, arrays: Dict[str, np.ndarray],
                    outs: Dict[str, Any]) -> None:
        if self.emb_encoding == "none" or "embedding" not in outs:
            return
        emb = _to_numpy(outs["embedding"])
        _check_finite("embedding", emb)
        if self.emb_encoding == "int8":
            q, scale = quantize_emb_int8(emb)
            arrays["emb_q"] = q
            arrays["emb_scale"] = scale
        else:
            arrays["embedding"] = emb

    def _decode_emb(self, msg: PredictionMessage) -> Optional[np.ndarray]:
        if "embedding" in msg.arrays:
            return np.asarray(msg.arrays["embedding"], np.float32)
        if "emb_q" in msg.arrays:
            return dequantize_emb_int8(msg.arrays["emb_q"],
                                       msg.arrays["emb_scale"])
        return None


class DenseCodec(Codec):
    """Full-vocab logits per head — the naive wire layout."""

    codec_id = 1

    def __init__(self, logit_dtype: str = "float32",
                 emb_encoding: str = "float32"):
        self.logit_dtype = np.dtype("<f2" if logit_dtype == "float16"
                                    else "<f4")
        self.emb_encoding = emb_encoding

    def encode(self, src, sent_step, t0, sample_ids, outs) -> bytes:
        arrays: Dict[str, np.ndarray] = {
            "sample_ids": np.asarray(sample_ids, np.uint64)}
        heads = _stack_heads(outs)
        _check_finite("logits", heads)
        with np.errstate(over="ignore"):  # _check_finite reports overflow
            arrays["heads"] = heads.astype(self.logit_dtype)
        if arrays["heads"].dtype.itemsize < 4:  # f16: catch overflow → inf
            _check_finite("logits (f16 wire cast)", arrays["heads"])
        self._encode_emb(arrays, outs)
        C = int(outs["logits"].shape[-1])
        return _serialize(PredictionMessage(src, sent_step, t0, C, arrays),
                          self.codec_id)

    def densify(self, msg: PredictionMessage) -> Dict[str, np.ndarray]:
        out = _split_heads(np.asarray(msg.arrays["heads"], np.float32))
        emb = self._decode_emb(msg)
        if emb is not None:
            out["embedding"] = emb
        return out


class TopKCodec(Codec):
    """Top-k packed heads: (vals, idx, lse) per head per sample.

    idx travels as u16 whenever the class count fits (vocab ≤ 65535),
    else u32; vals as f16 or f32. Densify spreads the truncated tail mass
    uniformly so confidence stays exact (see `densify_topk`).
    """

    codec_id = 2

    def __init__(self, k: int, val_dtype: str = "float16",
                 emb_encoding: str = "int8", tail: str = "uniform"):
        self.k = int(k)
        self.val_dtype = np.dtype("<f2" if val_dtype == "float16"
                                  else "<f4")
        self.emb_encoding = emb_encoding
        self.tail = tail

    @staticmethod
    def _idx_dtype(C: int) -> np.dtype:
        # u16 while the vocab fits, u32 beyond (vocab ≥ 2**16 — LLM heads)
        return np.dtype("<u2") if C <= 0xFFFF else np.dtype("<u4")

    def _pack(self, heads: np.ndarray) -> Dict[str, np.ndarray]:
        from repro_torch.kernels import ops

        W, H, B, C = heads.shape
        k = min(self.k, C)
        vals, idx, lse = ops.topk_wire(
            torch.from_numpy(np.ascontiguousarray(heads)).reshape(
                W * H * B, C), k)
        with np.errstate(over="ignore"):  # _check_finite reports overflow
            wire_vals = vals.numpy().reshape(W, H, B, k).astype(
                self.val_dtype)
        if wire_vals.dtype.itemsize < 4:  # f16: catch overflow → inf
            _check_finite("vals (f16 wire cast)", wire_vals)
        return {
            "vals": wire_vals,
            "idx": idx.numpy().reshape(W, H, B, k).astype(
                self._idx_dtype(C)),
            "lse": lse.numpy().astype(np.float32).reshape(W, H, B),
        }

    def encode(self, src, sent_step, t0, sample_ids, outs) -> bytes:
        if isinstance(outs.get("logits"), torch.Tensor):
            return self._encode_device(src, sent_step, t0, sample_ids, outs)
        arrays: Dict[str, np.ndarray] = {
            "sample_ids": np.asarray(sample_ids, np.uint64)}
        heads = _stack_heads(outs)
        _check_finite("logits", heads)
        arrays.update(self._pack(heads))
        self._encode_emb(arrays, outs)
        C = int(outs["logits"].shape[-1])
        return _serialize(PredictionMessage(src, sent_step, t0, C, arrays),
                          self.codec_id)

    def _encode_device(self, src, sent_step, t0, sample_ids, outs) -> bytes:
        """Fused encode for tensors (`kernels.ops.topk_wire_frame`): head
        stacking, top-k, wire casts, int8 embedding quantization and the
        finiteness check on the tensors' device — byte-identical payloads
        to the numpy path, with only wire-dtype arrays copied to the
        host."""
        from repro_torch.kernels import ops

        heads = torch.cat([outs["logits"].float()[:, None],
                           outs["aux_logits"].float()], dim=1)
        C = int(heads.shape[-1])
        k = min(self.k, C)
        emb = outs.get("embedding") if self.emb_encoding != "none" else None
        dev, finite = ops.topk_wire_frame(
            heads, emb, k,
            val_dtype="float16" if self.val_dtype.itemsize == 2
            else "float32",
            emb_encoding=self.emb_encoding)
        if not bool(finite):
            raise NonFiniteError(
                "non-finite values in prediction outputs (or their f16 "
                "wire cast): refusing to encode")
        # insertion order matches the numpy path (sample_ids, vals, idx,
        # lse, emb_q, emb_scale) so payloads stay byte-identical
        arrays: Dict[str, np.ndarray] = {
            "sample_ids": np.asarray(sample_ids, np.uint64)}
        for name in ("vals", "idx", "lse", "emb_q", "emb_scale",
                     "embedding"):
            if name in dev:
                arrays[name] = dev[name].cpu().numpy()
        arrays["idx"] = arrays["idx"].astype(self._idx_dtype(C))
        return _serialize(PredictionMessage(src, sent_step, t0, C, arrays),
                          self.codec_id)

    def densify(self, msg: PredictionMessage) -> Dict[str, np.ndarray]:
        heads = densify_topk(msg.arrays["vals"],
                             msg.arrays["idx"].astype(np.int64),
                             msg.arrays["lse"], msg.num_classes,
                             tail=self.tail)
        out = _split_heads(heads)
        emb = self._decode_emb(msg)
        if emb is not None:
            out["embedding"] = emb
        return out


# ---------------------------------------------------------------------------
# byte accounting
# ---------------------------------------------------------------------------

def topk_frame_nbytes(batch: int, k: int, num_heads: int = 1,
                      emb_dim: int = 0, val_bytes: int = 2,
                      idx_bytes: int = 4, lse_bytes: int = 0,
                      emb_bytes_per_dim: int = 1,
                      emb_scale_bytes: int = 4,
                      hash_bytes: int = 8) -> int:
    """Payload bytes of ONE top-k prediction frame (one public batch).

    Defaults (one head, no embedding, f16 vals + i32 idx + 8-byte hash)
    reproduce the paper's §3.2 accounting; pass the run's real head count,
    embedding dim and dtypes for measured-format accounting.
    """
    per_sample = num_heads * (k * (val_bytes + idx_bytes) + lse_bytes)
    if emb_dim:
        per_sample += emb_dim * emb_bytes_per_dim + emb_scale_bytes
    per_sample += hash_bytes
    return batch * per_sample


def dense_frame_nbytes(batch: int, num_classes: int, num_heads: int = 1,
                       logit_bytes: int = 4, emb_dim: int = 0,
                       emb_bytes_per_dim: int = 4,
                       hash_bytes: int = 8) -> int:
    """Payload bytes of one dense (full-vocab) prediction frame."""
    per_sample = num_heads * num_classes * logit_bytes
    per_sample += emb_dim * emb_bytes_per_dim + hash_bytes
    return batch * per_sample
