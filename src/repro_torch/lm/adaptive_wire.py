"""Entropy-adaptive top-k prediction codec (port of
``repro/lm/adaptive_wire.py``).

The fixed `TopKCodec` spends the same k entries on every token. The
`AdaptiveTopKCodec` allocates retention per token from the teacher's
main-head entropy under a ``budget_bytes_per_token`` — bytes go where the
teacher is uncertain — between a floor ``k_min`` and the codec's k.

Frame layout (codec_id 3), on the `PredictionMessage` format:

  sample_ids  (W, B)  u64      — unchanged: PublicPool keying holds
  k_per_token (W, N)  u16      — the retention plan, N tokens per window
  vals        (H, T)  f16/f32  — ragged streams packed per head,
  idx         (H, T)  u16/u32    token-major (T = sum of k_per_token)
  lse         (W, H, N) f32    — exact logsumexp, as the fixed codec
  emb_q/emb_scale | embedding  — unchanged embedding lane

``vals.nbytes + idx.nbytes <= budget * N_tokens`` holds by construction,
except that a budget below the k_min floor still sends k_min entries per
token. Frames are byte-identical to the JAX package's for the same
logits outside the lse lane (whose sum order differs by an ulp or two).

`encode` dispatches on what it is given, as the fixed codec does: a tensor
runs `kernels.ops.adaptive_topk_wire_frame` on its device (on a CUDA
tensor, the ``topk_wire`` kernel) and only wire-dtype arrays reach the
host; numpy runs the same function on the CPU. The ragged gather that
drops each token's unspent tail is host-side numpy, shared by both.
Budget <= 0 (unbounded) delegates to `TopKCodec`, byte for byte.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.comm.wire import (Codec, NonFiniteError, PredictionMessage,
                                   TopKCodec, _check_finite, _deserialize,
                                   _serialize, _split_heads, _stack_heads)


def densify_adaptive(vals: np.ndarray, idx: np.ndarray, lse: np.ndarray,
                     k_per_token: np.ndarray, num_classes: int,
                     tail: str = "uniform") -> np.ndarray:
    """Reconstruct dense (W, H, N, C) logits from an adaptive frame.

    Same tail semantics as `wire.densify_topk`, per token: with
    tail="uniform" the truncated mass is spread over the non-retained
    classes so logsumexp(recon) == lse and top-1 confidence stays exact;
    a token whose k covers the whole vocab (or tail="drop") fills with
    -1e30.
    """
    lse = np.asarray(lse, np.float32)
    W, H, N = lse.shape
    vals = np.asarray(vals, np.float32)
    idx = np.asarray(idx, np.int64)
    kt = np.asarray(k_per_token, np.int64).reshape(-1)  # (W*N,)
    col = np.repeat(np.arange(W * N), kt)  # token of each packed entry
    lse_hn = np.moveaxis(lse, 1, 0).reshape(H, W * N)
    out = np.empty((H, W * N, num_classes), np.float32)
    for h in range(H):
        if tail == "drop":
            fill = np.full(W * N, -1e30, np.float32)
        else:
            retained = np.zeros(W * N, np.float32)
            np.add.at(retained, col, np.exp(vals[h] - lse_hn[h, col]))
            tail_mass = np.clip(1.0 - retained, 1e-30, None)
            denom = np.maximum(num_classes - kt, 1)
            fill = (lse_hn[h] + np.log(tail_mass / denom)).astype(
                np.float32)
            fill = np.where(kt >= num_classes, np.float32(-1e30), fill)
        out[h] = np.broadcast_to(fill[:, None],
                                 (W * N, num_classes)).copy()
        out[h, col, idx[h]] = vals[h]
    return np.moveaxis(out.reshape(H, W, N, num_classes), 0, 1)


class AdaptiveTopKCodec(Codec):
    """Per-token entropy-adaptive top-k under a bytes/token budget."""

    codec_id = 3

    def __init__(self, k: int, budget_bytes_per_token: int = 0,
                 k_min: int = 1, val_dtype: str = "float16",
                 emb_encoding: str = "int8", tail: str = "uniform"):
        if k > 0xFFFF:
            raise ValueError(f"adaptive k {k} exceeds the u16 "
                             "k_per_token plan")
        self.k = int(k)
        self.budget = int(budget_bytes_per_token)
        self.k_min = max(1, int(k_min))
        self.val_dtype = np.dtype("<f2" if val_dtype == "float16"
                                  else "<f4")
        self.emb_encoding = emb_encoding
        self.tail = tail
        # the unbounded degenerate case IS the fixed codec (bitwise)
        self._fixed = TopKCodec(k, val_dtype=val_dtype,
                                emb_encoding=emb_encoding, tail=tail)

    # -- encode ---------------------------------------------------------

    def encode(self, src, sent_step, t0, sample_ids, outs) -> bytes:
        if self.budget <= 0:
            # unbounded budget: byte-for-byte the fixed TopKCodec frame
            # (codec_id 2 on the wire; decode/densify accept it)
            return self._fixed.encode(src, sent_step, t0, sample_ids, outs)
        on_device = isinstance(outs.get("logits"), torch.Tensor)
        if on_device:
            main = outs["logits"].float()[:, None]
            heads = torch.cat([main, outs["aux_logits"].float()], dim=1)
            emb = outs.get("embedding") if self.emb_encoding != "none" \
                else None
        else:
            heads = _stack_heads(outs)
            _check_finite("logits", heads)
            heads, emb = torch.from_numpy(heads), None
        C = int(heads.shape[-1])
        dev, finite = self._frame(heads, emb, C)
        if not bool(finite):
            raise NonFiniteError(
                "non-finite values in prediction outputs (or their f16 "
                "wire cast): refusing to encode")
        arrays: Dict[str, np.ndarray] = {
            "sample_ids": np.asarray(sample_ids, np.uint64)}
        arrays.update(self._ragged_pack(dev, C))
        if on_device:
            for name in ("emb_q", "emb_scale", "embedding"):
                if name in dev:
                    arrays[name] = dev[name].cpu().numpy()
        else:
            self._encode_emb(arrays, outs)
        return _serialize(PredictionMessage(src, sent_step, t0, C, arrays),
                          self.codec_id)

    def _frame(self, heads, emb, C: int):
        from repro_torch.kernels import ops

        k = min(self.k, C)
        entry = self.val_dtype.itemsize + self._fixed._idx_dtype(C).itemsize
        return ops.adaptive_topk_wire_frame(
            heads, emb, k, k_min=min(self.k_min, k),
            budget_bytes_per_token=self.budget, entry_bytes=entry,
            val_dtype="float16" if self.val_dtype.itemsize == 2
            else "float32",
            emb_encoding=self.emb_encoding)

    def _ragged_pack(self, dev: Dict[str, Any], C: int
                     ) -> Dict[str, np.ndarray]:
        """Drop each token's unspent tail: rectangular (W, H, N, k) arrays
        -> token-major packed streams (H, T). Plain numpy integer gathers,
        shared by both encode paths."""
        vals_r = dev["vals"].cpu().numpy()
        idx_r = dev["idx"].cpu().numpy().astype(self._fixed._idx_dtype(C))
        k_tok = dev["k_per_token"].cpu().numpy().astype(np.uint16)  # (W, N)
        W, H, N, k = vals_r.shape
        kt = k_tok.reshape(W * N).astype(np.int64)
        keep = np.arange(k)[None, :] < kt[:, None]  # (W*N, k)
        vals_t = np.moveaxis(vals_r, 1, 0).reshape(H, W * N, k)
        idx_t = np.moveaxis(idx_r, 1, 0).reshape(H, W * N, k)
        return {
            "k_per_token": k_tok,
            "vals": vals_t[:, keep],
            "idx": idx_t[:, keep],
            "lse": dev["lse"].cpu().numpy().astype(np.float32),
        }

    # -- decode ---------------------------------------------------------

    def decode(self, payload: bytes) -> PredictionMessage:
        msg, codec_id = _deserialize(payload)
        if codec_id not in (self.codec_id, TopKCodec.codec_id):
            raise ValueError(
                f"payload codec id {codec_id} not in "
                f"({self.codec_id}, {TopKCodec.codec_id})")
        return msg

    def densify(self, msg: PredictionMessage) -> Dict[str, np.ndarray]:
        if "k_per_token" not in msg.arrays:  # fixed-format (unbounded)
            return self._fixed.densify(msg)
        heads = densify_adaptive(
            msg.arrays["vals"], msg.arrays["idx"], msg.arrays["lse"],
            msg.arrays["k_per_token"], msg.num_classes, tail=self.tail)
        out = _split_heads(heads)
        emb = self._decode_emb(msg)
        if emb is not None:
            out["embedding"] = emb
        return out


def adaptive_frame_max_nbytes(window: int, seq_batch: int, tokens: int,
                              num_heads: int,
                              budget_bytes_per_token: int,
                              emb_dim: int = 0, val_bytes: int = 2,
                              idx_bytes: int = 2, k_min: int = 1,
                              emb_encoding: str = "int8") -> int:
    """Exact serialized-size ceiling of ONE adaptive frame (codec_id 3).

    The variable entry streams are bounded by the budget
    (``<= budget * window * tokens`` bytes by construction) — except
    when the budget sits below the ``k_min`` floor, where every token
    still travels with k_min entries (the wire never sends less than
    top-1), so the bound is the max of the two. Everything else —
    headers, sample_ids (window, seq_batch), the retention plan, lse
    and the embedding lane — is fixed overhead computed from the frame
    shape. The smoke asserts measured offered bytes against this
    ceiling, so the meter ledger IS the budget objective.
    """
    def arr(name: str, ndim: int, nbytes: int) -> int:
        return 1 + len(name) + 2 + 8 * ndim + nbytes

    N = window * tokens
    total = 40  # magic + <BBH> + <qqqq>
    total += arr("sample_ids", 2, window * seq_batch * 8)
    total += arr("k_per_token", 2, N * 2)
    total += arr("vals", 2, 0) + arr("idx", 2, 0)
    floor = num_heads * N * k_min * (val_bytes + idx_bytes)
    total += max(budget_bytes_per_token * N, floor)  # entry-stream bound
    total += arr("lse", 3, N * num_heads * 4)
    if emb_dim:
        if emb_encoding == "int8":
            total += arr("emb_q", 3, N * emb_dim)
            total += arr("emb_scale", 2, N * 4)
        elif emb_encoding != "none":
            total += arr("embedding", 3, N * emb_dim * 4)
    return total
