"""repro_torch.comm — the prediction-exchange wire subsystem (paper §3.2),
port of ``repro.comm``.

  wire.py       codecs — dense f32/f16 and top-k packed (vals, idx, lse)
                on the port's ``topk_wire`` kernel, int8-quantized
                embeddings; the MHDW format, byte-identical to the JAX
                package's in both directions.
  transport.py  in-process loopback and the simulated lossy network
                (copies of the reference's numpy-only modules, as are
                bus.py and metering.py).
  bus.py        per-edge mailboxes driven by the graph G_t;
                `PredictionPool`, the prediction twin of the param pool.
  metering.py   the bytes-per-edge-per-step ledger.
  socket.py     the same send/poll interface over real TCP on one host
                (a copy of the reference's stdlib module, frame for
                frame): in-process for ``Experiment.run()``, one instance
                a process for `repro_torch.launch.gossip`.

The entropy-adaptive and the delta-compressed codecs of the LM wire live
in `repro_torch.lm`.
"""
from __future__ import annotations

import dataclasses

from repro_torch.comm.bus import (
    Mail,
    PredictionBus,
    PredictionPool,
    PredictionWindow,
)
from repro_torch.comm.metering import CommMeter
from repro_torch.comm.socket import SocketTransport, allocate_ports
from repro_torch.comm.transport import (
    Delivery,
    EdgeSpec,
    LoopbackTransport,
    SimulatedNetwork,
    Transport,
)
from repro_torch.comm.wire import (
    Codec,
    DenseCodec,
    NonFiniteError,
    PredictionMessage,
    TopKCodec,
    dense_frame_nbytes,
    densify_topk,
    frame_overhead_nbytes,
    topk_frame_nbytes,
)


@dataclasses.dataclass(frozen=True)
class CommConfig:
    """Knobs of the prediction exchange (runtime ``exchange != "params"``).

    horizon: how many upcoming public batches one publish covers (W).
      0 = auto: S_P (`pool_update_every`). Set ≥ pool_size·S_P to emulate
      the param pool's full staleness range.
    budget_bytes_per_token: the entropy-adaptive wire's per-token byte
      budget for the (val, idx) entry streams
      (``exchange="prediction_adaptive"``; `repro_torch.lm.adaptive_wire`).
      0 = unbounded — byte-identical to the fixed TopKCodec.
    compression: "none" | "delta" — "delta" wraps the codec in
      `repro_torch.lm.compress.CompressedCodec` (XOR-delta + bit-packed
      index streams); "none" leaves the frames as they are.
    """
    topk: int = 32
    val_dtype: str = "float16"  # "float16" | "float32"
    emb_encoding: str = "int8"  # "int8" | "float32" | "none"
    tail: str = "uniform"  # truncated-mass handling, see wire.densify_topk
    horizon: int = 0
    budget_bytes_per_token: int = 0
    compression: str = "none"  # "none" | "delta"


def make_codec(exchange: str, cfg: CommConfig) -> Codec:
    if exchange == "prediction_topk":
        codec: Codec = TopKCodec(cfg.topk, val_dtype=cfg.val_dtype,
                                 emb_encoding=cfg.emb_encoding,
                                 tail=cfg.tail)
    elif exchange == "prediction_adaptive":
        from repro_torch.lm.adaptive_wire import AdaptiveTopKCodec

        codec = AdaptiveTopKCodec(
            cfg.topk, budget_bytes_per_token=cfg.budget_bytes_per_token,
            val_dtype=cfg.val_dtype, emb_encoding=cfg.emb_encoding,
            tail=cfg.tail)
    elif exchange == "prediction_dense":
        codec = DenseCodec(logit_dtype="float32",
                           emb_encoding=cfg.emb_encoding)
    else:
        raise ValueError(f"unknown prediction exchange mode: {exchange!r}")
    if cfg.compression == "delta":
        from repro_torch.lm.compress import CompressedCodec

        codec = CompressedCodec(codec)
    elif cfg.compression != "none":
        raise ValueError(f"unknown wire compression: {cfg.compression!r}")
    return codec


__all__ = [
    "Codec",
    "CommConfig",
    "CommMeter",
    "Delivery",
    "DenseCodec",
    "EdgeSpec",
    "LoopbackTransport",
    "Mail",
    "NonFiniteError",
    "PredictionBus",
    "PredictionMessage",
    "PredictionPool",
    "PredictionWindow",
    "SimulatedNetwork",
    "SocketTransport",
    "TopKCodec",
    "Transport",
    "allocate_ports",
    "dense_frame_nbytes",
    "densify_topk",
    "frame_overhead_nbytes",
    "make_codec",
    "topk_frame_nbytes",
]
