"""repro_torch.lm — LM clients in the MHD fleet (port of ``repro.lm``).

  pool.py          the public token pool, the `ModelBundle` wrapper
                   that turns token positions into MHD samples, and
                   `lm_wire_tokens` (the tokens a public batch puts on
                   the wire).
  adaptive_wire.py `AdaptiveTopKCodec` — per-token top-k chosen from
                   teacher entropy under a bytes/token budget, on the
                   ``topk_wire`` kernel.
  compress.py      `CompressedCodec` — XOR-delta + bit-packed index
                   streams as a composable wrapper codec (a copy).
"""
from __future__ import annotations

from repro_torch.lm.adaptive_wire import (
    AdaptiveTopKCodec,
    adaptive_frame_max_nbytes,
    densify_adaptive,
)
from repro_torch.lm.compress import CompressedCodec, pack_bits, unpack_bits
from repro_torch.lm.pool import (lm_client_bundle, lm_wire_tokens,
                                 make_text_arrays)

__all__ = [
    "AdaptiveTopKCodec",
    "CompressedCodec",
    "adaptive_frame_max_nbytes",
    "densify_adaptive",
    "lm_client_bundle",
    "lm_wire_tokens",
    "make_text_arrays",
    "pack_bits",
    "unpack_bits",
]
