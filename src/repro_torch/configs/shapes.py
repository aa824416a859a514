"""The dry run's input shapes, and meta tensors standing for its inputs
(port of ``repro/configs/shapes.py``).

INPUT_SHAPES are the four assigned (seq_len, global_batch) points. ``mode``
is derived per shape: train_4k counts ``train_step``; prefill_32k the
``prefill`` forward; the decode shapes ``serve_step`` (one new token
against a seq_len KV cache).

``long_500k`` applicability is decided by ``supports_shape``, as the
reference's. `input_specs` gives tensors on the ``meta`` device where the
reference gives ``ShapeDtypeStruct``s: they have shapes and dtypes and
hold nothing. A decode cache's ``index`` holds a position a row (the
port's caches, `models/transformer.py`), where the reference's is a
scalar.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.resnet import ResNetConfig

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

# archs allowed to run the 500k-context decode
LONG_CONTEXT_ARCHS = {
    "mamba2-370m",  # O(1) SSM state
    "zamba2-7b",  # hybrid: mamba state + 1 shared-attn KV per 6 layers
    "gemma3-27b",  # sliding window: only 1-in-6 global layers keep 500k KV
    "gemma3-12b",
    "deepseek-v3-671b",  # MLA compressed 576-dim latent cache
}


def supports_shape(arch_name: str, cfg: Any, shape: InputShape) -> Optional[str]:
    """None if supported, else a human-readable skip reason."""
    if isinstance(cfg, ResNetConfig):
        if shape.mode != "train":
            return "cnn classifier: no autoregressive decode/prefill"
        return None
    if shape.name == "long_500k" and arch_name not in LONG_CONTEXT_ARCHS:
        return ("full-attention KV at 500k tokens is multi-TB; no "
                "sliding-window variant in the source model (DESIGN.md §6)")
    if cfg.family == "audio" and shape.name == "long_500k":
        return "whisper: 500k frames ≈ 2.9h audio exceeds the 30s design point"
    return None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _token_batch(cfg: ModelConfig, batch: int, seq: int
                 ) -> Dict[str, torch.Tensor]:
    specs: Dict[str, torch.Tensor] = {}
    if cfg.family == "audio":
        # seq_len = encoder frame count; decoder length fixed at 448 (card max)
        specs["tokens"] = _meta((batch, cfg.audio.decoder_len), torch.int32)
        specs["audio_frames"] = _meta((batch, seq, cfg.audio.frame_dim),
                                      torch.bfloat16)
    else:
        specs["tokens"] = _meta((batch, seq), torch.int32)
        if cfg.vision is not None:
            specs["vision_embeds"] = _meta(
                (batch, cfg.vision.num_patches, cfg.vision.embed_dim),
                torch.bfloat16)
    return specs


def input_specs(cfg: Any, shape_name: str) -> Dict[str, Any]:
    """Meta-tensor inputs for (arch, shape): never allocates."""
    shape = INPUT_SHAPES[shape_name]
    if isinstance(cfg, ResNetConfig):
        return {
            "images": _meta((shape.global_batch, 224, 224, 3),
                            torch.bfloat16),
            "labels": _meta((shape.global_batch,), torch.int32),
        }
    if shape.mode in ("train", "prefill"):
        return _token_batch(cfg, shape.global_batch, shape.seq_len)
    # decode: one token + caches of length seq_len
    from repro_torch.models.transformer import init_lm_cache

    return {
        "token": _meta((shape.global_batch, 1), torch.int32),
        "caches": init_lm_cache(cfg, shape.global_batch, shape.seq_len,
                                torch.bfloat16, device=META),
    }
