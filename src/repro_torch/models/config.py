"""Model configuration schema (a copy of ``repro/models/config.py``).

One ``ModelConfig`` describes every assigned architecture. Depth is expressed
as *stages*: a stage is a homogeneous repeat-unit (list of ``LayerSpec``)
scanned ``repeats`` times — this keeps HLO size O(unit) for 62..100-layer
models (DESIGN.md §9) while expressing heterogeneous patterns
(gemma3 5 local : 1 global, llama-vision 1 cross : 4 self,
zamba2 shared-attention every 6th block).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer inside a repeat unit."""

    attn: str = "full"  # "full" | "swa" | "cross" | "mamba2" | "none"
    ffn: str = "dense"  # "dense" | "moe" | "moe_dense_parallel" | "none"
    shared_attn: bool = False  # zamba2: append the *shared* attention block
    cross_attn: bool = False  # whisper decoder: extra cross-attn sublayer


@dataclasses.dataclass(frozen=True)
class Stage:
    block: Tuple[LayerSpec, ...]
    repeats: int

    @property
    def num_layers(self) -> int:
        return len(self.block) * self.repeats


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 2048
    num_shared_experts: int = 0  # deepseek: 1 shared expert
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class VisionStubConfig:
    """VLM frontend stub: precomputed patch embeddings (DESIGN.md §5)."""

    num_patches: int = 1024
    embed_dim: int = 1280  # raw vision-encoder hidden; projector is in-model


@dataclasses.dataclass(frozen=True)
class AudioStubConfig:
    """Audio frontend stub: precomputed mel+conv frame embeddings."""

    frame_dim: int = 1280
    decoder_len: int = 448  # whisper max target positions


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style bidirectional encoder consumed via cross-attention."""

    num_layers: int = 32
    # encoder reuses d_model / heads / d_ff of the main config


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | vlm | audio | cnn
    num_layers: int = 12
    d_model: int = 512
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: Optional[int] = None  # default d_model // num_heads
    d_ff: int = 2048
    vocab_size: int = 32000
    stages: Tuple[Stage, ...] = ()
    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    window_size: int = 1024  # sliding-window width for "swa" layers
    attn_logit_softcap: Optional[float] = None
    # norms / activations
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"  # silu | gelu
    tie_embeddings: bool = False
    pos_embed: str = "rope"  # rope | learned | sinusoidal | none
    scale_embeddings: bool = False  # gemma: embed * sqrt(d_model)
    moe_scoring: str = "softmax"  # softmax | sigmoid (deepseek-v3)
    moe_impl: str = "scatter"  # scatter | a2a (expert-parallel all-to-all)
    loss_impl: str = "dense"  # dense | chunked (§Perf lever: no logit materialization)
    loss_chunk: int = 2048
    # substructures
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    vision: Optional[VisionStubConfig] = None
    audio: Optional[AudioStubConfig] = None
    encoder: Optional[EncoderConfig] = None
    # MHD heads (the paper's technique)
    num_aux_heads: int = 0
    # DeepSeek multi-token prediction
    mtp: bool = False
    # training details
    remat: str = "unit"  # "none" | "unit" | "dots"
    max_seq_len: int = 131072
    # citation for the assigned-architecture provenance
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    def stage_layers(self) -> int:
        return sum(s.num_layers for s in self.stages)

    def validate(self) -> "ModelConfig":
        if self.stages and self.stage_layers() != self.num_layers:
            raise ValueError(
                f"{self.name}: stages cover {self.stage_layers()} layers, "
                f"config says num_layers={self.num_layers}"
            )
        if self.num_heads % max(self.num_kv_heads, 1) != 0:
            raise ValueError(f"{self.name}: num_heads must be divisible by num_kv_heads")
        return self


def uniform_stages(num_layers: int, spec: LayerSpec) -> Tuple[Stage, ...]:
    """All layers identical: one stage scanning `num_layers` single-layer units."""
    return (Stage(block=(spec,), repeats=num_layers),)


def patterned_stages(
    num_layers: int, pattern: Sequence[LayerSpec]
) -> Tuple[Stage, ...]:
    """Repeat `pattern` as many whole times as fits; remainder = trailing stage."""
    unit = len(pattern)
    reps, rem = divmod(num_layers, unit)
    stages: List[Stage] = []
    if reps:
        stages.append(Stage(block=tuple(pattern), repeats=reps))
    if rem:
        stages.append(Stage(block=tuple(pattern[:rem]), repeats=1))
    return tuple(stages)
