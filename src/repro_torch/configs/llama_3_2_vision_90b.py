"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256, gated cross-attention image layers every 5th layer.
Vision frontend (ViT-H/14 + projector input 7680) is a STUB: input_specs()
provides precomputed patch embeddings (DESIGN.md §5).
[hf:meta-llama/Llama-3.2-11B-Vision]"""
from repro_torch.configs import ARCHS
from repro_torch.models.config import (
    LayerSpec,
    ModelConfig,
    VisionStubConfig,
    patterned_stages,
)

# one gated cross-attn layer then four self-attn layers, repeated
_PATTERN = [LayerSpec(attn="cross")] + [LayerSpec(attn="full")] * 4


def full() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b",
        family="vlm",
        num_layers=100,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab_size=128256,
        stages=patterned_stages(100, _PATTERN),
        rope_theta=500_000.0,
        norm="rmsnorm",
        act="silu",
        pos_embed="rope",
        vision=VisionStubConfig(num_patches=1600, embed_dim=7680),
        max_seq_len=131072,
        num_aux_heads=2,
        source="hf:meta-llama/Llama-3.2-11B-Vision (family card), 90B variant",
    ).validate()


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b-reduced",
        family="vlm",
        num_layers=10,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        stages=patterned_stages(10, _PATTERN),
        norm="rmsnorm",
        act="silu",
        pos_embed="rope",
        vision=VisionStubConfig(num_patches=16, embed_dim=48),
        max_seq_len=2048,
        num_aux_heads=2,
        remat="none",
    ).validate()


ARCHS.register("llama-3.2-vision-90b")({"full": full, "reduced": reduced})
