"""gemma3-12b [dense] — 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144, 5:1 local:global sliding-window, 128k context.
[hf:google/gemma-3-1b-pt]"""
from repro_torch.configs import ARCHS
from repro_torch.models.config import LayerSpec, ModelConfig, patterned_stages

_PATTERN = [LayerSpec(attn="swa")] * 5 + [LayerSpec(attn="full")]


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b",
        family="dense",
        num_layers=48,
        d_model=3840,
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,
        d_ff=15360,
        vocab_size=262144,
        stages=patterned_stages(48, _PATTERN),
        window_size=1024,
        qk_norm=True,
        rope_theta=1_000_000.0,
        norm="rmsnorm",
        act="silu",
        tie_embeddings=True,
        scale_embeddings=True,
        pos_embed="rope",
        max_seq_len=131072,
        num_aux_heads=2,
        source="hf:google/gemma-3-1b-pt (family card), 12B variant",
    ).validate()


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b-reduced",
        family="dense",
        num_layers=6,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        stages=patterned_stages(6, _PATTERN),
        window_size=32,
        qk_norm=True,
        norm="rmsnorm",
        act="silu",
        tie_embeddings=True,
        scale_embeddings=True,
        pos_embed="rope",
        max_seq_len=2048,
        num_aux_heads=2,
        remat="none",
    ).validate()


ARCHS.register("gemma3-12b")({"full": full, "reduced": reduced})
