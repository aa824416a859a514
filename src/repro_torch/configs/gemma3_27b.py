"""gemma3-27b [dense] — 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144, 5:1 local:global sliding-window, 128k context.
[hf:google/gemma-3-1b-pt]"""
from repro_torch.configs import ARCHS
from repro_torch.models.config import LayerSpec, ModelConfig, patterned_stages

_LOCAL = LayerSpec(attn="swa", ffn="dense")
_GLOBAL = LayerSpec(attn="full", ffn="dense")
_PATTERN = [_LOCAL] * 5 + [_GLOBAL]


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b",
        family="dense",
        num_layers=62,
        d_model=5376,
        num_heads=32,
        num_kv_heads=16,
        head_dim=128,
        d_ff=21504,
        vocab_size=262144,
        stages=patterned_stages(62, _PATTERN),
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
        source="hf:google/gemma-3-1b-pt (family card), 27B variant",
    ).validate()


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b-reduced",
        family="dense",
        num_layers=12,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        stages=patterned_stages(12, _PATTERN),
        window_size=64,
        qk_norm=True,
        norm="rmsnorm",
        act="silu",
        tie_embeddings=True,
        scale_embeddings=True,
        pos_embed="rope",
        max_seq_len=4096,
        num_aux_heads=2,
        remat="none",
    ).validate()


ARCHS.register("gemma3-27b")({"full": full, "reduced": reduced})
