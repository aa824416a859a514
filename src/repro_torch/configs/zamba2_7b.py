"""zamba2-7b [hybrid] — 81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000,
ssm_state=64: Mamba2 backbone with a *shared* attention block applied every
6th layer (shared weights are closure constants, not scanned — DESIGN.md §5).
[arXiv:2411.15242]"""
from repro_torch.configs import ARCHS
from repro_torch.models.config import (
    LayerSpec,
    MambaConfig,
    ModelConfig,
    patterned_stages,
)

_M = LayerSpec(attn="mamba2", ffn="none")
_MS = LayerSpec(attn="mamba2", ffn="dense", shared_attn=True)
_PATTERN = [_M] * 5 + [_MS]


def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        num_layers=81,
        d_model=3584,
        num_heads=32,
        num_kv_heads=32,
        head_dim=112,
        d_ff=14336,
        vocab_size=32000,
        stages=patterned_stages(81, _PATTERN),
        mamba=MambaConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                          chunk_size=256),
        rope_theta=10_000.0,
        norm="rmsnorm",
        tie_embeddings=True,
        pos_embed="rope",
        max_seq_len=1_048_576,
        num_aux_heads=2,
        source="arXiv:2411.15242 (Zamba2-7B)",
    ).validate()


def reduced() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b-reduced",
        family="hybrid",
        num_layers=12,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        stages=patterned_stages(12, _PATTERN),
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2, head_dim=32,
                          chunk_size=32),
        norm="rmsnorm",
        tie_embeddings=True,
        pos_embed="rope",
        max_seq_len=65536,
        num_aux_heads=2,
        remat="none",
    ).validate()


ARCHS.register("zamba2-7b")({"full": full, "reduced": reduced})
