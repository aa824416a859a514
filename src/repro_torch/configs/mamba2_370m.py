"""mamba2-370m [ssm] — 48L d_model=1024 attention-free, vocab=50280,
ssm_state=128, SSD (state-space duality). [arXiv:2405.21060]"""
from repro_torch.configs import ARCHS
from repro_torch.models.config import LayerSpec, MambaConfig, ModelConfig, uniform_stages

_SPEC = LayerSpec(attn="mamba2", ffn="none")


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        family="ssm",
        num_layers=48,
        d_model=1024,
        num_heads=32,  # d_inner / head_dim = 2048 / 64
        num_kv_heads=32,
        d_ff=0,
        vocab_size=50280,
        stages=uniform_stages(48, _SPEC),
        mamba=MambaConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                          chunk_size=256),
        norm="rmsnorm",
        tie_embeddings=True,
        pos_embed="none",
        max_seq_len=1_048_576,
        num_aux_heads=2,
        source="arXiv:2405.21060 (Mamba2), 370m preset",
    ).validate()


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m-reduced",
        family="ssm",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=512,
        stages=uniform_stages(2, _SPEC),
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2, head_dim=64,
                          chunk_size=32),
        norm="rmsnorm",
        tie_embeddings=True,
        pos_embed="none",
        max_seq_len=65536,
        num_aux_heads=2,
        remat="none",
    ).validate()


ARCHS.register("mamba2-370m")({"full": full, "reduced": reduced})
