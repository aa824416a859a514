"""whisper-large-v3 [audio] — enc-dec, 32L(+32L enc) d_model=1280 20H (kv=20)
d_ff=5120 vocab=51866, conv frontend STUB (precomputed frame embeddings).
Adaptation note (DESIGN.md §6): the assigned input shapes' seq_len is the
*encoder* frame count; decoder length is the model's 448 max target
positions. [arXiv:2212.04356]"""
from repro_torch.configs import ARCHS
from repro_torch.models.config import (
    AudioStubConfig,
    EncoderConfig,
    LayerSpec,
    ModelConfig,
    uniform_stages,
)

_SPEC = LayerSpec(attn="full", ffn="dense", cross_attn=True)


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3",
        family="audio",
        num_layers=32,  # decoder layers; encoder adds 32 more (EncoderConfig)
        d_model=1280,
        num_heads=20,
        num_kv_heads=20,
        head_dim=64,
        d_ff=5120,
        vocab_size=51866,
        stages=uniform_stages(32, _SPEC),
        norm="layernorm",
        act="gelu",
        tie_embeddings=True,
        pos_embed="learned",
        audio=AudioStubConfig(frame_dim=1280, decoder_len=448),
        encoder=EncoderConfig(num_layers=32),
        max_seq_len=448,
        num_aux_heads=2,
        source="arXiv:2212.04356 (Whisper), large-v3",
    ).validate()


def reduced() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3-reduced",
        family="audio",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        stages=uniform_stages(2, _SPEC),
        norm="layernorm",
        act="gelu",
        tie_embeddings=True,
        pos_embed="learned",
        audio=AudioStubConfig(frame_dim=48, decoder_len=32),
        encoder=EncoderConfig(num_layers=2),
        max_seq_len=64,
        num_aux_heads=2,
        remat="none",
    ).validate()


ARCHS.register("whisper-large-v3")({"full": full, "reduced": reduced})
