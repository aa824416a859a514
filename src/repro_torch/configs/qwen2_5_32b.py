"""qwen2.5-32b [dense] — 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064, GQA with QKV bias. [hf:Qwen/Qwen2.5-0.5B]"""
from repro_torch.configs import ARCHS
from repro_torch.models.config import LayerSpec, ModelConfig, uniform_stages

_SPEC = LayerSpec(attn="full", ffn="dense")


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b",
        family="dense",
        num_layers=64,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=27648,
        vocab_size=152064,
        stages=uniform_stages(64, _SPEC),
        qkv_bias=True,
        rope_theta=1_000_000.0,
        norm="rmsnorm",
        act="silu",
        pos_embed="rope",
        max_seq_len=131072,
        num_aux_heads=2,
        source="hf:Qwen/Qwen2.5-0.5B (family card), 32B variant",
    ).validate()


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b-reduced",
        family="dense",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        stages=uniform_stages(2, _SPEC),
        qkv_bias=True,
        norm="rmsnorm",
        act="silu",
        pos_embed="rope",
        max_seq_len=2048,
        num_aux_heads=2,
        remat="none",
    ).validate()


ARCHS.register("qwen2.5-32b")({"full": full, "reduced": reduced})
