"""minitron-4b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000, pruned nemotron (squared-ReLU MLP). [arXiv:2407.14679]"""
from repro_torch.configs import ARCHS
from repro_torch.models.config import LayerSpec, ModelConfig, uniform_stages

_SPEC = LayerSpec(attn="full", ffn="dense")


def full() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b",
        family="dense",
        num_layers=32,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        head_dim=128,
        d_ff=9216,
        vocab_size=256000,
        stages=uniform_stages(32, _SPEC),
        rope_theta=10_000.0,
        norm="rmsnorm",
        act="relu2",
        pos_embed="rope",
        max_seq_len=4096,
        num_aux_heads=2,
        source="arXiv:2407.14679 (Minitron), 4B pruned nemotron",
    ).validate()


def reduced() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b-reduced",
        family="dense",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        stages=uniform_stages(2, _SPEC),
        norm="rmsnorm",
        act="relu2",
        pos_embed="rope",
        max_seq_len=2048,
        num_aux_heads=2,
        remat="none",
    ).validate()


ARCHS.register("minitron-4b")({"full": full, "reduced": reduced})
