"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
dense-MoE hybrid: every layer has a dense residual MLP in parallel with a
128-expert top-2 MoE. [hf:Snowflake/snowflake-arctic-base]"""
from repro_torch.configs import ARCHS
from repro_torch.models.config import (
    LayerSpec,
    MoEConfig,
    ModelConfig,
    uniform_stages,
)

_SPEC = LayerSpec(attn="full", ffn="moe_dense_parallel")


def full() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b",
        family="moe",
        num_layers=35,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        d_ff=4864,  # the parallel dense residual MLP
        vocab_size=32000,
        stages=uniform_stages(35, _SPEC),
        moe=MoEConfig(
            num_experts=128,
            top_k=2,
            d_ff_expert=4864,
            num_shared_experts=0,
            capacity_factor=1.25,
            router_aux_weight=0.01,
        ),
        moe_impl="a2a",  # expert-parallel a2a dispatch (EXPERIMENTS §Perf B)
        rope_theta=10_000.0,
        norm="rmsnorm",
        act="silu",
        pos_embed="rope",
        max_seq_len=4096,
        num_aux_heads=2,
        source="hf:Snowflake/snowflake-arctic-base",
    ).validate()


def reduced() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b-reduced",
        family="moe",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=128,
        vocab_size=512,
        stages=uniform_stages(2, _SPEC),
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128,
                      capacity_factor=1.5),
        norm="rmsnorm",
        act="silu",
        pos_embed="rope",
        max_seq_len=2048,
        num_aux_heads=2,
        remat="none",
    ).validate()


ARCHS.register("arctic-480b")({"full": full, "reduced": reduced})
