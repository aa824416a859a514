"""deepseek-v3-671b [moe] — 61L d_model=7168 128H MLA, vocab=129280,
MoE 1 shared + 256 routed top-8 (expert d_ff=2048), sigmoid scoring,
multi-token prediction (MTP). First 3 layers dense (d_ff=18432).
[arXiv:2412.19437]"""
import dataclasses

from repro_torch.configs import ARCHS
from repro_torch.models.config import (
    LayerSpec,
    MLAConfig,
    MoEConfig,
    ModelConfig,
    Stage,
)

_DENSE = LayerSpec(attn="full", ffn="dense")
_MOE = LayerSpec(attn="full", ffn="moe")


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=128,
        num_kv_heads=128,  # MLA: per-head KV is decompressed from the latent
        head_dim=128,
        d_ff=18432,  # dense layers (first 3)
        vocab_size=129280,
        stages=(
            Stage(block=(_DENSE,), repeats=3),
            Stage(block=(_MOE,), repeats=58),
        ),
        moe=MoEConfig(
            num_experts=256,
            top_k=8,
            d_ff_expert=2048,
            num_shared_experts=1,
            capacity_factor=1.25,
            router_aux_weight=0.0001,  # v3 uses bias-based balancing; tiny aux
        ),
        mla=MLAConfig(
            q_lora_rank=1536,
            kv_lora_rank=512,
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
        ),
        moe_scoring="sigmoid",
        moe_impl="a2a",  # expert-parallel a2a dispatch (EXPERIMENTS §Perf B)
        mtp=True,
        rope_theta=10_000.0,
        norm="rmsnorm",
        act="silu",
        pos_embed="rope",
        max_seq_len=131072,
        num_aux_heads=2,
        loss_impl="chunked",
        loss_chunk=512,  # time-axis chunks (EXPERIMENTS §Perf B5)
        source="arXiv:2412.19437 (DeepSeek-V3)",
    ).validate()


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b-reduced",
        family="moe",
        num_layers=3,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        stages=(
            Stage(block=(_DENSE,), repeats=1),
            Stage(block=(_MOE,), repeats=2),
        ),
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64,
                      num_shared_experts=1, capacity_factor=1.5),
        mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32,
                      qk_rope_head_dim=16, v_head_dim=32),
        moe_scoring="sigmoid",
        moe_impl="a2a",  # expert-parallel a2a dispatch (EXPERIMENTS §Perf B)
        mtp=True,
        norm="rmsnorm",
        act="silu",
        pos_embed="rope",
        max_seq_len=2048,
        num_aux_heads=2,
        remat="none",
    ).validate()


ARCHS.register("deepseek-v3-671b")({"full": full, "reduced": reduced})
