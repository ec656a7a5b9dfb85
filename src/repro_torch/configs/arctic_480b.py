"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000, MoE 128 experts top-2 + dense residual path.
[hf:Snowflake/snowflake-arctic-base]
"""
from repro_torch.configs.base import ModelConfig, register, smoke_variant


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="arctic-480b",
        family="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=4864,
        vocab_size=32000,
        source="hf:Snowflake/snowflake-arctic-base",
        block_pattern=("attn",),
        n_experts=128,
        top_k=2,
        capacity_factor=1.25,
        moe_dense_residual=True,
        dense_ff_dim=4864,
        activation="silu",
        gated_mlp=True,
        rope_theta=10_000.0,
        max_seq_len=4096,
    )


def smoke() -> ModelConfig:
    return smoke_variant(config())


register("arctic-480b", config, smoke)
