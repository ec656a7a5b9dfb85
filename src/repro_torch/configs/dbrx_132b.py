"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352, MoE 16 experts top-4 (fine-grained). [hf:databricks/dbrx-base]
"""
from repro_torch.configs.base import ModelConfig, register, smoke_variant


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="dbrx-132b",
        family="moe",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=10752,
        vocab_size=100352,
        source="hf:databricks/dbrx-base",
        block_pattern=("attn",),
        n_experts=16,
        top_k=4,
        capacity_factor=1.25,
        activation="silu",
        gated_mlp=True,
        rope_theta=500_000.0,
        max_seq_len=32768,
    )


def smoke() -> ModelConfig:
    return smoke_variant(config())


register("dbrx-132b", config, smoke)
