"""llama3-405b [dense] — 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256, 128k vocab GQA. [arXiv:2407.21783]
"""
from repro_torch.configs.base import ModelConfig, register, smoke_variant


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="llama3-405b",
        family="dense",
        n_layers=126,
        d_model=16384,
        n_heads=128,
        n_kv_heads=8,
        d_ff=53248,
        vocab_size=128256,
        source="arXiv:2407.21783",
        block_pattern=("attn",),
        activation="silu",
        gated_mlp=True,
        rope_theta=500_000.0,
        max_seq_len=131072,
    )


def smoke() -> ModelConfig:
    return smoke_variant(config())


register("llama3-405b", config, smoke)
