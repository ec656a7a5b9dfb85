"""deepseek-67b [dense] — 95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400, llama-arch. [arXiv:2401.02954]
"""
from repro_torch.configs.base import ModelConfig, register, smoke_variant


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="deepseek-67b",
        family="dense",
        n_layers=95,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22016,
        vocab_size=102400,
        source="arXiv:2401.02954",
        block_pattern=("attn",),
        activation="silu",
        gated_mlp=True,
        rope_theta=10_000.0,
        max_seq_len=4096,
    )


def smoke() -> ModelConfig:
    return smoke_variant(config())


register("deepseek-67b", config, smoke)
