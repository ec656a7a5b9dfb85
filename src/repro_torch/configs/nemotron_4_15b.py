"""nemotron-4-15b [dense] — 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000, squared-ReLU MLP (not gated). [arXiv:2402.16819]
"""
from repro_torch.configs.base import ModelConfig, register, smoke_variant


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="nemotron-4-15b",
        family="dense",
        n_layers=32,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=24576,
        vocab_size=256000,
        source="arXiv:2402.16819",
        block_pattern=("attn",),
        activation="sqrelu",
        gated_mlp=False,
        rope_theta=10_000.0,
        max_seq_len=4096,
    )


def smoke() -> ModelConfig:
    return smoke_variant(config())


register("nemotron-4-15b", config, smoke)
