"""internvl2-2b [vlm] — InternViT + InternLM2: 24L d_model=2048 16H (GQA kv=8)
d_ff=8192 vocab=92553. Vision encoder + projector are a stub: input_specs
provides (B, 256, d_model) projected patch embeddings, prepended to the
prompt; RoPE positions count them.
[arXiv:2404.16821]
"""
from repro_torch.configs.base import ModelConfig, register, smoke_variant


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="internvl2-2b",
        family="vlm",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=92553,
        source="arXiv:2404.16821",
        block_pattern=("attn",),
        n_image_tokens=256,
        activation="silu",
        gated_mlp=True,
        rope_theta=1_000_000.0,
        max_seq_len=32768,
    )


def smoke() -> ModelConfig:
    return smoke_variant(config())


register("internvl2-2b", config, smoke)
