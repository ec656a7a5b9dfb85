"""gemma3-12b [dense] — 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144, 5:1 local:global interleave, 128k context.
[hf:google/gemma-3-1b-pt family card, scaled per assignment]
"""
from repro_torch.configs.base import ModelConfig, register, smoke_variant


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="gemma3-12b",
        family="dense",
        n_layers=48,
        d_model=3840,
        n_heads=16,
        n_kv_heads=8,
        d_ff=15360,
        vocab_size=262144,
        head_dim=240,
        source="hf:google/gemma-3-1b-pt",
        block_pattern=("local",) * 5 + ("attn",),   # 5:1 local:global, 48 = 8 units
        window_size=1024,
        rope_theta=1_000_000.0,
        max_seq_len=131072,
        activation="gelu",
        gated_mlp=True,
        tie_embeddings=True,               # gemma family ties embeddings
        long_context_local=True,
    )


def smoke() -> ModelConfig:
    return smoke_variant(config(), block_pattern=("local", "attn"), window_size=8)


register("gemma3-12b", config, smoke)
