"""rwkv6-1.6b [ssm] — "Finch": 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536, data-dependent decay. [arXiv:2404.05892]
"""
from repro_torch.configs.base import ModelConfig, register, smoke_variant


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="rwkv6-1.6b",
        family="ssm",
        n_layers=24,
        d_model=2048,
        n_heads=0,               # attention-free
        n_kv_heads=0,
        d_ff=7168,               # channel-mix hidden (3.5x)
        vocab_size=65536,
        source="arXiv:2404.05892",
        block_pattern=("rwkv",),
        rwkv_head_dim=64,        # 32 heads
        pos_embedding="none",
        max_seq_len=1 << 20,     # O(1) state: unbounded context
    )


def smoke() -> ModelConfig:
    return smoke_variant(config(), n_heads=0, n_kv_heads=0)


register("rwkv6-1.6b", config, smoke)
