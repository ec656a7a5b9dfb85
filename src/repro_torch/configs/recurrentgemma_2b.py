"""recurrentgemma-2b [hybrid] — Griffin: 26L d_model=2560 10H (MQA kv=1)
d_ff=7680, vocab=256000, RG-LRU + local attention at 1:2 (one attention
per two recurrent blocks). 26 = 8x(rec,rec,local) + 2x rec remainder
(layer count exact). [arXiv:2402.19427]
"""
from repro_torch.configs.base import ModelConfig, register, smoke_variant


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,            # MQA
        d_ff=7680,
        vocab_size=256000,
        head_dim=256,            # griffin uses 256
        source="arXiv:2402.19427",
        block_pattern=("rec", "rec", "local"),
        window_size=2048,
        rglru_width=2560,
        conv1d_width=4,
        activation="gelu",
        gated_mlp=True,
        tie_embeddings=True,
        pos_embedding="rope",
        max_seq_len=1 << 20,     # local attn + O(1) recurrent state
    )


def smoke() -> ModelConfig:
    return smoke_variant(config(), block_pattern=("rec", "local"), n_kv_heads=1)


register("recurrentgemma-2b", config, smoke)
