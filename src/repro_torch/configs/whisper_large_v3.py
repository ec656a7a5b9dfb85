"""whisper-large-v3 [audio] — 32L d_model=1280 20H (MHA kv=20) d_ff=5120
vocab=51866, encoder-decoder with a stub conv frontend (input_specs provides
precomputed mel/conv frame embeddings); 32 ``enc`` blocks over 1,500 frames,
32 ``dec`` blocks with cross attention onto them, learned positions.
[arXiv:2212.04356]
"""
from repro_torch.configs.base import ModelConfig, register, smoke_variant


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="whisper-large-v3",
        family="audio",
        n_layers=32,                 # decoder layers
        n_encoder_layers=32,
        encoder_seq_len=1500,        # stub frame embeddings (B, 1500, d)
        d_model=1280,
        n_heads=20,                  # MHA: kv = heads
        n_kv_heads=20,
        d_ff=5120,
        vocab_size=51866,
        source="arXiv:2212.04356",
        block_pattern=("dec",),
        pos_embedding="learned",
        activation="gelu",
        gated_mlp=False,
        max_seq_len=32768,           # beyond whisper's 448; the backbone supports it
    )


def smoke() -> ModelConfig:
    return smoke_variant(config(), n_kv_heads=4)


register("whisper-large-v3", config, smoke)
