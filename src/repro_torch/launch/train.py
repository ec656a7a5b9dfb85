"""LM configurations of the training entry point (port of the configuration
half of ``repro/launch/train.py``: ``mini_config`` and
``get_train_config``). The training loop itself waits (ROADMAP A8).
"""
from __future__ import annotations

from repro_torch.configs import ModelConfig, get_smoke_config


def mini_config(**overrides) -> ModelConfig:
    """Small dense model for the CPU end-to-end example.
    Scale up with e.g. ``mini_config(d_model=768, n_layers=12)`` (~100M)."""
    kw = dict(
        arch_id="mini", family="dense", n_layers=4, d_model=384,
        n_heads=6, n_kv_heads=2, d_ff=1536, vocab_size=8192, head_dim=64,
        block_pattern=("attn",), activation="silu", gated_mlp=True,
        dtype="float32", max_seq_len=2048,
    )
    kw.update(overrides)
    return ModelConfig(**kw)


def get_train_config(arch: str) -> ModelConfig:
    if arch == "mini":
        return mini_config()
    return get_smoke_config(arch)
