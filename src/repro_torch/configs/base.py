"""Model configuration schema and registry (port of ``repro/configs/base.py``).

The fields, properties and ``smoke_variant`` are the reference's, value
for value, so a configuration means the same model in both packages;
``torch_dtype`` takes the place of ``jnp_dtype``. The registry holds the
reference's ten architectures, and ``models.lm`` runs all ten.

Block kinds:
    "attn"    full (causal) self-attention + FFN
    "local"   sliding-window self-attention + FFN
    "rec"     RG-LRU recurrent block (Griffin) + FFN
    "rwkv"    RWKV6 time-mix + channel-mix
    "enc"     bidirectional encoder attention + FFN (whisper encoder)
    "dec"     causal self-attn + cross-attn + FFN (whisper decoder)
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable

import torch


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    source: str = ""

    # -- attention / block layout --
    block_pattern: tuple = ("attn",)
    window_size: int = 4096           # sliding window for "local" blocks
    rope_theta: float = 10000.0
    pos_embedding: str = "rope"       # rope | learned | none
    max_seq_len: int = 131072

    # -- MLP --
    activation: str = "silu"          # silu | gelu | sqrelu | relu
    gated_mlp: bool = True

    # -- MoE --
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_dense_residual: bool = False
    dense_ff_dim: int = 0
    moe_impl: str = "sort"
    moe_group_size: int = 0

    # -- SSM / hybrid --
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 0
    rglru_width: int = 0              # 0 -> d_model
    conv1d_width: int = 4
    rglru_c: float = 8.0

    # -- encoder-decoder (whisper) --
    n_encoder_layers: int = 0
    encoder_seq_len: int = 1500

    # -- VLM --
    n_image_tokens: int = 0

    # -- numerics / impl --
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    attn_impl: str = "einsum"         # einsum | chunked: the same function
    attn_chunk_size: int = 1024
    remat: bool = False
    scan_layers: bool = True
    long_context_local: bool = False

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.resolved_head_dim

    @property
    def n_units(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def remainder_pattern(self) -> tuple:
        rem = self.n_layers % len(self.block_pattern)
        return self.block_pattern[:rem]

    @property
    def is_attention_free(self) -> bool:
        return all(k in ("rwkv",) for k in self.block_pattern)

    @property
    def supports_long_context(self) -> bool:
        """True iff no block requires *full* attention over the sequence."""
        kinds = set(self.block_pattern) | set(self.remainder_pattern)
        if kinds <= {"rwkv", "rec", "local"}:
            return True
        if kinds <= {"rwkv", "rec", "local", "attn"} and self.long_context_local:
            return True
        return False

    @property
    def has_decode(self) -> bool:
        return True

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, ff = self.d_model, self.d_ff
        qd, kvd = self.q_dim, self.kv_dim
        per_kind: dict[str, int] = {}
        attn_p = d * qd + 2 * d * kvd + qd * d + d  # q,k,v,o + norm
        ffn_dense = d * ff * (3 if self.gated_mlp else 2) + d
        if self.n_experts:
            ffn_moe = (d * self.n_experts
                       + self.n_experts * d * ff * (3 if self.gated_mlp else 2) + d)
            if self.moe_dense_residual:
                dff = self.dense_ff_dim or ff
                ffn_moe += d * dff * (3 if self.gated_mlp else 2)
            ffn = ffn_moe
        else:
            ffn = ffn_dense
        per_kind["attn"] = attn_p + ffn
        per_kind["local"] = attn_p + ffn
        per_kind["enc"] = attn_p + ffn
        per_kind["dec"] = attn_p + (d * qd + 2 * d * kvd + qd * d + d) + ffn
        w = self.rglru_width or d
        per_kind["rec"] = (2 * d * w + w * self.conv1d_width + w + 2 * w * w + 2 * w + w
                           + w * d + d * ff * 3 + 2 * d)
        per_kind["rwkv"] = (5 * d * d + 5 * (d * 32 + 32 * d) + d * 64 + 64 * d
                            + d * ff + ff * d + d * d + 10 * d)
        total = self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d
        pattern = list(self.block_pattern) * self.n_units + list(self.remainder_pattern)
        for kind in pattern:
            total += per_kind[kind]
        if self.n_encoder_layers:
            total += self.n_encoder_layers * (attn_p + ffn_dense)
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        n_ffn_mats = 3 if self.gated_mlp else 2
        inactive = (self.n_experts - self.top_k) * d * ff * n_ffn_mats
        n_moe_layers = sum(
            1 for k in (list(self.block_pattern) * self.n_units + list(self.remainder_pattern))
            if k in ("attn", "local")
        )
        return int(self.param_count() - n_moe_layers * inactive)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}
_SMOKE_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(arch_id: str, config_fn: Callable[[], ModelConfig],
             smoke_fn: Callable[[], ModelConfig]):
    _REGISTRY[arch_id] = config_fn
    _SMOKE_REGISTRY[arch_id] = smoke_fn


def get_config(arch_id: str) -> ModelConfig:
    _ensure_loaded()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; the port has: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]()


def get_smoke_config(arch_id: str) -> ModelConfig:
    _ensure_loaded()
    if arch_id not in _SMOKE_REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; the port has: {sorted(_REGISTRY)}")
    return _SMOKE_REGISTRY[arch_id]()


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    # import the per-arch modules for their registration side effects
    if _REGISTRY:
        return
    from repro_torch.configs import (  # noqa: F401
        arctic_480b,
        dbrx_132b,
        deepseek_67b,
        gemma3_12b,
        internvl2_2b,
        llama3_405b,
        nemotron_4_15b,
        recurrentgemma_2b,
        rwkv6_1_6b,
        whisper_large_v3,
    )


def long_context_variant(cfg: ModelConfig) -> ModelConfig:
    """Long-context decode variant: full-attention blocks degrade to
    sliding-window so a 500k cache stays sub-quadratic (used only for the
    ``long_500k`` shape when ``cfg.long_context_local``)."""
    if not cfg.long_context_local:
        return cfg
    pattern = tuple("local" if k == "attn" else k for k in cfg.block_pattern)
    return replace(cfg, block_pattern=pattern)


def smoke_variant(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced config of the same family: 2 layers, d_model<=256, fp32."""
    pattern = cfg.block_pattern
    kw = dict(
        d_model=min(cfg.d_model, 256),
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=32,
        d_ff=min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 1024),
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        capacity_factor=8.0 if cfg.n_experts else cfg.capacity_factor,
        dense_ff_dim=min(cfg.dense_ff_dim, 256) if cfg.dense_ff_dim else 0,
        rwkv_head_dim=32,
        rglru_width=min(cfg.rglru_width, 256) if cfg.rglru_width else 0,
        n_encoder_layers=2 if cfg.n_encoder_layers else 0,
        encoder_seq_len=16 if cfg.n_encoder_layers else cfg.encoder_seq_len,
        n_image_tokens=8 if cfg.n_image_tokens else 0,
        window_size=min(cfg.window_size, 8),
        max_seq_len=128,
        attn_chunk_size=16,
        dtype="float32",
    )
    # keep the *family pattern*: 2 layers drawn from the same repeating unit
    kw["block_pattern"] = tuple(pattern[:2]) if len(pattern) >= 2 else pattern
    kw["n_layers"] = 2
    kw.update(overrides)
    return replace(cfg, **kw)
