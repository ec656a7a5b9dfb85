"""The four input shapes and the stand-ins of a step's inputs (port of
``repro/configs/shapes.py``).

Decode shapes describe ``serve_step``: ONE new token against a KV cache /
recurrent state of ``seq_len``. ``long_500k`` requires sub-quadratic
attention; ``shape_applicable`` decides. ``input_specs`` gives meta
tensors (shape and dtype, no storage) where the reference gives
``jax.ShapeDtypeStruct``s; ``concrete_inputs`` draws small inputs from a
``torch.Generator`` where the reference takes a key.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg, shape: InputShape) -> tuple[bool, str]:
    """(runs?, reason-if-skip)."""
    if shape.name == "long_500k":
        if not cfg.supports_long_context:
            return False, (
                f"{cfg.arch_id}: pure full-attention family — 500k decode would need "
                "a quadratic-cost full cache; skipped"
            )
    if shape.kind == "decode" and not cfg.has_decode:
        return False, f"{cfg.arch_id}: encoder-only, no decode step"
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg, shape: InputShape) -> dict:
    """Meta-tensor stand-ins for every model *data* input of the step.

    train:   {tokens (B,S) i32, labels (B,S) i32 [, image_embeds, enc_frames]}
    prefill: {tokens (B,S) i32 [, image_embeds, enc_frames]}
    decode:  {tokens (B,1) i32, pos () i32}
    """
    B, S = shape.global_batch, shape.seq_len
    dt = cfg.torch_dtype
    if shape.kind == "train":
        specs = {"tokens": _meta((B, S), torch.int32), "labels": _meta((B, S), torch.int32)}
    elif shape.kind == "prefill":
        specs = {"tokens": _meta((B, S), torch.int32)}
    else:  # decode
        specs = {"tokens": _meta((B, 1), torch.int32), "pos": _meta((), torch.int32)}
    if cfg.n_image_tokens and shape.kind != "decode":
        specs["image_embeds"] = _meta((B, cfg.n_image_tokens, cfg.d_model), dt)
    if cfg.n_encoder_layers and shape.kind != "decode":
        specs["enc_frames"] = _meta((B, cfg.encoder_seq_len, cfg.d_model), dt)
    return specs


def concrete_inputs(cfg, shape: InputShape, generator: torch.Generator | None = None) -> dict:
    """Small-scale concrete inputs for smoke runs (use with smoke configs),
    drawn from ``generator`` on its device (a CPU generator seeded 0 if
    none is given)."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    dev = gen.device
    B, S = shape.global_batch, shape.seq_len
    V = cfg.vocab_size
    out = {}
    if shape.kind in ("train", "prefill"):
        out["tokens"] = torch.randint(0, V, (B, S), generator=gen, device=dev,
                                      dtype=torch.int32)
        if shape.kind == "train":
            out["labels"] = torch.randint(0, V, (B, S), generator=gen, device=dev,
                                          dtype=torch.int32)
    else:
        out["tokens"] = torch.randint(0, V, (B, 1), generator=gen, device=dev,
                                      dtype=torch.int32)
        out["pos"] = torch.tensor(S - 1, dtype=torch.int32, device=dev)

    def normal(*s):
        w = torch.randn(s, generator=gen, device=dev)
        return (w * 0.02).to(cfg.torch_dtype)

    if cfg.n_image_tokens and shape.kind != "decode":
        out["image_embeds"] = normal(B, cfg.n_image_tokens, cfg.d_model)
    if cfg.n_encoder_layers and shape.kind != "decode":
        out["enc_frames"] = normal(B, cfg.encoder_seq_len, cfg.d_model)
    return out
