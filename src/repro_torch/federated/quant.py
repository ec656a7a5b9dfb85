"""Quantized wire format for historical-embedding exchanges, on tensors.

Port of ``repro/federated/quant.py`` (bit-exact against it on the CPU,
tests/test_torch_host.py):

* ``"fp32"`` — identity: ``encode``/``decode`` return their input object.
* ``"bf16"`` — truncate to bfloat16 on the wire, widen back to fp32.
* ``"int8"`` — per-row symmetric quantization over the LAST axis:
  ``scale = amax / 127`` per row, codes rounded half-to-even
  (``torch.round``) and clipped to [-127, 127], decoded as
  ``code * scale``. All-zero rows get scale 0 and decode to exact zeros.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "SYNC_DTYPES",
    "check_sync_dtype",
    "decode",
    "encode",
    "quant_roundtrip",
    "wire_bytes",
]

SYNC_DTYPES = ("fp32", "bf16", "int8")

# bytes per element on the wire (int8 additionally pays 4 B/row of scale)
_ELEM_BYTES = {"fp32": 4, "bf16": 2, "int8": 1}


def check_sync_dtype(dtype):
    """Validate a wire dtype string (returns it for chaining)."""
    if dtype not in SYNC_DTYPES:
        raise ValueError(
            f"sync dtype must be one of {SYNC_DTYPES}, got {dtype!r}")
    return dtype


def encode(x: torch.Tensor, dtype):
    """Encode fp32 ``x`` for the wire -> ``(payload, scale_or_None)``.

    ``scale`` is a fp32 tensor of shape ``x.shape[:-1] + (1,)`` for int8
    and ``None`` otherwise. For fp32 this is the identity.
    """
    check_sync_dtype(dtype)
    if dtype == "fp32":
        return x, None
    if dtype == "bf16":
        return x.to(torch.bfloat16), None
    if x.ndim == 0:
        amax = x.abs()
    elif x.shape[-1] == 0:
        amax = x.new_zeros(x.shape[:-1] + (1,))
    else:
        amax = x.abs().amax(dim=-1, keepdim=True)
    scale = (amax / 127.0).to(torch.float32)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / safe), -127.0, 127.0).to(torch.int8)
    return q, scale


def decode(payload: torch.Tensor, scale, dtype):
    """Widen a wire payload back to fp32 (identity for fp32)."""
    check_sync_dtype(dtype)
    if dtype == "fp32":
        return payload
    if dtype == "bf16":
        return payload.to(torch.float32)
    return payload.to(torch.float32) * scale


def quant_roundtrip(x: torch.Tensor, dtype):
    """``decode(encode(x))`` — the value the receiver sees (``x`` itself
    for fp32)."""
    if dtype == "fp32":
        return x
    payload, scale = encode(x, dtype)
    return decode(payload, scale, dtype)


def wire_bytes(shape, dtype):
    """Bytes a fp32 array of ``shape`` occupies on the wire at ``dtype``;
    int8 charges one fp32 scale per leading-axes row (a 0-d payload is its
    own row)."""
    check_sync_dtype(dtype)
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape)) if shape else 1
    total = n * _ELEM_BYTES[dtype]
    if dtype == "int8":
        rows = int(np.prod(shape[:-1])) if shape else 1
        total += rows * 4
    return int(total)
