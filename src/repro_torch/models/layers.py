"""Initialisers (port of ``repro/models/layers.py``'s ``dense_init``)."""
from __future__ import annotations

import torch


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32) -> torch.Tensor:
    """(d_in, d_out) normal draws scaled by ``sqrt(2 / (d_in + d_out))``,
    drawn on the CPU from ``generator`` (so a seed gives the same values
    whatever device the caller moves them to)."""
    scale = (2.0 / (d_in + d_out)) ** 0.5
    w = torch.randn((d_in, d_out), generator=generator, dtype=torch.float32)
    return (w * scale).to(dtype)
