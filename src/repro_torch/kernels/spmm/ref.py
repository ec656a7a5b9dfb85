"""Plain PyTorch versions of the block-sparse SpMM kernel's functions.

The CPU tests run these, and ``chip_smoke.py`` holds the CUDA kernel
against them on the card. On CUDA tensors nothing on the main path calls
them.
"""
from __future__ import annotations

import torch


def spmm_ref(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X in fp32, cast back to x.dtype."""
    return (a.to(torch.float32) @ x.to(torch.float32)).to(x.dtype)


def neighbor_mean_ref(features: torch.Tensor, nbr_idx: torch.Tensor,
                      nbr_mask: torch.Tensor) -> torch.Tensor:
    """Padded-neighbor-list mean aggregation: features (M, D); nbr_idx
    (N, K) into rows of features; nbr_mask (N, K) {0,1}. Returns (N, D),
    0 for isolated rows."""
    gathered = features[nbr_idx.long()] * nbr_mask[..., None]      # (N, K, D)
    deg = torch.clamp(nbr_mask.sum(-1, keepdim=True), min=1.0)
    return (gathered.sum(1) / deg).to(features.dtype)
