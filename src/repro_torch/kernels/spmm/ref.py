"""Plain PyTorch versions of the block-sparse SpMM kernel's functions.

The CPU tests run these, and ``chip_smoke.py`` holds the CUDA kernel
against them on the card. ``spmm_ref`` is the twin of the reference's
``ref.py`` (a dense product); ``spmm_nonzeros_ref`` is what CPU tensors take
in ``ops.block_spmm``. On CUDA tensors nothing on the main path calls them.
"""
from __future__ import annotations

import torch


def spmm_ref(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X in fp32, cast back to x.dtype."""
    return (a.to(torch.float32) @ x.to(torch.float32)).to(x.dtype)


def spmm_nonzeros_ref(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X over the nonzeros of A only, in fp32, cast back to x.dtype.

    The plain version ``ops.block_spmm`` takes on CPU tensors. Like the
    CUDA kernel, it never forms 0·x, so a NaN or inf row k of X reaches
    exactly the rows of A with a nonzero in column k (the rule of the
    gather and segment backends too); on finite inputs it agrees with
    ``spmm_ref`` to fp32 rounding. Each row's products are added in column
    order (``index_add_`` on the CPU runs in order). Differentiable in
    ``x``.
    """
    rows, cols = torch.nonzero(a, as_tuple=True)
    prod = a[rows, cols].to(torch.float32)[:, None] * x[cols].to(torch.float32)
    y = torch.zeros((a.shape[0], x.shape[1]), dtype=torch.float32, device=x.device)
    return y.index_add(0, rows, prod).to(x.dtype)


def neighbor_mean_ref(features: torch.Tensor, nbr_idx: torch.Tensor,
                      nbr_mask: torch.Tensor) -> torch.Tensor:
    """Padded-neighbor-list mean aggregation: features (M, D); nbr_idx
    (N, K) into rows of features; nbr_mask (N, K) {0,1}. Returns (N, D),
    0 for isolated rows."""
    gathered = features[nbr_idx.long()] * nbr_mask[..., None]      # (N, K, D)
    deg = torch.clamp(nbr_mask.sum(-1, keepdim=True), min=1.0)
    return (gathered.sum(1) / deg).to(features.dtype)
