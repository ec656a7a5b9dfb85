"""Padded neighbor-list representation of the adjacency.

Port of ``repro/graph/csr.py``. ``build_padded_neighbors``,
``csr_from_padded`` and ``degree_stats`` are numpy copies (bit-equal
arrays for equal inputs); ``bucketed_csr_from_padded`` works on tensors,
on the device its inputs live on.
"""
from __future__ import annotations

import numpy as np
import torch


def build_padded_neighbors(
    adj: list[list[int]],
    max_deg: int | None = None,
    *,
    cap: int = 64,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """adjacency lists -> (nbr_idx (n, K) int32, nbr_mask (n, K) float32).

    Nodes with more than K neighbors get a uniform random subset (the paper
    caps sampled neighbors at 10 anyway); padding rows point at 0 with mask 0.
    """
    rng = np.random.default_rng(seed)
    n = len(adj)
    if max_deg is None:
        max_deg = min(cap, max((len(a) for a in adj), default=1) or 1)
    idx = np.zeros((n, max_deg), np.int32)
    mask = np.zeros((n, max_deg), np.float32)
    for i, nbrs in enumerate(adj):
        if not nbrs:
            continue
        if len(nbrs) > max_deg:
            # sorted, so slot order is canonical for a given (adj, seed)
            nbrs = np.sort(rng.choice(nbrs, size=max_deg, replace=False))
        idx[i, : len(nbrs)] = nbrs
        mask[i, : len(nbrs)] = 1.0
    return idx, mask


def csr_from_padded(nbr_idx: np.ndarray, nbr_mask: np.ndarray) -> dict:
    """Flatten a padded (n, K) neighbor list into CSR-style edge arrays.

    Returns ``{"src": (E,) int32, "dst": (E,) int32, "inv_deg": (n,) float32}``
    holding only the E real edges (mask > 0), ordered row-major (dst
    non-decreasing, slots in list order).
    """
    idx = np.asarray(nbr_idx)
    real = np.asarray(nbr_mask) > 0
    dst, slot = np.nonzero(real)
    deg = real.sum(-1)
    return {
        "src": idx[dst, slot].astype(np.int32),
        "dst": dst.astype(np.int32),
        "inv_deg": (1.0 / np.maximum(deg, 1)).astype(np.float32),
    }


def bucketed_csr_from_padded(nbr_idx: torch.Tensor,
                             nbr_mask: torch.Tensor) -> dict:
    """Fixed-shape bucketed CSR: every (row, slot) pair becomes an edge slot.

    Returns ``{"src": (n*K,) int32, "dst": (n*K,) int32, "inv_deg": (n,)
    float32}``. Padding slots route to an overflow segment ``n`` with src
    clamped to 0; real edges keep ``csr_from_padded``'s row-major order.
    Each row owns exactly K contiguous slots, which is what lets the
    segment backend sum them as a fixed-order ``(n, K, d)`` reduction.
    """
    n, k = nbr_idx.shape
    real = nbr_mask > 0
    src = torch.where(real, nbr_idx, 0).reshape(-1).to(torch.int32)
    rows = torch.arange(n, dtype=torch.int32,
                        device=nbr_idx.device)[:, None].expand(n, k)
    dst = torch.where(real, rows, n).reshape(-1).to(torch.int32)
    deg = real.sum(-1)
    return {
        "src": src,
        "dst": dst,
        "inv_deg": (1.0 / torch.clamp(deg, min=1)).to(torch.float32),
    }


def degree_stats(mask: np.ndarray) -> dict:
    deg = mask.sum(-1)
    return {
        "mean": float(deg.mean()),
        "max": float(deg.max()),
        "isolated_frac": float((deg == 0).mean()),
    }
