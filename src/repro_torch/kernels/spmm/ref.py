"""Plain PyTorch versions of the SpMM kernels' functions (the block kernel
and the sparse route's pair).

The CPU tests run these, and ``chip_smoke.py`` holds the CUDA kernel
against them on the card. ``spmm_ref`` is the twin of the reference's
``ref.py`` (a dense product); ``spmm_nonzeros_ref`` is what CPU tensors take
in ``ops.block_spmm``, and ``ell_spmm_ref`` / ``ell_spmm_t_ref`` what they
take on the sparse route (``ops.sparse_spmm``). On CUDA tensors nothing on
the main path calls them.
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


def ell_spmm_ref(x: torch.Tensor, nbr_idx: torch.Tensor,
                 nbr_mask: torch.Tensor) -> torch.Tensor:
    """The sparse route's forward (``csrc/spmm_sparse.cu``,
    ``spmm_ell_kernel``) as plain ops, in the kernel's order: for each slot
    s in turn, ``acc + mask[:, s] * x[idx[:, s]]`` where the mask is not 0
    (a dead slot's row is never used), and ``deg + mask[:, s]``; then
    ``acc / max(deg, 1)``. Every operation rounds once, as the kernel's do,
    so on the card the two give the same bits. Differentiable in ``x``."""
    n, k = nbr_idx.shape
    acc = torch.zeros((n, x.shape[1]), dtype=torch.float32, device=x.device)
    deg = torch.zeros((n,), dtype=torch.float32, device=x.device)
    for s in range(k):
        m = nbr_mask[:, s].to(torch.float32)
        live = (m != 0)[:, None]
        rows = torch.where(m != 0, nbr_idx[:, s].long(), 0)
        acc = torch.where(live, acc + m[:, None] * x[rows].to(torch.float32), acc)
        deg = deg + m
    return acc / torch.clamp(deg, min=1.0)[:, None]


def ell_spmm_t_ref(dy: torch.Tensor, rows: torch.Tensor, w: torch.Tensor,
                   ptr: torch.Tensor, m: int) -> torch.Tensor:
    """The sparse route's transposed launch (``spmm_ell_t_kernel``) as plain
    ops: dX (m, D), row j the sum of ``w[p] * dy[rows[p]]`` over the entries
    ``ptr[j] <= p < ptr[j + 1]`` of the column-sorted operand
    (``ops.column_sorted``), in entry order from 0. It adds the entries of
    rank r within their column for r = 0, 1, ... (each column once a step),
    so every add is one rounding in the kernel's order, on any device."""
    d = dy.shape[1]
    out = torch.zeros((m, d), dtype=torch.float32, device=dy.device)
    ptr = ptr.long()
    counts = ptr[1:] - ptr[:-1]
    n_live = int(ptr[-1]) if m else 0
    if n_live == 0 or d == 0:
        return out
    col = torch.repeat_interleave(torch.arange(m, device=dy.device), counts)
    rank = torch.arange(n_live, device=dy.device) - ptr[col]
    r_rows, r_w = rows[:n_live].long(), w[:n_live].to(torch.float32)
    for r in range(int(counts.max())):
        at = torch.nonzero(rank == r, as_tuple=True)[0]
        out.index_add_(0, col[at], r_w[at, None] * dy[r_rows[at]].to(torch.float32))
    return out
