"""Variance decomposition diagnostics (paper Eq. 3-5, Theorem 1; port of
``repro/core/variance.py``).

Total gradient-estimator variance splits into (a) embedding-approximation
variance from historical/stale inner-layer embeddings and (b) minibatch
sampling variance (Eq. 3). Theorem 1 bounds the layer-L output error by a
geometric sum over layers scaled by neighborhood size (Eq. 4), which via
lambda-smoothness bounds (a) (Eq. 5). These functions compute the bounds
and empirical estimates.
"""
from __future__ import annotations

import torch


def theorem1_bound(alpha1: float, alpha2: float, n_neighbors: float, n_layers: int) -> float:
    """Eq. (4): sum_{l=1}^{L-1} (a1 a2 |N(v)|)^(L-l)."""
    total = 0.0
    for l in range(1, n_layers):
        total += (alpha1 * alpha2 * n_neighbors) ** (n_layers - l)
    return total


def gradient_error_bound(lam: float, embedding_error: float) -> float:
    """Eq. (5): E||g_tilde - g|| <= lambda * ||h_tilde - h||."""
    return lam * embedding_error


def embedding_error(h_tilde: torch.Tensor, h_exact: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Mean L2 error of approximate vs exact embeddings over valid nodes."""
    err = torch.linalg.vector_norm((h_tilde - h_exact) * mask[..., None], dim=-1)
    return err.sum() / torch.clamp(mask.sum(), min=1.0)


def minibatch_variance(per_node_grad_proxy: torch.Tensor, probs: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Empirical Eq.-7 objective value for a given sampling distribution —
    lower is better; importance probs should beat uniform on skewed data."""
    p = torch.clamp(probs, min=1e-30)
    return (torch.sum(mask * torch.square(per_node_grad_proxy) / p)
            / torch.clamp(mask.sum(), min=1.0))


def estimator_variance(samples: torch.Tensor) -> torch.Tensor:
    """Variance of a stochastic estimator across repeated draws (axis 0)."""
    mean = samples.mean(0)
    return torch.mean(torch.sum(torch.square(samples - mean), dim=-1))
