"""Adaptive importance-based sampling (paper Eq. 7-8).

Port of ``repro/core/importance.py``. The optimal per-node sampling
probability minimising gradient variance (Eq. 7) is p_v ∝ ||∇f_v||; the
paper's O(n_k) proxy is the loss *difference* between two consecutive local
model updates, with p_v = ||Δ_j|| / Σ ||Δ_j|| (Eq. 8).

The discrete decisions are exact against the reference given the same
uniforms: keys are mantissa-quantized (``quantize_key``) and ordered by a
*stable* sort, ties going to the lower index, as ``lax.top_k`` orders them
(never ``torch.topk``, whose tie order is unspecified). The uniforms come
from the caller (``core.fedais``' draw provider), not from a generator
here.
"""
from __future__ import annotations

import torch


def loss_delta_scores(loss_curr: torch.Tensor, loss_prev: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """|Δ_j| per node, masked. Nodes never seen (prev < 0 sentinel) fall back
    to their current loss so cold-start nodes are still sampled."""
    delta = torch.abs(loss_curr - loss_prev)
    scores = torch.where(loss_prev < 0.0, torch.abs(loss_curr), delta)
    return scores * mask


def importance_probs(scores: torch.Tensor, mask: torch.Tensor, *,
                     floor: float = 1e-8) -> torch.Tensor:
    """Normalise scores into selection probabilities (Eq. 8), with a tiny
    uniform floor that keeps every training node reachable."""
    s = scores * mask + floor * mask
    return s / torch.clamp(s.sum(), min=1e-30)


QUANTIZE_DROP_BITS = 12   # float32 mantissa bits zeroed from the sampling key


def quantize_key(x: torch.Tensor, drop_bits: int = QUANTIZE_DROP_BITS) -> torch.Tensor:
    """Zero the low ``drop_bits`` mantissa bits of a float32 tensor, so keys
    that differ only in their last ULPs land on one grid point."""
    keep = ~((1 << drop_bits) - 1)                  # as int32: 0xFFFFF000
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return (bits & keep).view(torch.float32)


def stable_rank(keys: torch.Tensor) -> torch.Tensor:
    """Ascending stable rank of every last-axis slot of the quantized keys:
    the position slot i takes when they sort ascending, ties to the lower
    index (``argsort(q).argsort()`` with a stable sort)."""
    order = torch.sort(quantize_key(keys), dim=-1, stable=True).indices
    ranks = torch.arange(keys.shape[-1], device=keys.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, ranks)


def sample_batch(uniform: torch.Tensor, probs: torch.Tensor, batch_size: int,
                 mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``batch_size`` distinct node indices with P(v) ∝ probs (Gumbel top-k
    over ``uniform``, draws in [1e-20, 1) shaped like ``probs``). Returns
    (idx (b,) int64, valid (b,) bool); masked entries never win unless the
    client is smaller than the batch (then they come back invalid)."""
    logp = torch.log(torch.clamp(probs, min=1e-30)) + torch.where(mask > 0, 0.0, -1e30)
    g = -torch.log(-torch.log(uniform))
    key = quantize_key(logp + g)
    idx = torch.sort(key, descending=True, stable=True).indices[:batch_size]
    return idx, mask[idx] > 0


def uniform_probs(mask: torch.Tensor) -> torch.Tensor:
    return mask / torch.clamp(mask.sum(), min=1.0)


def sampling_variance(probs: torch.Tensor, grad_norms: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """The Eq. (7) objective: Σ ||∇f_v||² / p_v over valid nodes."""
    return torch.sum(mask * torch.square(grad_norms) / torch.clamp(probs, min=1e-30))
