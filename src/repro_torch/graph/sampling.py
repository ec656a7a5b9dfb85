"""Centralized graph-sampling strategies (related-work section of the
paper; a numpy copy of ``repro/graph/sampling.py``: the same arrays for the
same ``np.random.Generator``).

The three classical families the paper contrasts with — node-wise
(GraphSAGE), layer-wise (FastGCN) and subgraph (ClusterGCN-style) — on the
padded neighbor-list form.
"""
from __future__ import annotations

import numpy as np


def node_wise_sample(nbr_idx, nbr_mask, fanout: int, rng: np.random.Generator):
    """GraphSAGE-style: keep <= fanout random neighbors per node."""
    n, K = nbr_idx.shape
    if fanout >= K:
        return nbr_idx, nbr_mask
    scores = rng.random((n, K)) * nbr_mask - (1.0 - nbr_mask)
    keep = np.argsort(-scores, axis=1)[:, :fanout]
    new_idx = np.take_along_axis(nbr_idx, keep, axis=1)
    new_mask = np.take_along_axis(nbr_mask, keep, axis=1)
    return new_idx.astype(np.int32), new_mask.astype(np.float32)


def layer_wise_sample(nbr_idx, nbr_mask, n_nodes: int, budget: int, rng: np.random.Generator):
    """FastGCN-style: sample a per-layer node budget by (approx) importance
    q(v) ∝ deg(v); neighbors outside the layer sample are masked."""
    deg = nbr_mask.sum(-1) + 1e-6
    q = deg / deg.sum()
    chosen = rng.choice(n_nodes, size=min(budget, n_nodes), replace=False, p=q)
    in_layer = np.zeros(n_nodes, bool)
    in_layer[chosen] = True
    new_mask = nbr_mask * in_layer[nbr_idx]
    return nbr_idx, new_mask.astype(np.float32)


def subgraph_sample(edges: np.ndarray, n_nodes: int, n_parts: int, rng: np.random.Generator):
    """ClusterGCN-style: random-hash partition into n_parts; returns the
    node partition id per node (true METIS is out of scope)."""
    return rng.integers(0, n_parts, size=n_nodes).astype(np.int32)
