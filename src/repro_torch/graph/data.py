"""Synthetic graph datasets mirroring the paper's Table 1 statistics.

A numpy copy of ``repro/graph/data.py`` (which imports jax through
``repro.utils.tree``): the same seed gives the same arrays, bit for bit
(pinned by tests/test_torch_host.py).

The five public datasets (Coauthor/Pubmed/Yelp/Reddit/Amazon2M) are not
available offline, so we generate class-structured stochastic block model
graphs matched to each dataset's *published statistics* — node count (scaled
by ``scale``), average degree, feature dim (capped), class count and split
fractions — with Gaussian-mixture features so GCNs are actually learnable.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.utils.tree import stable_hash


@dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_nodes: int          # Table 1 |V|
    n_edges: int          # Table 1 |E|
    n_features: int
    n_classes: int
    train_frac: float
    val_frac: float
    test_frac: float


# Table 1 of the paper, verbatim.
DATASET_SPECS: dict[str, DatasetSpec] = {
    "coauthor": DatasetSpec("coauthor", 18_333, 163_788, 6_805, 15, 0.8, 0.1, 0.1),
    "pubmed": DatasetSpec("pubmed", 19_717, 88_648, 500, 3, 0.8, 0.1, 0.1),
    "yelp": DatasetSpec("yelp", 716_847, 13_954_819, 300, 100, 0.75, 0.10, 0.15),
    "reddit": DatasetSpec("reddit", 232_965, 114_615_892, 602, 41, 0.66, 0.10, 0.24),
    "amazon2m": DatasetSpec("amazon2m", 2_449_029, 61_859_140, 100, 47, 0.8, 0.1, 0.1),
}


@dataclass
class GraphData:
    name: str
    features: np.ndarray       # (N, F) float32
    labels: np.ndarray         # (N,) int32
    edges: np.ndarray          # (E, 2) int32, undirected (each edge once)
    n_classes: int
    train_mask: np.ndarray     # (N,) bool
    val_mask: np.ndarray
    test_mask: np.ndarray
    spec: DatasetSpec

    @property
    def n_nodes(self) -> int:
        return self.features.shape[0]

    @property
    def n_features(self) -> int:
        return self.features.shape[1]

    def adjacency_lists(self) -> list[list[int]]:
        adj: list[list[int]] = [[] for _ in range(self.n_nodes)]
        for u, v in self.edges:
            adj[u].append(int(v))
            adj[v].append(int(u))
        return adj


def make_dataset(
    name: str,
    *,
    scale: int = 64,
    max_features: int = 128,
    homophily: float = 0.75,
    feature_noise: float = 3.0,
    seed: int = 0,
) -> GraphData:
    """Generate a synthetic stand-in for dataset ``name`` at 1/scale size."""
    spec = DATASET_SPECS[name]
    # stable_hash, NOT hash(): str hashes are salted per-process, so hash(name)
    # regenerated a *different* dataset in every fresh interpreter — the
    # "cross-process nondeterminism" of seeded runs traced back to here.
    rng = np.random.default_rng(seed * 977 + stable_hash(name) % 10_000)

    n = max(256, spec.n_nodes // scale)
    f = min(spec.n_features, max_features)
    c = spec.n_classes
    avg_deg = min(2.0 * spec.n_edges / spec.n_nodes, 64.0)  # cap for memory

    # labels: mildly imbalanced class proportions
    class_p = rng.dirichlet(np.ones(c) * 5.0)
    labels = rng.choice(c, size=n, p=class_p).astype(np.int32)

    # features: Gaussian mixture around per-class means
    means = rng.standard_normal((c, f)).astype(np.float32) * 1.5
    features = means[labels] + rng.standard_normal((n, f)).astype(np.float32) * feature_noise

    # edges: degree-corrected SBM-ish sampling. Draw endpoints with a
    # power-lawish degree propensity; accept same-class pairs w.p. homophily.
    target_edges = int(n * avg_deg / 2)
    prop = rng.pareto(2.5, size=n) + 1.0
    prop /= prop.sum()
    src = rng.choice(n, size=target_edges * 3, p=prop)
    dst = rng.choice(n, size=target_edges * 3, p=prop)
    same = labels[src] == labels[dst]
    accept = np.where(same, homophily, 1.0 - homophily) > rng.random(len(src))
    ok = accept & (src != dst)
    edges = np.stack([src[ok], dst[ok]], axis=1)
    # dedupe (undirected)
    lo = edges.min(1)
    hi = edges.max(1)
    uniq = np.unique(lo.astype(np.int64) * n + hi)
    edges = np.stack([uniq // n, uniq % n], axis=1).astype(np.int32)
    if len(edges) > target_edges:
        edges = edges[rng.permutation(len(edges))[:target_edges]]

    # splits
    order = rng.permutation(n)
    n_train = int(spec.train_frac * n)
    n_val = int(spec.val_frac * n)
    train_mask = np.zeros(n, bool)
    val_mask = np.zeros(n, bool)
    test_mask = np.zeros(n, bool)
    train_mask[order[:n_train]] = True
    val_mask[order[n_train : n_train + n_val]] = True
    test_mask[order[n_train + n_val :]] = True

    return GraphData(
        name=name, features=features, labels=labels, edges=edges, n_classes=c,
        train_mask=train_mask, val_mask=val_mask, test_mask=test_mask, spec=spec,
    )


def downsample_edges(graph: GraphData, keep: float = 0.5, seed: int = 0) -> GraphData:
    """Paper: 'we downsample the edges in local subgraphs by 50%'."""
    rng = np.random.default_rng(seed)
    m = rng.random(len(graph.edges)) < keep
    return GraphData(
        name=graph.name, features=graph.features, labels=graph.labels,
        edges=graph.edges[m], n_classes=graph.n_classes,
        train_mask=graph.train_mask, val_mask=graph.val_mask,
        test_mask=graph.test_mask, spec=graph.spec,
    )
