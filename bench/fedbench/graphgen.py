"""The traffic generator of the FedAIS cells: a graph, its federated
partition and the server's eval neighbour lists, all numpy, from seeds.

The benchmark makes these inputs itself and hands the same arrays to the
program (wrapped in the program's own ``GraphData`` / ``FederatedGraph``
records) and to the plain reference. The arithmetic is a copy of the
program's host generators (``repro_torch.graph.data.make_dataset``,
``repro_torch.federated.partition.partition_graph``,
``repro_torch.graph.csr.build_padded_neighbors``), so a seed gives the graph
the program's own examples would build; nothing here imports the program.

Table 1 of the FedAIS paper (arXiv:2409.14655) gives each dataset's nodes,
edges, features and classes; no dataset is available offline, so the graph
is a degree-corrected stochastic block model matched to those statistics,
with Gaussian-mixture features. Unlike the program's generator, the class
means' scale is a parameter (the program fixes it at 1.5): each
configuration states its homophily, noise and class-mean scale, calibrated
so that the features are not all but separable.
"""
from __future__ import annotations

import numpy as np


def stable_hash(s: str) -> int:
    """Deterministic 32-bit FNV-1a hash of a string."""
    h = 2166136261
    for c in s.encode():
        h = ((h ^ c) * 16777619) & 0xFFFFFFFF
    return h


def make_graph(name: str, *, n_nodes: int, n_edges: int, n_features: int,
               n_classes: int, splits: tuple, scale: int = 1, max_features: int,
               homophily: float = 0.75, feature_noise: float = 3.0,
               mean_scale: float = 1.5, seed: int = 0) -> dict:
    """A synthetic stand-in for dataset ``name``: features (N, F) fp32,
    labels (N,) int32, undirected edges (E, 2) int32 (each once), and the
    train / val / test masks."""
    train_frac, val_frac, _ = splits
    rng = np.random.default_rng(seed * 977 + stable_hash(name) % 10_000)
    n = max(256, n_nodes // scale)
    f = min(n_features, max_features)
    c = n_classes
    avg_deg = min(2.0 * n_edges / n_nodes, 64.0)

    class_p = rng.dirichlet(np.ones(c) * 5.0)
    labels = rng.choice(c, size=n, p=class_p).astype(np.int32)
    means = rng.standard_normal((c, f)).astype(np.float32) * mean_scale
    features = means[labels] + rng.standard_normal((n, f)).astype(np.float32) * feature_noise

    target_edges = int(n * avg_deg / 2)
    prop = rng.pareto(2.5, size=n) + 1.0
    prop /= prop.sum()
    src = rng.choice(n, size=target_edges * 3, p=prop)
    dst = rng.choice(n, size=target_edges * 3, p=prop)
    same = labels[src] == labels[dst]
    accept = np.where(same, homophily, 1.0 - homophily) > rng.random(len(src))
    ok = accept & (src != dst)
    edges = np.stack([src[ok], dst[ok]], axis=1)
    lo, hi = edges.min(1), edges.max(1)
    uniq = np.unique(lo.astype(np.int64) * n + hi)
    edges = np.stack([uniq // n, uniq % n], axis=1).astype(np.int32)
    if len(edges) > target_edges:
        edges = edges[rng.permutation(len(edges))[:target_edges]]

    order = rng.permutation(n)
    n_train, n_val = int(train_frac * n), int(val_frac * n)
    masks = {k: np.zeros(n, bool) for k in ("train_mask", "val_mask", "test_mask")}
    masks["train_mask"][order[:n_train]] = True
    masks["val_mask"][order[n_train:n_train + n_val]] = True
    masks["test_mask"][order[n_train + n_val:]] = True
    return {"name": name, "features": features, "labels": labels, "edges": edges,
            "n_classes": c, **masks}


def adjacency_lists(edges: np.ndarray, n: int) -> list:
    adj: list = [[] for _ in range(n)]
    for u, v in edges:
        adj[u].append(int(v))
        adj[v].append(int(u))
    return adj


def padded_neighbors(adj: list, max_deg: int, seed: int) -> tuple:
    """(nbr_idx (n, max_deg) int32, nbr_mask (n, max_deg) fp32): a node with
    more neighbours than ``max_deg`` keeps a uniform subset, sorted."""
    rng = np.random.default_rng(seed)
    n = len(adj)
    idx = np.zeros((n, max_deg), np.int32)
    mask = np.zeros((n, max_deg), np.float32)
    for i, nbrs in enumerate(adj):
        if not nbrs:
            continue
        if len(nbrs) > max_deg:
            nbrs = np.sort(rng.choice(nbrs, size=max_deg, replace=False))
        idx[i, :len(nbrs)] = nbrs
        mask[i, :len(nbrs)] = 1.0
    return idx, mask


def partition(graph: dict, n_clients: int, *, alpha: float | None, max_deg: int = 32,
              edge_keep: float = 0.5, seed: int = 0) -> dict:
    """Split the graph over ``n_clients`` (Dirichlet(alpha) per class, or iid
    for ``alpha=None``), drop half of each client's inner edges (the paper's
    downsampling), and lay every client out padded: its own rows, then its
    ghost slots (neighbours held by other clients) at ``n_max + slot``."""
    rng = np.random.default_rng(seed)
    labels, feats_g = graph["labels"], graph["features"]
    n, c = len(labels), graph["n_classes"]
    assign = np.empty(n, np.int64)
    if alpha is None:
        assign[:] = rng.integers(0, n_clients, size=n)
    else:
        for cls in range(c):
            ids = np.where(labels == cls)[0]
            rng.shuffle(ids)
            p = rng.dirichlet(np.full(n_clients, alpha))
            counts = rng.multinomial(len(ids), p)
            assign[ids] = np.repeat(np.arange(n_clients), counts)

    client_nodes = [np.where(assign == k)[0] for k in range(n_clients)]
    n_max = max(1, max(len(v) for v in client_nodes))
    local_of = np.full(n, -1, np.int64)
    for ids in client_nodes:
        local_of[ids] = np.arange(len(ids))

    e = graph["edges"]
    same = assign[e[:, 0]] == assign[e[:, 1]]
    within, cross = e[same], e[~same]
    if edge_keep < 1.0 and len(within):
        within = within[rng.random(len(within)) < edge_keep]

    F = feats_g.shape[1]
    out = {"features": np.zeros((n_clients, n_max, F), np.float32),
           "labels": np.zeros((n_clients, n_max), np.int32),
           "node_mask": np.zeros((n_clients, n_max), np.float32),
           "train_mask": np.zeros((n_clients, n_max), np.float32),
           "val_mask": np.zeros((n_clients, n_max), np.float32),
           "global_ids": np.full((n_clients, n_max), -1, np.int32)}
    adj = [[[] for _ in range(n_max)] for _ in range(n_clients)]
    ghosts: list = [dict() for _ in range(n_clients)]

    def ghost_slot(k: int, gid: int) -> int:
        d = ghosts[k]
        if gid not in d:
            d[gid] = len(d)
        return d[gid]

    for u, v in within:
        k = assign[u]
        adj[k][local_of[u]].append(int(local_of[v]))
        adj[k][local_of[v]].append(int(local_of[u]))
    for u, v in cross:
        ku, kv = assign[u], assign[v]
        adj[ku][local_of[u]].append(n_max + ghost_slot(ku, int(v)))
        adj[kv][local_of[v]].append(n_max + ghost_slot(kv, int(u)))

    g_max = max(1, max(len(d) for d in ghosts))
    ghost_owner = np.full((n_clients, g_max), -1, np.int32)
    ghost_row = np.zeros((n_clients, g_max), np.int32)
    ghost_mask = np.zeros((n_clients, g_max), np.float32)
    nbr_idx = np.zeros((n_clients, n_max, max_deg), np.int32)
    nbr_mask = np.zeros((n_clients, n_max, max_deg), np.float32)
    for k in range(n_clients):
        ids = client_nodes[k]
        nk = len(ids)
        if nk:
            out["features"][k, :nk] = feats_g[ids]
            out["labels"][k, :nk] = labels[ids]
            out["node_mask"][k, :nk] = 1.0
            out["train_mask"][k, :nk] = graph["train_mask"][ids]
            out["val_mask"][k, :nk] = graph["val_mask"][ids]
            out["global_ids"][k, :nk] = ids
        for gid, slot in ghosts[k].items():
            ghost_owner[k, slot] = assign[gid]
            ghost_row[k, slot] = local_of[gid]
            ghost_mask[k, slot] = 1.0
        for i in range(nk):
            nbrs = adj[k][i]
            if not nbrs:
                continue
            if len(nbrs) > max_deg:
                nbrs = list(rng.choice(nbrs, size=max_deg, replace=False))
            nbr_idx[k, i, :len(nbrs)] = nbrs
            nbr_mask[k, i, :len(nbrs)] = 1.0
    out.update(n_clients=n_clients, n_max=n_max, g_max=g_max, max_deg=max_deg,
               nbr_idx=nbr_idx, nbr_mask=nbr_mask, ghost_owner=ghost_owner,
               ghost_row=ghost_row, ghost_mask=ghost_mask, n_classes=c,
               n_cross_edges=int(len(cross)))
    return out


def select_cohorts(seed: int, n_clients: int, m: int, rounds: int) -> list:
    """The cohorts of rounds 0 .. rounds - 1: uniform without replacement
    from a host generator seeded with ``seed``, one draw a round."""
    rng = np.random.default_rng(seed)
    return [rng.choice(n_clients, size=min(m, n_clients), replace=False)
            for _ in range(rounds)]
