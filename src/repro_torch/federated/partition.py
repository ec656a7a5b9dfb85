"""Intra-graph federated partition: split one global graph across K clients,
extract cross-client ("ghost") edges, and build fixed-shape per-client arrays
stacked over a leading client axis.

A numpy copy of ``repro/federated/partition.py:318-454`` (``FederatedGraph``,
``partition_graph``): the same graph and seed give the same arrays, bit for
bit (pinned by tests/test_torch_train_host.py).

Layout per client k (padded to the max over clients):
    features   (n_max, F)     own node features (rows >= n_k zero)
    labels     (n_max,)
    node_mask  (n_max,)       1 for real own nodes
    train_mask (n_max,)
    nbr_idx    (n_max, K)     neighbor slots; values < n_max index own rows,
                              values >= n_max index ghost slot (v - n_max)
    nbr_mask   (n_max, K)
    ghost_owner (g_max,)      owning client id (-1 pad)
    ghost_row   (g_max,)      row index within the owner's local arrays
    ghost_mask  (g_max,)

The combined embedding table a client sees is [own rows | ghost rows] of
size n_max + g_max — the paper's Eq. (6) split into within-client
in-batch / within-client out-of-batch / cross-client terms.

Still to port: the pod, ghost-exchange and write-back bucket builders
(``partition.py:30-316``), with the multi-device executors.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.graph.data import GraphData


@dataclass
class FederatedGraph:
    """All K clients stacked on a leading axis (numpy; moved to jax later)."""

    name: str
    n_clients: int
    n_max: int
    g_max: int
    max_deg: int
    features: np.ndarray     # (K, n_max, F)
    labels: np.ndarray       # (K, n_max)
    node_mask: np.ndarray    # (K, n_max)
    train_mask: np.ndarray   # (K, n_max)
    val_mask: np.ndarray     # (K, n_max)
    nbr_idx: np.ndarray      # (K, n_max, D)
    nbr_mask: np.ndarray     # (K, n_max, D)
    ghost_owner: np.ndarray  # (K, g_max)
    ghost_row: np.ndarray    # (K, g_max)
    ghost_mask: np.ndarray   # (K, g_max)
    global_ids: np.ndarray   # (K, n_max) original node id (-1 pad)
    n_classes: int
    n_cross_edges: int       # Table-1 style ΔE diagnostic

    @property
    def n_features(self) -> int:
        return self.features.shape[2]

    @property
    def client_sizes(self) -> np.ndarray:
        return self.node_mask.sum(axis=1).astype(np.int32)


def partition_graph(
    graph: GraphData,
    n_clients: int,
    *,
    alpha: float | None = None,   # None -> iid, else Dirichlet(alpha) non-iid
    max_deg: int = 32,
    edge_keep: float = 0.5,       # paper: 50% local-subgraph edge downsampling
    seed: int = 0,
) -> FederatedGraph:
    rng = np.random.default_rng(seed)
    n = graph.n_nodes
    c = graph.n_classes

    # ---- assign nodes to clients ----
    assign = np.empty(n, np.int64)
    if alpha is None:
        assign[:] = rng.integers(0, n_clients, size=n)
    else:
        # Dirichlet per class: p_i ~ Dir_K(alpha); class-i nodes split by p_i
        for cls in range(c):
            ids = np.where(graph.labels == cls)[0]
            rng.shuffle(ids)
            p = rng.dirichlet(np.full(n_clients, alpha))
            counts = rng.multinomial(len(ids), p)
            assign[ids] = np.repeat(np.arange(n_clients), counts)

    client_nodes = [np.where(assign == k)[0] for k in range(n_clients)]
    n_max = max(1, max(len(v) for v in client_nodes))
    local_of = np.full(n, -1, np.int64)
    for k, ids in enumerate(client_nodes):
        local_of[ids] = np.arange(len(ids))

    # ---- split edges, downsample within-client edges ----
    e = graph.edges
    same = assign[e[:, 0]] == assign[e[:, 1]]
    within = e[same]
    cross = e[~same]
    if edge_keep < 1.0 and len(within):
        within = within[rng.random(len(within)) < edge_keep]

    # ---- per-client adjacency over [own | ghost] rows ----
    F = graph.n_features
    feats = np.zeros((n_clients, n_max, F), np.float32)
    labels = np.zeros((n_clients, n_max), np.int32)
    node_mask = np.zeros((n_clients, n_max), np.float32)
    train_mask = np.zeros((n_clients, n_max), np.float32)
    val_mask = np.zeros((n_clients, n_max), np.float32)
    global_ids = np.full((n_clients, n_max), -1, np.int32)

    adj = [[[] for _ in range(n_max)] for _ in range(n_clients)]
    ghosts: list[dict[int, int]] = [dict() for _ in range(n_clients)]  # global id -> slot

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
            feats[k, :nk] = graph.features[ids]
            labels[k, :nk] = graph.labels[ids]
            node_mask[k, :nk] = 1.0
            train_mask[k, :nk] = graph.train_mask[ids]
            val_mask[k, :nk] = graph.val_mask[ids]
            global_ids[k, :nk] = ids
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
            nbr_idx[k, i, : len(nbrs)] = nbrs
            nbr_mask[k, i, : len(nbrs)] = 1.0

    return FederatedGraph(
        name=graph.name, n_clients=n_clients, n_max=n_max, g_max=g_max,
        max_deg=max_deg, features=feats, labels=labels, node_mask=node_mask,
        train_mask=train_mask, val_mask=val_mask, nbr_idx=nbr_idx,
        nbr_mask=nbr_mask, ghost_owner=ghost_owner, ghost_row=ghost_row,
        ghost_mask=ghost_mask, global_ids=global_ids, n_classes=graph.n_classes,
        n_cross_edges=int(len(cross)),
    )
