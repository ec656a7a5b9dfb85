"""Intra-graph federated partition: split one global graph across K clients,
extract cross-client ("ghost") edges, and build fixed-shape per-client arrays
stacked over a leading client axis.

A numpy copy of ``repro/federated/partition.py`` (``FederatedGraph``,
``partition_graph``, and the pod, ghost-exchange and write-back bucket
builders of the multi-device executors): the same graph and seed give the
same arrays, bit for bit (pinned by tests/test_torch_train_host.py and
tests/test_torch_tables_host.py).

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
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.graph.data import GraphData


def pod_table_padding(n_clients: int, n_pods: int) -> int:
    """Dummy client rows appended so the K-sized historical tables split
    evenly across ``n_pods`` pod shards (rows ``>= n_clients`` stay zero and
    are never selected or referenced by ghost buckets)."""
    return (-n_clients) % n_pods


@dataclass
class GhostBuckets:
    """Partition-time routing plan for the cross-pod ghost exchange.

    When the historical tables shard their client (K) axis over a pod mesh
    axis, ``pull_ghosts`` can no longer gather from a replicated
    ``hist1_all`` — each ghost's layer-1 source row lives only on the pod
    that owns that client. The exchange becomes a bucketed all-to-all: pod
    ``p`` sends, for every destination pod ``q``, the (deduplicated) table
    rows that ``q``'s resident clients reference as ghosts; ``q``
    reassembles its residents' (g_max,) ghost-source rows from the received
    buckets. The buckets depend only on the partition's ghost topology
    (``ghost_owner``/``ghost_row``/``ghost_mask``) and the pod count, so
    they are built once here on the host and baked into the compiled chunk
    as constants.

    Shapes (P = n_pods, B = bucket_size, Kp = padded client count):
        send_client (P, P, B)  row index within the SOURCE pod's table shard
        send_row    (P, P, B)  row within the owner's (n_tot,) table (< n_max)
        send_mask   (P, P, B)  1 for real entries, 0 for bucket padding
        recv_src    (Kp, g_max) source pod of each resident ghost slot
        recv_pos    (Kp, g_max) position within that pod's received bucket
        recv_mask   (Kp, g_max) ghost_mask of real residents, 0 on padding

    ``send_*[p, q]`` is what pod p sends to pod q; after the all-to-all,
    pod q's receive buffer slot p holds exactly those rows, and
    ``recv_*[k]`` (k resident on q) indexes into it.
    """

    n_pods: int
    rows_per_pod: int       # padded K / n_pods
    bucket_size: int        # B: max entries over all (src, dst) pod pairs
    n_entries: int          # total real (deduplicated) bucket entries
    send_client: np.ndarray
    send_row: np.ndarray
    send_mask: np.ndarray
    recv_src: np.ndarray
    recv_pos: np.ndarray
    recv_mask: np.ndarray

    @property
    def n_clients_padded(self) -> int:
        return self.n_pods * self.rows_per_pod


def ghost_exchange_buckets(
    ghost_owner: np.ndarray,    # (K, g_max) owning client id (-1 pad)
    ghost_row: np.ndarray,      # (K, g_max) row within the owner's arrays
    ghost_mask: np.ndarray,     # (K, g_max)
    n_pods: int,
) -> GhostBuckets:
    """Build the per-pod send/recv index buckets for the ghost all-to-all.

    Clients are block-assigned to pods by id: pod p owns rows
    ``[p * rows_per_pod, (p + 1) * rows_per_pod)`` of the padded table.
    Every (owner, row) source pair needed by some resident of pod q appears
    exactly once in the owner pod's send bucket for q (duplicates across
    residents of the same pod deduplicate; the same source row needed by
    residents of DIFFERENT pods is sent once per destination).
    """
    if n_pods < 1:
        raise ValueError(f"n_pods must be >= 1, got {n_pods}")
    K, g_max = ghost_owner.shape
    pad = pod_table_padding(K, n_pods)
    Kp = K + pad
    rpp = Kp // n_pods

    # (src, dst) -> {(owner, row): bucket position}; dicts keep insertion
    # order, so bucket layout is deterministic for a given partition
    buckets: list[list[dict]] = [[{} for _ in range(n_pods)]
                                 for _ in range(n_pods)]
    recv_src = np.zeros((Kp, g_max), np.int32)
    recv_pos = np.zeros((Kp, g_max), np.int32)
    recv_mask = np.zeros((Kp, g_max), np.float32)
    for k in range(K):
        q = k // rpp
        for s in range(g_max):
            if ghost_mask[k, s] <= 0:
                continue
            o, r = int(ghost_owner[k, s]), int(ghost_row[k, s])
            p = o // rpp
            d = buckets[p][q]
            pos = d.setdefault((o, r), len(d))
            recv_src[k, s] = p
            recv_pos[k, s] = pos
            recv_mask[k, s] = 1.0

    n_entries = sum(len(d) for row in buckets for d in row)
    B = max(1, max(len(d) for row in buckets for d in row))
    send_client = np.zeros((n_pods, n_pods, B), np.int32)
    send_row = np.zeros((n_pods, n_pods, B), np.int32)
    send_mask = np.zeros((n_pods, n_pods, B), np.float32)
    for p in range(n_pods):
        for q in range(n_pods):
            for (o, r), pos in buckets[p][q].items():
                send_client[p, q, pos] = o - p * rpp
                send_row[p, q, pos] = r
                send_mask[p, q, pos] = 1.0
    return GhostBuckets(
        n_pods=n_pods, rows_per_pod=rpp, bucket_size=B, n_entries=n_entries,
        send_client=send_client, send_row=send_row, send_mask=send_mask,
        recv_src=recv_src, recv_pos=recv_pos, recv_mask=recv_mask,
    )


def simulate_ghost_exchange(buckets: GhostBuckets,
                            hist1_all: np.ndarray) -> np.ndarray:
    """Host-side (numpy) reference of the on-device exchange: build every
    pod's send buffers from its table shard, swap them all-to-all, and
    reassemble per-resident ghost-source rows. Returns (Kp, g_max, H1) —
    row [k, s] is ``hist1_all[ghost_owner[k, s], ghost_row[k, s]]`` for
    every real ghost slot and 0 elsewhere. ``sharding.tables`` runs the
    same dataflow with ``torch.distributed.all_to_all_single``."""
    P, B = buckets.n_pods, buckets.bucket_size
    rpp, Kp = buckets.rows_per_pod, buckets.n_clients_padded
    K, n_tot, H1 = hist1_all.shape
    shards = np.zeros((P, rpp, n_tot, H1), hist1_all.dtype)
    shards.reshape(Kp, n_tot, H1)[:K] = hist1_all
    # send: sbuf[p, q] = the rows pod p sends to pod q
    sbuf = (shards[np.arange(P)[:, None, None],
                   buckets.send_client, buckets.send_row]
            * buckets.send_mask[..., None])
    # all-to-all: pod q's receive slot p holds what pod p addressed to q
    rbuf = np.swapaxes(sbuf, 0, 1)          # rbuf[q, p] = sbuf[p, q]
    pod = np.arange(Kp) // rpp
    out = (rbuf[pod[:, None], buckets.recv_src, buckets.recv_pos]
           * buckets.recv_mask[..., None])
    return out


def exchange_ghost_features(buckets: GhostBuckets,
                            features: np.ndarray, *,
                            dtype: str = "fp32") -> np.ndarray:
    """Bucketed owner exchange of the layer-0 ghost features (host, once per
    partition): the same send/recv routing as the hist1 all-to-all applied
    to the static (K, n_max, F) feature shards, so each pod fills its
    residents' (g_max, F) ghost-source rows purely from received buckets —
    no pod ever reads a replicated features array. Returns (Kp, g_max, F):
    row [k, s] is ``features[ghost_owner[k, s], ghost_row[k, s]]`` for every
    real ghost slot and 0 elsewhere (exactly the gf half of
    ``core.historical.pull_ghosts``). Ghost sources are always owner OWN
    rows (< n_max), so the hist-table routing indexes features directly.

    ``dtype`` quantizes the exchanged rows through the
    ``federated.quant`` codec (this exchange IS the wire for ghost features
    in the pod-sharded executor), the codec the ``"tables"``-mode pull
    round-trips through, so the prefetched rows match that pull's decode
    bit for bit (a per-row codec commutes with the row gather).
    """
    out = simulate_ghost_exchange(buckets, features).astype(np.float32)
    if dtype != "fp32":
        import torch

        from repro_torch.federated.quant import quant_roundtrip

        out = quant_roundtrip(torch.from_numpy(out), dtype).numpy()
    return out


@dataclass
class WriteBackPlan:
    """Host-built per-chunk routing for the cohort-keyed write-back exchange.

    After a round, each device holds fresh table rows for its cohort slice;
    the owner pods need them. The dense path all-gathers every cohort row to
    every device (m rows each, K-independent but cohort-dense). This plan
    shrinks it to a two-stage exchange sized by what each pod PAIR actually
    routes: stage 1 all-gathers the cohort slice within a pod row (m/P
    rows), stage 2 scatters those rows into per-destination-pod send
    buckets and swaps them with one ``all_to_all`` over the pod axis
    (``cap`` rows per pod pair, ``cap`` ≈ m/P² in expectation).

    Built on the host per chunk from the selected cohorts alone (the
    sel_stack is host-known before the chunk launches), baked in as scan
    inputs. Shapes (S = rounds, m = padded cohort, P = pods):
        dst (S, m)           owner pod of each cohort entry (P for dummies —
                             the send-bucket scatter drops them)
        pos (S, m)           slot within the (src pod, dst pod) send bucket
        recv (S, P, P, cap)  recv[s, q, p, j]: destination-local table row
                             of the j-th entry pod p sent pod q (sentinel
                             ``rows_per_pod`` on unused slots — the table
                             scatter drops them)

    ``cap`` is the max (src, dst) bucket occupancy rounded up to a power of
    two, so nearby cohort distributions reuse one compiled chunk shape.
    Cohorts are assumed duplicate-free per round (sync selectors sample
    without replacement), matching the dense path's scatter semantics.
    """

    n_pods: int
    n_client_shards: int
    rows_per_pod: int
    cap: int
    max_occupancy: int      # real max bucket fill before pow2 rounding
    dst: np.ndarray
    pos: np.ndarray
    recv: np.ndarray


def writeback_routing(sel_stack: np.ndarray, n_pods: int,
                      n_client_shards: int, rows_per_pod: int,
                      *, cap: int | None = None) -> WriteBackPlan:
    """Route a chunk's (S, m) padded cohort ids into write-back buckets.

    Cohort entry i of round s lives on device ``i // mL`` (mL = m/(P·C));
    after the stage-1 intra-pod all-gather, pod row p holds cohort slice
    ``[p·C·mL, (p+1)·C·mL)`` in device order — so the source pod of entry i
    is ``i // (C·mL)``. The owner pod is ``sel // rows_per_pod``; ids >=
    ``n_pods * rows_per_pod`` (cohort dummies) get the sentinel destination
    ``n_pods``. Positions count up per (src, dst) pair in cohort order, so
    the exchange is deterministic for a given sel_stack."""
    sel_stack = np.asarray(sel_stack)
    S, m = sel_stack.shape
    n_dev = n_pods * n_client_shards
    if m % n_dev:
        raise ValueError(f"padded cohort {m} does not split over "
                         f"{n_pods}x{n_client_shards} devices")
    msl = m // n_pods                       # pod-row cohort slice
    Kp = n_pods * rows_per_pod
    dst = np.full((S, m), n_pods, np.int32)
    pos = np.zeros((S, m), np.int32)
    occ = np.zeros((S, n_pods, n_pods), np.int64)
    src = np.arange(m) // msl
    for s in range(S):
        for i in range(m):
            k = int(sel_stack[s, i])
            if not 0 <= k < Kp:
                continue                    # dummy: sentinel dst drops it
            q = k // rows_per_pod
            dst[s, i] = q
            pos[s, i] = occ[s, src[i], q]
            occ[s, src[i], q] += 1
    max_occ = int(occ.max(initial=0))
    need = max(1, max_occ)
    if cap is None:
        cap = 1 << (need - 1).bit_length()  # pow2: bounded retrace shapes
    elif cap < need:
        raise ValueError(f"cap {cap} < max bucket occupancy {need}")
    recv = np.full((S, n_pods, n_pods, cap), rows_per_pod, np.int32)
    for s in range(S):
        for i in range(m):
            q = int(dst[s, i])
            if q >= n_pods:
                continue
            recv[s, q, src[i], pos[s, i]] = \
                int(sel_stack[s, i]) - q * rows_per_pod
    return WriteBackPlan(
        n_pods=n_pods, n_client_shards=n_client_shards,
        rows_per_pod=rows_per_pod, cap=int(cap), max_occupancy=max_occ,
        dst=dst, pos=pos, recv=recv)


def simulate_writeback_exchange(plan: WriteBackPlan, s: int,
                                values: np.ndarray,
                                table: np.ndarray) -> np.ndarray:
    """Host-side (numpy) reference of round ``s``'s on-device write-back:
    scatter the cohort's fresh rows into per-pod send buckets, swap them
    all-to-all, and scatter each pod's received rows into its table shard.
    ``values`` is the round's (m, ...) fresh rows in cohort order, ``table``
    the (Kp, ...) padded table; returns the updated copy. The property
    tests pin this bit-for-bit against the dense scatter
    ``table[sel[i]] = values[i]`` for every real cohort id."""
    P, rpp, cap = plan.n_pods, plan.rows_per_pod, plan.cap
    m = values.shape[0]
    sbuf = np.zeros((P, P, cap) + values.shape[1:], values.dtype)
    src = np.arange(m) // (m // P)
    for i in range(m):
        q = int(plan.dst[s, i])
        if q < P:
            sbuf[src[i], q, plan.pos[s, i]] = values[i]
    rbuf = np.swapaxes(sbuf, 0, 1)          # rbuf[q, p] = sbuf[p, q]
    out = np.array(table)
    for q in range(P):
        for p in range(P):
            for j in range(cap):
                r = int(plan.recv[s, q, p, j])
                if r < rpp:
                    out[q * rpp + r] = rbuf[q, p, j]
    return out



@dataclass
class FederatedGraph:
    """All K clients stacked on a leading axis (numpy; moved to the device later)."""

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
