"""Streaming graph updates for the serving path.

A numpy copy of ``repro/serve/updates.py``: the same mutations give the
same arrays and the same invalidation sets (tests/test_torch_host.py).

``GraphStore`` owns the mutable serving graph in the same fixed-shape padded
neighbor-list form training evals use (``graph/csr``), pre-allocated to a
node capacity so new nodes append without reshaping the device tables the
query paths read. ``add_nodes`` / ``add_edges`` mutate the adjacency and
return the *exact* set of cached layer-1 rows the mutation dirties: a row's
h1 depends only on its own features and its 1-hop neighborhood, so adding an
edge (u, v) invalidates {u, v} and adding a node invalidates the node plus
every neighbor it attaches to — nothing else (the layer-2 consumers read h1
at query time and are never cached). ``refresh_invalid`` is the background
re-embed batch (driven through ``QueryEngine.refresh``, which owns the
bucket-shaped compute).

Capacity is elastic: when an insert outgrows the current allocation the
store grows geometrically (``growth`` factor, default 1.5x) instead of
failing, so a long-lived serving process absorbs unbounded streams with
amortized O(1) copies. ``CapacityError`` is reserved for the configurable
hard ceiling (``max_capacity``) — the operator's memory budget — and is
never raised when no ceiling is set.
"""
from __future__ import annotations

import numpy as np


class CapacityError(RuntimeError):
    """The store's configured ``max_capacity`` hard ceiling is exhausted."""


class GraphStore:
    """Mutable padded-adjacency graph with elastic node capacity.

    Arrays (host numpy; the device mirrors live on ``ServedModel``):
        features (capacity, F) float32
        nbr_idx  (capacity, D) int32
        nbr_mask (capacity, D) float32
    Rows ``[0, n_active)`` are live; the rest are zeroed headroom. Inserts
    past the headroom grow the arrays geometrically (``growth``); only the
    optional ``max_capacity`` hard cap ever raises :class:`CapacityError`.
    """

    def __init__(self, features: np.ndarray, nbr_idx: np.ndarray,
                 nbr_mask: np.ndarray, *, capacity: int | None = None,
                 max_capacity: int | None = None, growth: float = 1.5,
                 headroom: float = 0.25, seed: int = 0):
        n, f = features.shape
        d = nbr_idx.shape[1]
        if capacity is None:
            capacity = n + max(64, int(np.ceil(n * headroom)))
        if capacity < n:
            raise ValueError(f"capacity {capacity} < {n} initial nodes")
        if growth <= 1.0:
            raise ValueError(f"growth factor must be > 1, got {growth}")
        if max_capacity is not None and max_capacity < capacity:
            raise ValueError(f"max_capacity {max_capacity} < initial "
                             f"capacity {capacity}")
        self.max_capacity = max_capacity
        self.growth = float(growth)
        self.n_grows = 0
        self.n_active = n
        self.max_deg = d
        self.features = np.zeros((capacity, f), np.float32)
        self.features[:n] = features
        self.nbr_idx = np.zeros((capacity, d), np.int32)
        self.nbr_idx[:n] = nbr_idx
        self.nbr_mask = np.zeros((capacity, d), np.float32)
        self.nbr_mask[:n] = nbr_mask
        self.rng = np.random.default_rng(seed)
        self.n_edges_added = 0
        self.n_edges_evicted = 0          # full rows where a slot was replaced

    @property
    def capacity(self) -> int:
        return self.features.shape[0]

    @property
    def n_features(self) -> int:
        return self.features.shape[1]

    def neighbors(self, rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Padded (len(rows), D) neighbor slices for a query/refresh batch."""
        rows = np.asarray(rows, np.int64)
        return self.nbr_idx[rows], self.nbr_mask[rows]

    def degrees(self, rows: np.ndarray | None = None) -> np.ndarray:
        m = self.nbr_mask[: self.n_active] if rows is None else self.nbr_mask[rows]
        return m.sum(-1).astype(np.int64)

    def _grow(self, needed: int) -> None:
        """Geometric reallocation to fit ``needed`` live rows: the new
        capacity is max(ceil(capacity x growth), needed), clamped to the
        ``max_capacity`` ceiling — which is also the only condition that
        still raises :class:`CapacityError`."""
        if needed <= self.capacity:
            return
        if self.max_capacity is not None and needed > self.max_capacity:
            raise CapacityError(
                f"GraphStore hard cap: {needed} nodes exceeds max_capacity "
                f"{self.max_capacity} (raise the ceiling or evict)")
        new_cap = max(int(np.ceil(self.capacity * self.growth)), needed)
        if self.max_capacity is not None:
            new_cap = min(new_cap, self.max_capacity)

        def pad(a: np.ndarray) -> np.ndarray:
            out = np.zeros((new_cap,) + a.shape[1:], a.dtype)
            out[: len(a)] = a
            return out

        self.features = pad(self.features)
        self.nbr_idx = pad(self.nbr_idx)
        self.nbr_mask = pad(self.nbr_mask)
        self.n_grows += 1

    # -- mutations -------------------------------------------------------

    def _check_ids(self, ids: np.ndarray, what: str) -> np.ndarray:
        ids = np.asarray(ids, np.int64).reshape(-1)
        if len(ids) and (ids.min() < 0 or ids.max() >= self.n_active):
            raise ValueError(f"{what} references node outside "
                             f"[0, {self.n_active}): {ids.min()}..{ids.max()}")
        return ids

    def _insert_neighbor(self, u: int, v: int) -> bool:
        """Append v to u's slots (first free one; evict a random slot when
        the row is full — the same capped-degree semantics
        ``build_padded_neighbors`` applies to the static graph). Duplicate
        edges are dropped. Returns True if the row changed."""
        row_mask = self.nbr_mask[u]
        live = row_mask > 0
        if v in self.nbr_idx[u][live]:
            return False
        if live.all():
            slot = int(self.rng.integers(self.max_deg))
            self.n_edges_evicted += 1
        else:
            slot = int(np.argmin(live))
        self.nbr_idx[u, slot] = v
        self.nbr_mask[u, slot] = 1.0
        return True

    def add_edges(self, edges: np.ndarray) -> np.ndarray:
        """Insert undirected edges [(u, v), ...] between live nodes.
        Returns the sorted unique affected rows (the edge endpoints) whose
        cached layer-1 embedding is now stale."""
        edges = np.asarray(edges, np.int64).reshape(-1, 2)
        self._check_ids(edges.reshape(-1), "add_edges")
        affected = set()
        for u, v in edges:
            u, v = int(u), int(v)
            if u == v:
                continue
            changed = self._insert_neighbor(u, v)
            changed |= self._insert_neighbor(v, u)
            if changed:
                affected.update((u, v))
                self.n_edges_added += 1
        return np.array(sorted(affected), np.int64)

    def add_nodes(self, feats: np.ndarray,
                  edges: np.ndarray | None = None
                  ) -> tuple[np.ndarray, np.ndarray]:
        """Append new nodes (optionally with attachment edges, which may
        reference the new ids). Returns ``(new_ids, affected_rows)`` where
        ``affected_rows`` is the new nodes' 1-hop neighborhood — exactly the
        cache rows to invalidate."""
        feats = np.asarray(feats, np.float32).reshape(-1, self.n_features)
        c = len(feats)
        self._grow(self.n_active + c)
        ids = np.arange(self.n_active, self.n_active + c, dtype=np.int64)
        self.features[ids] = feats
        self.n_active += c
        affected = set(int(i) for i in ids)
        if edges is not None and len(edges):
            affected.update(int(r) for r in self.add_edges(edges))
        return ids, np.array(sorted(affected), np.int64)
