"""ServedModel: params + a device-resident warm layer-1 embedding cache.

Port of ``repro/serve/model.py:86-316``. It is built from params and a
:class:`GraphStore` and keeps, on its device:

* ``params`` — the GCN weights (``convert.params_from_numpy`` carries the
  reference's across);
* ``feat`` — the (capacity, F) feature mirror of the store;
* ``h1`` — the (capacity, H1) layer-1 cache, initialised by one full
  layer-0 pass over the graph (``warm="refresh"``: the same operands as the
  eval path's first layer), from given table rows (``warm="tables"``) or
  zeros (``warm="cold"``), and held in its wire format
  (``federated.quant``: fp32 payload, bf16, or int8 codes + per-row scales);

and on the host the per-row freshness bookkeeping (``valid``,
``row_version``). The device tables are updated in place: the query
engine's CUDA graphs hold their addresses. ``h1`` and ``h1_scale`` are the
first ``capacity`` rows of buffers with one row more, a scratch row at
index ``capacity`` that nothing reads: the padding rows of a fixed-shape
refresh write there (``write_cache_rows``), so a padded row never
overwrites a real one. A re-allocation (``ensure_capacity``) bumps
``generation``, which tells the engine to drop its graphs.

``restore`` builds the serving state from a federation checkpoint written
by ``save_federation`` (``repro/serve/model.py:50-110, 175-203``): the
reference's msgpack format, which either package reads
(``checkpoint/ckpt.py``).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import load_checkpoint, load_latest, save_checkpoint
from repro_torch.convert import params_from_numpy
from repro_torch.device import resolve_device
from repro_torch.federated.quant import check_sync_dtype
from repro_torch.federated.quant import decode as quant_decode
from repro_torch.federated.quant import encode as quant_encode
from repro_torch.graph.csr import build_padded_neighbors
from repro_torch.models.gcn import HIDDEN, neighbor_aggregate, sage_layer_rows
from repro_torch.serve.updates import GraphStore

SERVE_BACKENDS = ("gather", "segment", "spmm")
WARM_MODES = ("refresh", "tables", "cold")


# ---------------------------------------------------------------------------
# federation checkpoint layout
# ---------------------------------------------------------------------------

def _host(x, dtype) -> np.ndarray:
    if hasattr(x, "detach"):                     # a torch tensor
        x = x.detach().cpu().numpy()
    return np.asarray(x).astype(dtype, copy=False)


def federation_tree(state: Any) -> dict:
    """The checkpoint tree of a federation: global params plus the synced
    tables, as host arrays in the reference template's dtypes (fp32, int32
    ``age``). Takes an ``api.EngineState`` (whose ``ghost_feat`` is
    ``state.hist.ghost_feat``) or an already-flat dict with these keys."""
    if hasattr(state, "hist"):
        tree = {"params": state.params, "hist1": state.hist.hist1, "age": state.hist.age,
                "ghost_feat": state.hist.ghost_feat, "prev_loss": state.prev_loss}
    else:
        tree = dict(state)
    out = {k: _host(v, np.int32 if k == "age" else np.float32)
           for k, v in tree.items() if k != "params"}
    out["params"] = {k: _host(v, np.float32) for k, v in tree["params"].items()}
    return out


def _shaped(shape, dtype) -> np.ndarray:
    """A read-only zero-strided array: a shape and a dtype, no storage."""
    return np.broadcast_to(np.zeros((), dtype), shape)


def federation_template(fed) -> dict:
    """Shape/dtype template for ``load_checkpoint`` from the partition's
    static geometry (no training state, no weights drawn)."""
    n_tot = fed.n_max + fed.g_max
    dims = (fed.n_features, *HIDDEN)
    params = {}
    for l in range(len(HIDDEN)):
        params[f"w_self{l}"] = _shaped((dims[l], dims[l + 1]), np.float32)
        params[f"w_nbr{l}"] = _shaped((dims[l], dims[l + 1]), np.float32)
        params[f"b{l}"] = _shaped((dims[l + 1],), np.float32)
    params["w_cls"] = _shaped((HIDDEN[-1], fed.n_classes), np.float32)
    params["b_cls"] = _shaped((fed.n_classes,), np.float32)
    return {
        "params": params,
        "hist1": _shaped((fed.n_clients, n_tot, HIDDEN[0]), np.float32),
        "age": _shaped((fed.n_clients, n_tot), np.int32),
        "ghost_feat": _shaped((fed.n_clients, fed.g_max, fed.n_features), np.float32),
        "prev_loss": _shaped((fed.n_clients, fed.n_max), np.float32),
    }


def save_federation(directory: str, step: int, state: Any) -> str:
    """Checkpoint a trained federation (params + tables) for serving."""
    return save_checkpoint(directory, step, federation_tree(state))


def _scatter_tables(fed, table_k, fill=0.0) -> np.ndarray:
    """Scatter a per-client (K, n_max[, d]) own-row table into global node
    order (every global node belongs to exactly one client)."""
    own = np.asarray(fed.node_mask) > 0                      # (K, n_max)
    gids = np.asarray(fed.global_ids)[own]
    vals = np.asarray(table_k)[:, : fed.n_max][own]
    out = np.full((int(own.sum()),) + vals.shape[1:], fill, vals.dtype)
    out[gids] = vals
    return out


def _layer1_full(params, features, nbr_idx, nbr_mask, csr=None, adj=None,
                 backend: str = "segment") -> torch.Tensor:
    """Layer-1 embeddings for every row — the first layer of
    ``gcn_full_forward`` (same backend, same operands)."""
    agg = neighbor_aggregate(features, nbr_idx, nbr_mask, backend=backend,
                             csr=csr, adj=adj)
    return sage_layer_rows(params, 0, features, agg)


class ServedModel:
    """Device-resident serving state: params + warm embedding cache.
    ``device=None`` is ``cuda:0``; the CPU only when asked for."""

    def __init__(self, params, store: GraphStore, *, backend: str = "segment",
                 warm: str = "refresh", table_h1: np.ndarray | None = None,
                 table_age: np.ndarray | None = None,
                 restored_step: int | None = None,
                 cache_dtype: str = "fp32", device=None):
        if backend not in SERVE_BACKENDS:
            raise ValueError(f"unknown serve backend {backend!r}; "
                             f"known: {SERVE_BACKENDS}")
        if warm not in WARM_MODES:
            raise ValueError(f"unknown warm mode {warm!r}; known: {WARM_MODES}")
        self.device = resolve_device(device)
        self.params = {k: torch.as_tensor(v).to(self.device, torch.float32)
                       for k, v in params.items()}
        self.store = store
        self.backend = backend
        self.warm = warm
        self.restored_step = restored_step
        self.cache_dtype = check_sync_dtype(cache_dtype)
        cap = store.capacity
        self.feat = self._to_device(store.features)            # (cap, F)
        self.valid = np.zeros(cap, bool)
        self.generation = 0                                    # device re-allocations
        self.step = 0                                          # serve-step clock
        self.row_version = np.zeros(cap, np.int64)             # step of last write
        self.table_age = table_age
        self.n_invalidated = 0
        self.n_refreshed = 0

        if warm == "refresh":
            self._set_cache(*self.encode_cache(self.compute_layer1_full()))
            self.valid[: store.n_active] = True
        elif warm == "tables":
            if table_h1 is None:
                raise ValueError("warm='tables' needs the scattered table_h1")
            h = np.zeros((cap, HIDDEN[0]), np.float32)
            h[: len(table_h1)] = table_h1
            self._set_cache(*self.encode_cache(self._to_device(h)))
            self.valid[: store.n_active] = True
        else:                                                  # cold
            self._set_cache(*self.encode_cache(torch.zeros(
                (cap, HIDDEN[0]), dtype=torch.float32, device=self.device)))

    # -- construction ----------------------------------------------------

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A device copy of a host array (never a view of the store's)."""
        return torch.tensor(arr, device=self.device)

    def encode_cache(self, h: torch.Tensor):
        """Encode a fp32 (cap, H1) table into the resident cache format —
        ``(payload, scale_or_None)`` per ``cache_dtype``."""
        return quant_encode(h, self.cache_dtype)

    def _set_cache(self, payload: torch.Tensor, scale) -> None:
        """Make ``payload`` / ``scale`` (cap rows) the resident cache: copied
        into new buffers of cap + 1 rows, the last the scratch row."""
        cap = payload.shape[0]
        self._h1_buf = payload.new_zeros((cap + 1,) + tuple(payload.shape[1:]))
        self._h1_buf[:cap] = payload
        self.h1 = self._h1_buf[:cap]
        self._scale_buf = self.h1_scale = None
        if scale is not None:
            self._scale_buf = scale.new_zeros((cap + 1, 1))
            self._scale_buf[:cap] = scale
            self.h1_scale = self._scale_buf[:cap]

    def h1_f32(self) -> torch.Tensor:
        """The dequantized (cap, H1) cache (the payload itself for fp32)."""
        return quant_decode(self.h1, self.h1_scale, self.cache_dtype)

    def table_with_rows(self, dst: torch.Tensor, h1r: torch.Tensor) -> torch.Tensor:
        """A dequantized copy of the cache, (cap, H1) fp32, with row i of
        ``h1r`` written at ``dst[i]`` (``dst[i] == capacity``: the copy's
        scratch row) — the fresh policy's table. The cache is untouched."""
        table = quant_decode(self._h1_buf, self._scale_buf, self.cache_dtype)
        if table is self._h1_buf:
            table = table.clone()
        table[dst] = h1r
        return table[: self.h1.shape[0]]

    def write_cache_rows(self, dst: torch.Tensor, h1r: torch.Tensor) -> None:
        """Encode the fp32 rows ``h1r`` and write row i to cache row
        ``dst[i]``, in place; ``dst[i] == capacity`` (a padding row) lands
        in the scratch row. Untouched rows keep their stored bits."""
        payload, scale = quant_encode(h1r, self.cache_dtype)
        self._h1_buf[dst] = payload
        if scale is not None:
            self._scale_buf[dst] = scale

    @classmethod
    def restore(cls, directory: str, graph, fed, *, step: int | None = None,
                backend: str = "segment", warm: str = "refresh",
                capacity: int | None = None, seed: int = 0,
                headroom: float = 0.25, cache_dtype: str = "fp32",
                device=None) -> "ServedModel":
        """Load a federation checkpoint and build the serving state.

        ``seed`` must match the training engine's, so that the padded
        neighbor arrays equal the training eval graph's. ``step=None``
        takes the newest loadable checkpoint (``load_latest``)."""
        template = federation_template(fed)
        if step is None:
            step, tree = load_latest(directory, template)
        else:
            tree = load_checkpoint(directory, step, template)
        idx, mask = build_padded_neighbors(graph.adjacency_lists(), fed.max_deg, seed=seed)
        store = GraphStore(graph.features, idx, mask, capacity=capacity, seed=seed,
                           headroom=headroom)
        table_h1 = _scatter_tables(fed, tree["hist1"])
        table_age = _scatter_tables(fed, tree["age"]).astype(np.int64)
        dev = resolve_device(device)
        return cls(params_from_numpy(tree["params"], dev), store, backend=backend,
                   warm=warm, table_h1=table_h1, table_age=table_age, restored_step=step,
                   cache_dtype=cache_dtype, device=dev)

    # -- cache compute / bookkeeping -------------------------------------

    @property
    def n_active(self) -> int:
        return self.store.n_active

    @property
    def cache_age(self) -> np.ndarray:
        """Serve steps since each row was last written (active rows)."""
        return (self.step - self.row_version)[: self.n_active]

    def aggregation_operands(self, nbr_idx: torch.Tensor,
                             nbr_mask: torch.Tensor) -> dict:
        """Backend-specific operands for ``neighbor_aggregate`` over the
        given padded rows (bucketed CSR / dense (rows, capacity)
        adjacency)."""
        if self.backend == "segment":
            from repro_torch.graph.csr import bucketed_csr_from_padded

            return {"csr": bucketed_csr_from_padded(nbr_idx, nbr_mask)}
        if self.backend == "spmm":
            from repro_torch.kernels.spmm.ops import adjacency_from_neighbors

            return {"adj": adjacency_from_neighbors(nbr_idx, nbr_mask,
                                                    self.store.capacity)}
        return {}

    def compute_layer1_full(self) -> torch.Tensor:
        """One full layer-0 pass over the (capacity-padded) graph — the warm
        cache fill."""
        s = self.store
        idx = self._to_device(s.nbr_idx)
        mask = self._to_device(s.nbr_mask)
        kw = self.aggregation_operands(idx, mask)
        return _layer1_full(self.params, self.feat, idx, mask,
                            backend=self.backend, **kw)

    def ensure_capacity(self) -> bool:
        """Mirror a :class:`GraphStore` capacity growth into the device
        state: re-pull the feature mirror, zero-extend the h1 cache (old
        rows copied bit for bit) and pad the host bookkeeping. Returns True
        if anything was re-allocated (``generation`` then moves)."""
        cap = self.store.capacity
        old = self.h1.shape[0]
        if cap == old:
            return False
        self.feat = self._to_device(self.store.features)
        h1 = self.h1.new_zeros((cap, self.h1.shape[1]))
        h1[:old] = self.h1
        scale = None
        if self.h1_scale is not None:
            scale = self.h1_scale.new_zeros((cap, 1))
            scale[:old] = self.h1_scale
        self._set_cache(h1, scale)
        self.generation += 1
        self.valid = np.concatenate([self.valid, np.zeros(cap - old, bool)])
        self.row_version = np.concatenate(
            [self.row_version, np.full(cap - old, self.step, np.int64)])
        return True

    def invalidate(self, rows: np.ndarray) -> int:
        rows = np.asarray(rows, np.int64)
        n_new = int(self.valid[rows].sum())
        self.valid[rows] = False
        self.n_invalidated += len(rows)
        return n_new

    def mark_written(self, rows: np.ndarray) -> None:
        self.valid[rows] = True
        self.row_version[rows] = self.step
        self.n_refreshed += len(rows)

    def set_features(self, rows: np.ndarray, feats: np.ndarray) -> None:
        """Mirror a GraphStore feature write into the device copy, in place."""
        rows_t = torch.as_tensor(np.asarray(rows, np.int64), device=self.device)
        self.feat[rows_t] = self._to_device(np.asarray(feats, np.float32))

    def invalid_rows(self) -> np.ndarray:
        return np.flatnonzero(~self.valid[: self.n_active])

    def nonfinite_rows(self) -> np.ndarray:
        """Active cache rows holding any non-finite embedding (int8 caches
        are checked on their decoded values)."""
        h = self.h1_f32()[: self.n_active].cpu().numpy()
        return np.flatnonzero(~np.isfinite(h).all(axis=1))

    def cache_resident_bytes(self) -> int:
        """Device bytes the h1 cache holds (payload + int8 scales)."""
        total = self.h1.numel() * self.h1.element_size()
        if self.h1_scale is not None:
            total += self.h1_scale.numel() * self.h1_scale.element_size()
        return int(total)

    def summary(self) -> dict:
        age = self.cache_age
        out = {
            "n_active": self.n_active,
            "capacity": self.store.capacity,
            "restored_step": self.restored_step,
            "backend": self.backend,
            "warm": self.warm,
            "valid_frac": float(self.valid[: self.n_active].mean())
            if self.n_active else 1.0,
            "cache_age_mean": float(age.mean()) if len(age) else 0.0,
            "cache_age_max": int(age.max()) if len(age) else 0,
            "rows_invalidated": self.n_invalidated,
            "rows_refreshed": self.n_refreshed,
            "h1_finite_frac": (1.0 - len(self.nonfinite_rows()) / self.n_active)
            if self.n_active else 1.0,
            "cache_dtype": self.cache_dtype,
            "cache_resident_bytes": self.cache_resident_bytes(),
        }
        if self.table_age is not None:
            out["table_age_mean"] = float(self.table_age.mean())
            out["table_age_max"] = int(self.table_age.max())
        return out
