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
``row_version``). The device tables are updated in place.

Still to port: ``restore`` from a federation checkpoint, ``save_federation``
and ``federation_template`` (with ``checkpoint/ckpt.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.federated.quant import check_sync_dtype
from repro_torch.federated.quant import decode as quant_decode
from repro_torch.federated.quant import encode as quant_encode
from repro_torch.models.gcn import HIDDEN, _sage_layer, neighbor_aggregate
from repro_torch.serve.updates import GraphStore

SERVE_BACKENDS = ("gather", "segment", "spmm")
WARM_MODES = ("refresh", "tables", "cold")


def _layer1_full(params, features, nbr_idx, nbr_mask, csr=None, adj=None,
                 backend: str = "segment") -> torch.Tensor:
    """Layer-1 embeddings for every row — the first layer of
    ``gcn_full_forward`` (same backend, same operands)."""
    agg = neighbor_aggregate(features, nbr_idx, nbr_mask, backend=backend,
                             csr=csr, adj=adj)
    return _sage_layer(params, 0, features, agg)


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
        self.step = 0                                          # serve-step clock
        self.row_version = np.zeros(cap, np.int64)             # step of last write
        self.table_age = table_age
        self.n_invalidated = 0
        self.n_refreshed = 0

        if warm == "refresh":
            self.h1, self.h1_scale = self.encode_cache(self.compute_layer1_full())
            self.valid[: store.n_active] = True
        elif warm == "tables":
            if table_h1 is None:
                raise ValueError("warm='tables' needs the scattered table_h1")
            h = np.zeros((cap, HIDDEN[0]), np.float32)
            h[: len(table_h1)] = table_h1
            self.h1, self.h1_scale = self.encode_cache(self._to_device(h))
            self.valid[: store.n_active] = True
        else:                                                  # cold
            self.h1, self.h1_scale = self.encode_cache(torch.zeros(
                (cap, HIDDEN[0]), dtype=torch.float32, device=self.device))

    # -- construction ----------------------------------------------------

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A device copy of a host array (never a view of the store's)."""
        return torch.tensor(arr, device=self.device)

    def encode_cache(self, h: torch.Tensor):
        """Encode a fp32 (cap, H1) table into the resident cache format —
        ``(payload, scale_or_None)`` per ``cache_dtype``."""
        return quant_encode(h, self.cache_dtype)

    def h1_f32(self) -> torch.Tensor:
        """The dequantized (cap, H1) cache (the payload itself for fp32)."""
        return quant_decode(self.h1, self.h1_scale, self.cache_dtype)

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
        if anything was re-allocated."""
        cap = self.store.capacity
        old = self.h1.shape[0]
        if cap == old:
            return False
        self.feat = self._to_device(self.store.features)
        h1 = self.h1.new_zeros((cap, self.h1.shape[1]))
        h1[:old] = self.h1
        self.h1 = h1
        if self.h1_scale is not None:
            scale = self.h1_scale.new_zeros((cap, 1))
            scale[:old] = self.h1_scale
            self.h1_scale = scale
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
