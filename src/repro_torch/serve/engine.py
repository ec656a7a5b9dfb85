"""QueryEngine: micro-batched node-classification queries over a ServedModel.

Port of ``repro/serve/engine.py`` (the fused path). Concurrent requests are
packed into micro-batches padded to a small fixed set of bucket shapes
(8/32/128 rows); each (bucket, policy) runs one aggregate → layer → logits
pass on the model's device. With the ``spmm`` backend the aggregations go
through the block-sparse SpMM kernel (``kernels.spmm``).

``cache_policy``:

* ``"historical"`` — layer-1 embeddings are read from the warm table;
* ``"fresh"`` — layer-1 is recomputed for the query's 1-hop neighborhood
  and written over a copy of the table, giving exact logits on a mutated
  graph. Only the real rows are written: a padded row never overwrites one.

Degraded modes (off by default, counters on the engine):

* ``fallback`` — a fresh chunk whose logits are non-finite (e.g. poisoned
  streaming features) is re-served from the warm historical cache
  (``n_fallbacks``). Only that check (an ``ArithmeticError``) falls back: a
  ``RuntimeError`` from a kernel build or launch propagates;
* ``deadline_ms`` — a fresh batch already queued past the deadline is
  downgraded to historical (``n_degraded``);
* ``max_queue`` — :meth:`admit` sheds requests past this queue occupancy
  (``n_rejected``).

The reference counts jit traces to prove that no query recompiles after
warmup (``trace_count``). The port compiles nothing per shape, so the probe
is the SpMM kernel's launch counter (``kernels.spmm.ops.block_spmm.launches``):
:meth:`warmup` returns the launches it made and sets ``warmed_up``.

Still to port: the two-call ``fused=False`` pipeline.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.federated.quant import encode as quant_encode
from repro_torch.kernels.spmm.ops import block_spmm
from repro_torch.models.gcn import _sage_layer, neighbor_aggregate
from repro_torch.serve.model import ServedModel

CACHE_POLICIES = ("historical", "fresh")
DEFAULT_BUCKETS = (8, 32, 128)


class QueryEngine:
    """Serves node-classification queries from a :class:`ServedModel`."""

    def __init__(self, model: ServedModel, *,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 cache_policy: str = "historical",
                 deadline_ms: float | None = None,
                 max_queue: int | None = None,
                 fallback: bool = True):
        if cache_policy not in CACHE_POLICIES:
            raise ValueError(f"unknown cache_policy {cache_policy!r}; "
                             f"known: {CACHE_POLICIES}")
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be positive, got {deadline_ms}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.model = model
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets!r}")
        self.cache_policy = cache_policy
        self.deadline_ms = deadline_ms
        self.max_queue = max_queue
        self.fallback = bool(fallback)
        self.n_rejected = 0      # requests shed at admission (queue full)
        self.n_degraded = 0      # fresh batches downgraded past deadline_ms
        self.n_fallbacks = 0     # fresh chunks re-served from the warm cache
        self.warmed_up = False

    # ------------------------------------------------------------------
    # device compute: one aggregate→layer→logits pass per (bucket, policy)
    # ------------------------------------------------------------------

    def _agg(self, table, idx, mask):
        return neighbor_aggregate(table, idx, mask, backend=self.model.backend)

    def _logits(self, table1, qrows, b_idx, b_mask):
        p = self.model.params
        agg1 = self._agg(table1, b_idx, b_mask)
        h2 = _sage_layer(p, 1, table1[qrows], agg1)
        return h2 @ p["w_cls"] + p["b_cls"]

    def _embed(self, rrows, r_idx, r_mask):
        """Fresh layer-1 rows for the (padded) refresh rows."""
        feat = self.model.feat
        agg0 = self._agg(feat, r_idx, r_mask)
        return _sage_layer(self.model.params, 0, feat[rrows], agg0)

    def _fresh(self, qrows, b_idx, b_mask, rrows, n_real, r_idx, r_mask):
        h1 = self.model.h1_f32()
        h1r = self._embed(rrows, r_idx, r_mask)
        table1 = h1.clone() if h1 is self.model.h1 else h1
        table1[rrows[:n_real]] = h1r[:n_real]
        return self._logits(table1, qrows, b_idx, b_mask)

    def _refresh(self, rrows, n_real, r_idx, r_mask):
        """Re-embed the first ``n_real`` refresh rows and write them into
        the cache in place (the reference donates the cache buffer to the
        same effect); untouched rows keep their stored bits."""
        model = self.model
        h1r = self._embed(rrows, r_idx, r_mask)[:n_real]
        rows = rrows[:n_real]
        payload, scale = quant_encode(h1r, model.cache_dtype)
        model.h1[rows] = payload
        if scale is not None:
            model.h1_scale[rows] = scale

    # ------------------------------------------------------------------
    # host-side batching
    # ------------------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.model.device)

    def _rows_on_device(self, rows: np.ndarray):
        """Device (rows, nbr_idx, nbr_mask) for padded host rows."""
        idx, mask = self.model.store.neighbors(rows)
        return (self._dev(rows.astype(np.int64)), self._dev(idx),
                self._dev(mask))

    def _pad_rows(self, rows: np.ndarray, cap: int) -> np.ndarray:
        padded = np.zeros(cap, np.int64)
        padded[: len(rows)] = rows
        return padded

    def _serve_chunk(self, ids: np.ndarray, policy: str):
        """One padded micro-batch at its bucket shape."""
        model, store = self.model, self.model.store
        b = self._bucket_for(len(ids))
        q = self._pad_rows(ids, b)
        b_idx, b_mask = store.neighbors(q)
        n = len(ids)
        # cache rows this chunk reads under "historical": the query rows
        # plus their real neighbors (the hit-rate denominator)
        touched = np.unique(np.concatenate(
            [q[:n], b_idx[:n][b_mask[:n] > 0].astype(np.int64)]))
        hit_rate = float(model.valid[touched].mean()) if len(touched) else 1.0
        qrows, b_idx_t, b_mask_t = self._rows_on_device(q)
        fell_back = False
        if policy == "fresh":
            r = np.unique(np.concatenate(
                [q, b_idx[b_mask > 0].astype(np.int64)]))
            rrows, r_idx, r_mask = self._rows_on_device(
                self._pad_rows(r, b * (store.max_deg + 1)))
            try:
                logits = self._fresh(qrows, b_idx_t, b_mask_t, rrows, len(r),
                                     r_idx, r_mask).cpu().numpy()
                if self.fallback and not np.isfinite(logits[:n]).all():
                    raise ArithmeticError("non-finite fresh logits")
            except ArithmeticError:
                # degrade, don't fail: the warm historical cache still has
                # the last good embeddings for these rows
                self.n_fallbacks += 1
                fell_back = True
                policy = "historical"
        if policy == "historical":
            logits = self._logits(self.model.h1_f32(), qrows, b_idx_t,
                                  b_mask_t).cpu().numpy()
        info = {"bucket": b, "real": n, "touched": len(touched),
                "hit_rate": hit_rate, "policy": policy, "fell_back": fell_back}
        return logits[:n], info

    # ------------------------------------------------------------------
    # public serving surface
    # ------------------------------------------------------------------

    def warmup(self) -> int:
        """Run every (bucket, policy) serve shape plus the refresh shapes
        once on inert dummy batches, so that the kernel build and the first
        launches fall outside served traffic. Returns the SpMM kernel
        launches it made (0 off CUDA or for the other backends)."""
        before = block_spmm.launches
        for b in self.buckets:
            dummy = np.zeros(b, np.int64)
            for policy in CACHE_POLICIES:
                self._serve_chunk(dummy, policy)
            # refresh shape with no real row: computes, writes nothing
            rrows, r_idx, r_mask = self._rows_on_device(dummy)
            self._refresh(rrows, 0, r_idx, r_mask)
        self.warmed_up = True
        return block_spmm.launches - before

    def query(self, node_ids, policy: str | None = None) -> np.ndarray:
        """Logits (n, C) for one request (a list/array of node ids)."""
        [logits], _ = self.serve_batch([node_ids], policy=policy)
        return logits

    def admit(self, queue_depth: int) -> bool:
        """Admission control: False (and ``n_rejected`` bumps) when the
        queue is already at ``max_queue``. Always True when unset."""
        if self.max_queue is not None and queue_depth >= self.max_queue:
            self.n_rejected += 1
            return False
        return True

    def degraded_snapshot(self) -> dict:
        """The degradation counters, for ledgers / bench payloads."""
        return {"n_rejected": self.n_rejected, "n_degraded": self.n_degraded,
                "n_fallbacks": self.n_fallbacks}

    def serve_batch(self, requests, policy: str | None = None,
                    queue_ms: float | None = None):
        """Pack concurrent requests into padded micro-batches and serve them.

        Returns ``(per_request_logits, info)``; info carries the bucket
        occupancy and cache hit-rate. A ``"fresh"`` batch whose queueing
        delay ``queue_ms`` is past ``deadline_ms`` runs as ``"historical"``.
        """
        policy = self.cache_policy if policy is None else policy
        if policy not in CACHE_POLICIES:
            raise ValueError(f"unknown cache_policy {policy!r}")
        if (policy == "fresh" and self.deadline_ms is not None
                and queue_ms is not None and queue_ms > self.deadline_ms):
            policy = "historical"
            self.n_degraded += 1
        lens = []
        parts = []
        for r in requests:
            ids = np.asarray(r, np.int64).reshape(-1)
            self.model.store._check_ids(ids, "query")
            lens.append(len(ids))
            parts.append(ids)
        flat = np.concatenate(parts) if parts else np.zeros(0, np.int64)
        bmax = self.buckets[-1]
        outs, chunks = [], []
        for i in range(0, len(flat), bmax):
            logits, info = self._serve_chunk(flat[i: i + bmax], policy)
            outs.append(logits)
            chunks.append(info)
        all_logits = np.concatenate(outs) if outs else np.zeros((0, 1))
        per_request = []
        off = 0
        for ln in lens:
            per_request.append(all_logits[off: off + ln])
            off += ln
        tot_touch = sum(c["touched"] for c in chunks) or 1
        info = {
            "chunks": chunks,
            "bucket": chunks[0]["bucket"] if chunks else 0,
            "occupancy": (sum(c["real"] for c in chunks)
                          / max(sum(c["bucket"] for c in chunks), 1)),
            "hit_rate": sum(c["hit_rate"] * c["touched"] for c in chunks)
            / tot_touch,
            "policy": policy,
            "fell_back": any(c["fell_back"] for c in chunks),
        }
        self.model.step += 1
        return per_request, info

    # ------------------------------------------------------------------
    # streaming updates + background refresh
    # ------------------------------------------------------------------

    def add_edges(self, edges) -> np.ndarray:
        """Streaming edge insert: mutate the adjacency and invalidate exactly
        the affected cached rows (the edge endpoints)."""
        affected = self.model.store.add_edges(edges)
        self.model.invalidate(affected)
        return affected

    def add_nodes(self, feats, edges=None):
        """Streaming node insert (optionally with attachment edges):
        invalidates the new nodes' 1-hop neighborhood. A store growth is
        mirrored into the device tables before the feature write."""
        ids, affected = self.model.store.add_nodes(feats, edges)
        self.model.ensure_capacity()
        self.model.set_features(ids, self.model.store.features[ids])
        self.model.invalidate(affected)
        return ids, affected

    def refresh(self, max_rows: int | None = None) -> int:
        """Background refresh batch: re-embed up to ``max_rows`` invalidated
        cache rows at bucket shapes. Returns the number of rows re-embedded."""
        model = self.model
        rows = model.invalid_rows()
        if max_rows is not None:
            rows = rows[:max_rows]
        bmax = self.buckets[-1]
        total = 0
        for i in range(0, len(rows), bmax):
            chunk = rows[i: i + bmax]
            rrows, r_idx, r_mask = self._rows_on_device(
                self._pad_rows(chunk, self._bucket_for(len(chunk))))
            self._refresh(rrows, len(chunk), r_idx, r_mask)
            model.mark_written(chunk)
            total += len(chunk)
        return total
