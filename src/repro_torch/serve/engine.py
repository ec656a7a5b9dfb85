"""QueryEngine: micro-batched node-classification queries over a ServedModel.

Port of ``repro/serve/engine.py``. Concurrent requests are packed into
micro-batches padded to a small fixed set of bucket shapes (8/32/128
rows). With the ``spmm`` backend the aggregations go through the
block-sparse SpMM kernel (``kernels.spmm``).

``fused`` (the default) serves each bucket as one aggregate → layer →
logits body per policy, the segment backend's bucketed CSR derived on the
device from the padded rows. On CUDA each (body, bucket) is a
``torch.cuda.CUDAGraph``: its first call runs the body eagerly (a real
call, which loads every kernel and library handle the capture then meets),
then captures it over static input buffers; every later call copies the
chunk's host rows into those buffers and replays. All graphs of an engine
share one memory pool and copy their logits into a buffer made outside
the capture. The SpMM launches recorded while capturing are added to
``block_spmm.launches`` on each replay. A failed capture or replay raises;
nothing falls back to the eager path. On the CPU the same bodies run
eagerly. ``fused=False`` is the reference's two-call pipeline: an
aggregate call, a return to the host, then a layer → logits call, with
the segment backend's CSR built on the host per chunk and copied over
(the bucketed form, ``graph.csr``: the port's segment backend refuses the
reference's real-edges-first layout, ROADMAP C2). It always runs eagerly.
Both give the same logits bit for bit; ``launch/serve_fed`` times them
against each other.

``trace_count`` counts the (body, bucket shape) pairs prepared — captured
on CUDA, run the first time on the CPU or by the two-call path — the
counterpart of the reference's jit traces: a fused warmup prepares 3 per
bucket (historical, fresh, refresh), a two-call warmup 5, and serving
after warmup prepares nothing (``trace_count_after_warmup``). A capacity
growth re-allocates the model's tables (``ServedModel.generation``): the
graphs are dropped and the next call of each pair prepares it again.

``cache_policy``:

* ``"historical"`` — layer-1 embeddings are read from the warm table;
* ``"fresh"`` — layer-1 is recomputed for the query's 1-hop neighborhood
  and written over a copy of the table, giving exact logits on a mutated
  graph.

Fixed shapes and real rows: a padded refresh or fresh batch sends its
padding rows to the model's scratch row (index ``capacity``, read by
nothing), so a padded row never overwrites a real one (ROADMAP C3).

Degraded modes (off by default, counters on the engine):

* ``fallback`` — a fresh chunk whose logits are non-finite (e.g. poisoned
  streaming features) is re-served from the warm historical cache
  (``n_fallbacks``). The check runs on the host after the call. Only that
  check (an ``ArithmeticError``) falls back: a ``RuntimeError`` from a
  kernel build, launch or capture propagates;
* ``deadline_ms`` — a fresh batch already queued past the deadline is
  downgraded to historical (``n_degraded``);
* ``max_queue`` — :meth:`admit` sheds requests past this queue occupancy
  (``n_rejected``).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.graph.csr import bucketed_csr_from_padded
from repro_torch.kernels.spmm.ops import block_spmm
from repro_torch.models.gcn import classify_rows, neighbor_aggregate, sage_layer_rows
from repro_torch.serve.model import ServedModel

CACHE_POLICIES = ("historical", "fresh")
DEFAULT_BUCKETS = (8, 32, 128)


class _Graph:
    """One captured (body, bucket): the graph, its static inputs and
    output, and the SpMM launches it recorded."""

    def __init__(self, graph, inputs: dict, output, launches: int):
        self.graph, self.inputs, self.output, self.launches = graph, inputs, output, launches


class QueryEngine:
    """Serves node-classification queries from a :class:`ServedModel`."""

    def __init__(self, model: ServedModel, *,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 cache_policy: str = "historical",
                 deadline_ms: float | None = None,
                 max_queue: int | None = None,
                 fallback: bool = True,
                 fused: bool = True):
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
        self.fused = bool(fused)
        self.n_rejected = 0      # requests shed at admission (queue full)
        self.n_degraded = 0      # fresh batches downgraded past deadline_ms
        self.n_fallbacks = 0     # fresh chunks re-served from the warm cache
        self.warmed_up = False
        self.trace_count = 0     # (body, bucket shape) pairs prepared
        self.trace_count_after_warmup: int | None = None
        self.replays: dict = {}  # graph replays per (body, bucket) (CUDA, fused)
        self.captures: list = []  # per capture: key, seconds, SpMM launches
        self._prepared: set = set()
        self._graphs: dict = {}
        self._pool = None
        self._generation = model.generation

    # ------------------------------------------------------------------
    # device compute
    # ------------------------------------------------------------------

    def _agg(self, table, idx, mask, seg=None):
        """Mean-aggregate ``table`` rows for the padded batch rows.
        ``seg=None`` (the fused path) derives the segment backend's bucketed
        CSR on the device; the two-call path passes the host-built one. The
        per-row sums are the same either way, so the logits agree bit for
        bit."""
        return neighbor_aggregate(table, idx, mask, backend=self.model.backend, csr=seg)

    def _embed(self, r, r_idx, r_mask, seg=None):
        """Fresh layer-1 rows for the (padded) rows ``r``."""
        feat = self.model.feat
        return sage_layer_rows(self.model.params, 0, feat[r],
                               self._agg(feat, r_idx, r_mask, seg))

    def _classify(self, table1, q, b_idx, b_mask, seg=None):
        p = self.model.params
        h2 = sage_layer_rows(p, 1, table1[q], self._agg(table1, b_idx, b_mask, seg))
        return classify_rows(p, h2)

    # -- fused: one aggregate→layer→logits body per (bucket, policy) -----

    def _hist_body(self, x):
        return self._classify(self.model.h1_f32(), x["q"], x["b_idx"], x["b_mask"])

    def _fresh_body(self, x):
        h1r = self._embed(x["r"], x["r_idx"], x["r_mask"])
        return self._classify(self.model.table_with_rows(x["r_dst"], h1r), x["q"],
                              x["b_idx"], x["b_mask"])

    def _refresh_body(self, x):
        self.model.write_cache_rows(x["r_dst"], self._embed(x["r"], x["r_idx"], x["r_mask"]))

    # -- two-call reference: aggregate call, host hop, head call ---------

    def _agg_hist_call(self, x):
        h1 = self.model.h1_f32()
        return h1[x["q"]], self._agg(h1, x["b_idx"], x["b_mask"], x.get("b_seg"))

    def _head_call(self, h1q, agg1):
        p = self.model.params
        return classify_rows(p, sage_layer_rows(p, 1, h1q, agg1))

    def _embed_call(self, x):
        h1r = self._embed(x["r"], x["r_idx"], x["r_mask"], x.get("r_seg"))
        return self.model.table_with_rows(x["r_dst"], h1r)

    def _classify_call(self, table1, x):
        return self._classify(table1, x["q"], x["b_idx"], x["b_mask"], x.get("b_seg"))

    def _refresh_call(self, x):
        h1r = self._embed(x["r"], x["r_idx"], x["r_mask"], x.get("r_seg"))
        self.model.write_cache_rows(x["r_dst"], h1r)

    # ------------------------------------------------------------------
    # preparation: a trace count per (body, shape); graphs on CUDA
    # ------------------------------------------------------------------

    def _check_generation(self) -> None:
        """Drop every graph once the model re-allocated its tables."""
        if self.model.generation != self._generation:
            self._generation = self.model.generation
            self._graphs, self._prepared, self._pool = {}, set(), None

    def _prepare(self, key) -> None:
        """Count ``key`` as prepared the first time it is met."""
        if key not in self._prepared:
            self._prepared.add(key)
            self.trace_count += 1

    def _to_device(self, host: dict) -> dict:
        """Host inputs (numpy arrays, or dicts of them: a CSR) on the
        model's device."""
        dev = self.model.device
        return {k: self._to_device(v) if isinstance(v, dict) else
                torch.from_numpy(v).to(dev) for k, v in host.items()}

    def _call(self, name: str, body, host: dict):
        """Run a fused body on the host inputs ``host`` (numpy arrays of one
        bucket's shape): by replay on CUDA once captured, else eagerly."""
        self._check_generation()
        key = (name, next(iter(host.values())).shape[0])
        if self.model.device.type != "cuda":
            self._prepare(key)
            return body(self._to_device(host))
        g = self._graphs.get(key)
        if g is None:
            return self._capture(key, body, host)
        for k, v in host.items():
            g.inputs[k].copy_(torch.from_numpy(v))
        g.graph.replay()
        block_spmm.launches += g.launches
        self.replays[key] = self.replays.get(key, 0) + 1
        return g.output

    def _capture(self, key, body, host: dict):
        """Run ``body`` eagerly on new static input buffers (the call's
        result), then record it into a graph of the shared pool."""
        inputs = self._to_device(host)
        out = body(inputs)
        output = None if out is None else torch.empty_like(out)
        graph = torch.cuda.CUDAGraph()
        before = block_spmm.captured
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=self._pool):
            res = body(inputs)
            if output is not None:
                output.copy_(res)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if self._pool is None:
            self._pool = graph.pool()
        launches = block_spmm.captured - before
        self._graphs[key] = _Graph(graph, inputs, output, launches)
        self._prepare(key)
        self.captures.append({"key": list(key), "seconds": seconds, "spmm_launches": launches})
        return out

    @property
    def graph_count(self) -> int:
        return len(self._graphs)

    # ------------------------------------------------------------------
    # host-side batching
    # ------------------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _pad_rows(self, rows: np.ndarray, cap: int) -> np.ndarray:
        padded = np.zeros(cap, np.int64)
        padded[: len(rows)] = rows
        return padded

    def _rows(self, rows: np.ndarray, n_pad: int, row: str, nbr: str) -> dict:
        """Host inputs for ``rows`` padded to ``n_pad``: the rows, their
        neighbor lists and, for the two-call segment path, their bucketed
        CSR built on the host (``<nbr>_seg``)."""
        padded = self._pad_rows(rows, n_pad)
        idx, mask = self.model.store.neighbors(padded)
        out = {row: padded, f"{nbr}_idx": idx, f"{nbr}_mask": mask}
        if not self.fused and self.model.backend == "segment":
            csr = bucketed_csr_from_padded(torch.from_numpy(idx), torch.from_numpy(mask))
            out[f"{nbr}_seg"] = {k: v.numpy() for k, v in csr.items()}
        return out

    def _refresh_rows(self, rows: np.ndarray, n_pad: int) -> dict:
        """Host inputs of a re-embed: ``rows`` padded to ``n_pad``, and the
        cache row each writes (``r_dst``; padding rows: the scratch row)."""
        x = self._rows(rows, n_pad, "r", "r")
        dst = np.full(n_pad, self.model.h1.shape[0], np.int64)
        dst[: len(rows)] = rows
        x["r_dst"] = dst
        return x

    def _twocall(self, policy: str, host: dict) -> torch.Tensor:
        """The two-call pipeline on one chunk: two eager calls with the
        host between them, each counted once per bucket."""
        self._check_generation()
        b = len(host["q"])
        x = self._to_device(host)
        if policy == "historical":
            self._prepare(("agg_hist", b))
            h1q, agg1 = self._agg_hist_call(x)
            self._prepare(("head", b))
            return self._head_call(h1q, agg1)
        self._prepare(("embed", b))
        table1 = self._embed_call(x)
        self._prepare(("classify", b))
        return self._classify_call(table1, x)

    def _logits(self, policy: str, host: dict) -> np.ndarray:
        if not self.fused:
            return self._twocall(policy, host).cpu().numpy()
        if policy == "historical":
            return self._call("hist", self._hist_body, host).cpu().numpy()
        return self._call("fresh", self._fresh_body, host).cpu().numpy()

    def _serve_chunk(self, ids: np.ndarray, policy: str):
        """One padded micro-batch at its bucket shape."""
        model, store = self.model, self.model.store
        b = self._bucket_for(len(ids))
        host = self._rows(ids, b, "q", "b")
        q, b_idx, b_mask = host["q"], host["b_idx"], host["b_mask"]
        n = len(ids)
        # cache rows this chunk reads under "historical": the query rows
        # plus their real neighbors (the hit-rate denominator)
        touched = np.unique(np.concatenate(
            [q[:n], b_idx[:n][b_mask[:n] > 0].astype(np.int64)]))
        hit_rate = float(model.valid[touched].mean()) if len(touched) else 1.0
        fell_back = False
        if policy == "fresh":
            r = np.unique(np.concatenate([q, b_idx[b_mask > 0].astype(np.int64)]))
            fresh = {**host, **self._refresh_rows(r, b * (store.max_deg + 1))}
            try:
                logits = self._logits("fresh", fresh)
                if self.fallback and not np.isfinite(logits[:n]).all():
                    raise ArithmeticError("non-finite fresh logits")
            except ArithmeticError:
                # degrade, don't fail: the warm historical cache still has
                # the last good embeddings for these rows
                self.n_fallbacks += 1
                fell_back = True
                policy = "historical"
        if policy == "historical":
            logits = self._logits("historical", host)
        info = {"bucket": b, "real": n, "touched": len(touched),
                "hit_rate": hit_rate, "policy": policy, "fell_back": fell_back}
        return logits[:n], info

    def _refresh(self, rows: np.ndarray, b: int) -> None:
        """Re-embed ``rows`` at bucket ``b`` and write them into the cache
        in place; the padding rows write the scratch row."""
        host = self._refresh_rows(rows, b)
        if self.fused:
            self._call("refresh", self._refresh_body, host)
        else:
            self._check_generation()
            self._prepare(("refresh", b))
            self._refresh_call(self._to_device(host))

    # ------------------------------------------------------------------
    # public serving surface
    # ------------------------------------------------------------------

    def warmup(self) -> int:
        """Prepare every (bucket, policy) serve shape plus the refresh shapes
        on inert dummy batches, so that kernel builds, first launches and
        captures fall outside served traffic; afterwards no query prepares
        anything (``trace_count_after_warmup``). Returns the SpMM kernel
        launches it made (0 off CUDA or for the other backends)."""
        before = block_spmm.launches
        for b in self.buckets:
            dummy = np.zeros(b, np.int64)
            for policy in CACHE_POLICIES:
                self._serve_chunk(dummy, policy)
            # refresh shape with no real row: writes the scratch row only
            self._refresh(np.zeros(0, np.int64), b)
        self.warmed_up = True
        self.trace_count_after_warmup = self.trace_count
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
        mirrored into the device tables and every shape re-warmed before
        the feature write, so the first query after it prepares nothing."""
        ids, affected = self.model.store.add_nodes(feats, edges)
        if self.model.ensure_capacity():
            self.warmup()
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
            self._refresh(chunk, self._bucket_for(len(chunk)))
            model.mark_written(chunk)
            total += len(chunk)
        return total
