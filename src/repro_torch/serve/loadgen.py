"""Synthetic heavy-traffic load generator + latency ledger for the server.

Port of ``repro/serve/loadgen.py:161-463``: host numpy, so the same seed
issues the same ids, policies and updates as the reference
(tests/test_torch_serve.py). ``LoadGenerator`` drives a :class:`QueryEngine`
with seeded mixed traffic — node-classification queries (Zipf-popular node
ids, variable request sizes) interleaved with streaming graph updates (edge
inserts / node arrivals) and periodic background cache refreshes:

* ``mode="open"``  — open-loop Poisson arrivals at ``rate`` req/s: requests
  queue while the engine is busy, so latency includes queueing delay (the
  simulation clock advances by *measured* wall-clock service times);
* ``mode="closed"`` — ``concurrency`` clients each issue their next request
  the moment the previous one completes (latency == service time).

``LatencyLedger`` summarises the per-query records (p50/p99 per bucket,
queries/s, batch occupancy, cache hit/invalidation rates). Service times
are host clocks around calls that end in a device-to-host copy of the
logits, so they include the device work.

``validate_bench_serve`` is the write gate of a serve ledger
(``launch/serve_fed``): the reference's schema, with its ``cache`` and
``fused`` columns.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.federated.quant import SYNC_DTYPES
from repro_torch.serve.engine import CACHE_POLICIES, QueryEngine

LOAD_MODES = ("open", "closed")

# a serve ledger's required top-level keys (see validate_bench_serve)
_TOP_KEYS = ("bench", "backend", "devices", "quick", "mode", "policy_mix",
             "n_queries", "n_updates", "queries_per_s", "p50_ms", "p99_ms",
             "batch_occupancy", "cache_hit_rate", "invalidation_rate",
             "rows_invalidated", "rows_refreshed", "buckets")
_BUCKET_KEYS = ("bucket", "n", "p50_ms", "p99_ms")
# the accuracy-vs-latency cache column (launch.serve_fed --cache-dtype),
# optional in a payload
_CACHE_KEYS = ("cache_dtype", "resident_bytes", "serve_accuracy")
# the fused-vs-two-call column (launch.serve_fed measures both engine modes
# on the same warm model), optional in a payload; the pipeline gates
# p50_ms <= twocall_p50_ms with nothing prepared after warmup
_FUSED_KEYS = ("bucket", "p50_ms", "twocall_p50_ms", "speedup",
               "recompiles_after_warmup")


def _pctl(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if len(xs) else 0.0


def validate_bench_serve(payload) -> list[str]:
    """Schema-check a serve ledger payload. Returns a list of problems
    (empty = valid): required keys present and typed, percentiles ordered,
    rates in range, and the per-bucket rows accounting for every query."""
    errs: list[str] = []
    if not isinstance(payload, dict):
        return [f"payload is {type(payload).__name__}, expected dict"]
    for k in _TOP_KEYS:
        if k not in payload:
            errs.append(f"missing key {k!r}")
    if errs:
        return errs
    if payload["bench"] != "serve_latency":
        errs.append(f"bench is {payload['bench']!r}, expected 'serve_latency'")
    if not isinstance(payload["devices"], int) or payload["devices"] < 1:
        errs.append(f"devices must be a positive int, got {payload['devices']!r}")
    if not isinstance(payload["quick"], bool):
        errs.append(f"quick must be a bool, got {payload['quick']!r}")
    if payload["mode"] not in LOAD_MODES:
        errs.append(f"mode must be one of {LOAD_MODES}, got {payload['mode']!r}")
    if not isinstance(payload["policy_mix"], dict) or not all(
            p in CACHE_POLICIES for p in payload["policy_mix"]):
        errs.append(f"policy_mix must map {CACHE_POLICIES} to weights, "
                    f"got {payload['policy_mix']!r}")
    nq, nu = payload["n_queries"], payload["n_updates"]
    if not isinstance(nq, int) or nq < 1:
        errs.append(f"n_queries must be a positive int, got {nq!r}")
    if not isinstance(nu, int) or nu < 0:
        errs.append(f"n_updates must be a non-negative int, got {nu!r}")
    for k in ("queries_per_s", "p50_ms", "p99_ms"):
        v = payload[k]
        if not isinstance(v, (int, float)) or not v > 0:
            errs.append(f"{k} must be positive, got {v!r}")
    if isinstance(payload["p50_ms"], (int, float)) \
            and isinstance(payload["p99_ms"], (int, float)) \
            and payload["p99_ms"] < payload["p50_ms"]:
        errs.append(f"p99_ms {payload['p99_ms']!r} < p50_ms {payload['p50_ms']!r}")
    occ = payload["batch_occupancy"]
    if not isinstance(occ, (int, float)) or not 0 < occ <= 1:
        errs.append(f"batch_occupancy must be in (0, 1], got {occ!r}")
    for k in ("cache_hit_rate", "invalidation_rate"):
        v = payload[k]
        if not isinstance(v, (int, float)) or not 0 <= v <= 1:
            errs.append(f"{k} must be in [0, 1], got {v!r}")
    for k in ("rows_invalidated", "rows_refreshed"):
        v = payload[k]
        if not isinstance(v, int) or v < 0:
            errs.append(f"{k} must be a non-negative int, got {v!r}")
    buckets = payload["buckets"]
    if not isinstance(buckets, list) or not buckets:
        return errs + ["buckets must be a non-empty list"]
    n_acc = 0
    for i, row in enumerate(buckets):
        if not isinstance(row, dict) or any(k not in row for k in _BUCKET_KEYS):
            errs.append(f"buckets[{i}] missing keys (need {_BUCKET_KEYS})")
            continue
        if not isinstance(row["bucket"], int) or row["bucket"] < 1:
            errs.append(f"buckets[{i}].bucket must be a positive int")
        if not isinstance(row["n"], int) or row["n"] < 0:
            errs.append(f"buckets[{i}].n must be a non-negative int")
        else:
            n_acc += row["n"]
        if isinstance(row.get("p50_ms"), (int, float)) \
                and isinstance(row.get("p99_ms"), (int, float)) \
                and row["p99_ms"] < row["p50_ms"]:
            errs.append(f"buckets[{i}]: p99_ms < p50_ms")
    if isinstance(nq, int) and n_acc != nq and not errs:
        errs.append(f"bucket rows account for {n_acc} queries, "
                    f"n_queries says {nq}")
    cache = payload.get("cache")
    if cache is not None:
        if not isinstance(cache, dict) or any(k not in cache
                                              for k in _CACHE_KEYS):
            errs.append(f"cache column missing keys (need {_CACHE_KEYS})")
        else:
            if cache["cache_dtype"] not in SYNC_DTYPES:
                errs.append(f"cache.cache_dtype must be one of {SYNC_DTYPES}, "
                            f"got {cache['cache_dtype']!r}")
            rb = cache["resident_bytes"]
            if not isinstance(rb, int) or rb < 1:
                errs.append(f"cache.resident_bytes must be a positive int, "
                            f"got {rb!r}")
            acc = cache["serve_accuracy"]
            if not isinstance(acc, (int, float)) or not 0.0 <= acc <= 1.0:
                errs.append(f"cache.serve_accuracy must be in [0, 1], "
                            f"got {acc!r}")
    fused = payload.get("fused")
    if fused is not None:
        if not isinstance(fused, dict) or any(k not in fused
                                              for k in _FUSED_KEYS):
            errs.append(f"fused column missing keys (need {_FUSED_KEYS})")
        else:
            if not isinstance(fused["bucket"], int) or fused["bucket"] < 1:
                errs.append(f"fused.bucket must be a positive int, "
                            f"got {fused['bucket']!r}")
            for k in ("p50_ms", "twocall_p50_ms", "speedup"):
                v = fused[k]
                if not isinstance(v, (int, float)) or not v > 0:
                    errs.append(f"fused.{k} must be positive, got {v!r}")
            rc = fused["recompiles_after_warmup"]
            if not isinstance(rc, int) or rc < 0:
                errs.append(f"fused.recompiles_after_warmup must be a "
                            f"non-negative int, got {rc!r}")
    return errs



@dataclass
class QueryRecord:
    arrival: float          # sim-clock seconds
    done: float
    n_nodes: int
    bucket: int
    policy: str
    hit_rate: float

    @property
    def latency_ms(self) -> float:
        return (self.done - self.arrival) * 1e3


@dataclass
class LatencyLedger:
    """Accumulates per-query/update records and emits the BENCH payload."""

    queries: list = field(default_factory=list)
    updates: list = field(default_factory=list)
    occupancies: list = field(default_factory=list)
    refresh_rows: int = 0
    horizon_s: float = 0.0
    rejects: int = 0

    def record_query(self, **kw) -> None:
        self.queries.append(QueryRecord(**kw))

    def record_reject(self) -> None:
        self.rejects += 1

    def record_update(self, kind: str, n_invalidated: int, dt_s: float) -> None:
        self.updates.append({"kind": kind, "n_invalidated": n_invalidated,
                             "dt_s": dt_s})

    def record_batch(self, occupancy: float) -> None:
        self.occupancies.append(occupancy)

    def record_refresh(self, n_rows: int) -> None:
        self.refresh_rows += n_rows

    def summary(self, *, backend: str, devices: int, quick: bool, mode: str,
                policy_mix: dict, model_summary: dict | None = None,
                degraded: dict | None = None,
                cache: dict | None = None,
                fused: dict | None = None) -> dict:
        lat = [q.latency_ms for q in self.queries]
        by_bucket: dict[int, list] = {}
        by_policy: dict[str, list] = {}
        for q in self.queries:
            by_bucket.setdefault(q.bucket, []).append(q.latency_ms)
            by_policy.setdefault(q.policy, []).append(q.latency_ms)
        n_inval = sum(u["n_invalidated"] for u in self.updates)
        n_touched = sum(q.n_nodes for q in self.queries)
        payload = {
            "bench": "serve_latency",
            "backend": backend,
            "devices": devices,
            "quick": quick,
            "mode": mode,
            "policy_mix": dict(policy_mix),
            "n_queries": len(self.queries),
            "n_updates": len(self.updates),
            "queries_per_s": len(self.queries) / max(self.horizon_s, 1e-9),
            "nodes_per_s": n_touched / max(self.horizon_s, 1e-9),
            "p50_ms": _pctl(lat, 50),
            "p99_ms": _pctl(lat, 99),
            "batch_occupancy": (float(np.mean(self.occupancies))
                                if self.occupancies else 0.0),
            "cache_hit_rate": (float(np.mean([q.hit_rate for q in self.queries]))
                               if self.queries else 1.0),
            "invalidation_rate": n_inval / max(n_inval + n_touched, 1),
            "rows_invalidated": n_inval,
            "rows_refreshed": self.refresh_rows,
            "buckets": [
                {"bucket": b, "n": len(xs), "p50_ms": _pctl(xs, 50),
                 "p99_ms": _pctl(xs, 99)}
                for b, xs in sorted(by_bucket.items())
            ],
            "policies": {
                p: {"n": len(xs), "p50_ms": _pctl(xs, 50), "p99_ms": _pctl(xs, 99)}
                for p, xs in sorted(by_policy.items())
            },
        }
        if model_summary:
            payload["model"] = model_summary
        if cache is not None:
            # the accuracy-vs-latency column: which wire format the h1
            # cache is resident in, what it costs, what accuracy it serves
            payload["cache"] = dict(cache)
        if fused is not None:
            # the fused-vs-two-call A/B (launch.serve_fed measures both
            # engine modes on the same warm model + bucket)
            payload["fused"] = dict(fused)
        if degraded is not None or self.rejects:
            # engine degradation counters + the requests this ledger shed
            payload["degraded"] = {"n_shed": self.rejects, **(degraded or {})}
        return payload


class LoadGenerator:
    """Seeded synthetic traffic against a warmed :class:`QueryEngine`."""

    def __init__(self, engine: QueryEngine, *, seed: int = 0,
                 n_queries: int = 200, n_updates: int = 20,
                 mode: str = "open", rate: float = 500.0,
                 concurrency: int = 8, query_size: tuple[int, int] = (1, 4),
                 policy_mix: dict | None = None,
                 update_mix: dict | None = None,
                 zipf_a: float = 1.3, refresh_every: int = 4,
                 refresh_rows: int | None = None):
        if mode not in LOAD_MODES:
            raise ValueError(f"unknown mode {mode!r}; known: {LOAD_MODES}")
        self.engine = engine
        self.seed = int(seed)
        self.rng = np.random.default_rng(seed)
        self.n_queries = int(n_queries)
        self.n_updates = int(n_updates)
        self.mode = mode
        self.rate = float(rate)
        self.concurrency = int(concurrency)
        self.query_size = query_size
        self.policy_mix = dict(policy_mix or {"historical": 0.9, "fresh": 0.1})
        if not all(p in CACHE_POLICIES for p in self.policy_mix):
            raise ValueError(f"policy_mix keys must be in {CACHE_POLICIES}")
        self.update_mix = dict(update_mix or {"edges": 0.75, "nodes": 0.25})
        self.zipf_a = zipf_a
        self.refresh_every = int(refresh_every)
        self.refresh_rows = refresh_rows

    # -- traffic synthesis ----------------------------------------------

    def _node_ids(self, n: int) -> np.ndarray:
        """Zipf-popular node ids over the live rows (heavy-traffic skew)."""
        n_active = self.engine.model.n_active
        ranks = np.minimum(self.rng.zipf(self.zipf_a, size=n), n_active) - 1
        # a fixed permutation decouples popularity rank from node id; it is
        # derived from this generator's own seed (salted so it does not
        # mirror any other seed-keyed stream) rather than a hard-coded
        # constant, so differently-seeded generators hammer different hot
        # sets — and it deliberately does NOT consume from self.rng, which
        # would shift every later arrival/policy draw whenever n_active
        # grows past a re-derivation
        if getattr(self, "_perm_n", None) != n_active:
            self._perm = np.random.default_rng(
                (self.seed, 12345)).permutation(n_active)
            self._perm_n = n_active
        return self._perm[ranks]

    def _make_query(self, arrival: float) -> dict:
        lo, hi = self.query_size
        size = int(self.rng.integers(lo, hi + 1))
        names, probs = zip(*self.policy_mix.items())
        policy = str(self.rng.choice(names, p=np.asarray(probs) / sum(probs)))
        return {"t": arrival, "ids": self._node_ids(size), "policy": policy}

    def _apply_update(self, ledger: LatencyLedger) -> float:
        """One streaming update; returns its measured wall-clock seconds."""
        eng = self.engine
        names, probs = zip(*self.update_mix.items())
        kind = str(self.rng.choice(names, p=np.asarray(probs) / sum(probs)))
        t0 = time.perf_counter()
        if kind == "nodes":
            # a new node arrives with features near an existing node's and
            # attaches to 1-3 popular anchors
            anchor = int(self._node_ids(1)[0])
            feat = (eng.model.store.features[anchor]
                    + 0.1 * self.rng.standard_normal(eng.model.store.n_features))
            new_id = eng.model.n_active
            anchors = self._node_ids(int(self.rng.integers(1, 4)))
            edges = [(new_id, int(a)) for a in anchors]
            _, affected = eng.add_nodes(feat[None, :], edges)
        else:
            u, v = self._node_ids(2)
            affected = eng.add_edges([(int(u), int(v))])
        dt = time.perf_counter() - t0
        ledger.record_update(kind, len(affected), dt)
        return dt

    # -- the drive loop --------------------------------------------------

    def run(self) -> LatencyLedger:
        if not self.engine.warmed_up:
            self.engine.warmup()
        ledger = LatencyLedger()
        if self.mode == "open":
            self._run_open(ledger)
        else:
            self._run_closed(ledger)
        return ledger

    def _serve(self, batch: list[dict], now: float,
               ledger: LatencyLedger) -> float:
        """Serve one packed micro-batch; returns the completion time."""
        # queueing delay so far drives the engine's deadline downgrade
        queue_ms = max(0.0, (now - min(q["t"] for q in batch)) * 1e3)
        t0 = time.perf_counter()
        _, info = self.engine.serve_batch([q["ids"] for q in batch],
                                          policy=batch[0]["policy"],
                                          queue_ms=queue_ms)
        dt = time.perf_counter() - t0
        done = now + dt
        ledger.record_batch(info["occupancy"])
        for q, chunk in zip(batch, _spread(info["chunks"], batch)):
            # record the policy that actually ran (deadline downgrades and
            # fresh-path fallbacks land in the "historical" bucket)
            ledger.record_query(arrival=q["t"], done=done, n_nodes=len(q["ids"]),
                                bucket=chunk["bucket"], policy=chunk["policy"],
                                hit_rate=info["hit_rate"])
        return done

    def _run_open(self, ledger: LatencyLedger) -> None:
        """Poisson arrivals; the engine drains the queue batch by batch."""
        n_ev = self.n_queries + self.n_updates
        gaps = self.rng.exponential(1.0 / self.rate, size=n_ev)
        times = np.cumsum(gaps)
        kinds = np.array(["q"] * self.n_queries + ["u"] * self.n_updates)
        self.rng.shuffle(kinds)
        events = [(float(t), k) for t, k in zip(times, kinds)]
        bmax = self.engine.buckets[-1]
        now, i, n_batches = 0.0, 0, 0
        pending: list[dict] = []
        while i < len(events) or pending:
            if not pending and i < len(events):
                now = max(now, events[i][0])
            while i < len(events) and events[i][0] <= now:
                t, kind = events[i]
                i += 1
                if kind == "q":
                    if self.engine.admit(len(pending)):
                        pending.append(self._make_query(t))
                    else:
                        ledger.record_reject()
                else:
                    now += self._apply_update(ledger)
            if not pending:
                continue
            # pack queued same-policy requests into one micro-batch
            policy = pending[0]["policy"]
            batch, rows = [], 0
            while pending and pending[0]["policy"] == policy \
                    and rows + len(pending[0]["ids"]) <= bmax:
                q = pending.pop(0)
                batch.append(q)
                rows += len(q["ids"])
            if not batch:                       # single oversized request
                batch = [pending.pop(0)]
            now = self._serve(batch, now, ledger)
            n_batches += 1
            if self.refresh_every and n_batches % self.refresh_every == 0:
                t0 = time.perf_counter()
                n = self.engine.refresh(self.refresh_rows)
                if n:
                    now += time.perf_counter() - t0
                    ledger.record_refresh(n)
        ledger.horizon_s = now

    def _run_closed(self, ledger: LatencyLedger) -> None:
        """``concurrency`` clients in lockstep: every completion immediately
        issues the next request, so each batch carries one request per
        client and latency equals service time."""
        now, served, n_batches = 0.0, 0, 0
        upd_interval = (max(1, self.n_queries // self.n_updates)
                        if self.n_updates else 0)
        updates_done = 0
        while served < self.n_queries:
            c = min(self.concurrency, self.n_queries - served)
            batch = [self._make_query(now) for _ in range(c)]
            # all requests in a closed-loop batch share one policy draw
            policy = batch[0]["policy"]
            for q in batch:
                q["policy"] = policy
            now = self._serve(batch, now, ledger)
            served += c
            n_batches += 1
            if upd_interval and updates_done < self.n_updates \
                    and served // upd_interval > updates_done:
                now += self._apply_update(ledger)
                updates_done += 1
            if self.refresh_every and n_batches % self.refresh_every == 0:
                t0 = time.perf_counter()
                n = self.engine.refresh(self.refresh_rows)
                if n:
                    now += time.perf_counter() - t0
                    ledger.record_refresh(n)
        # drain any never-applied updates so n_updates is honest
        while updates_done < self.n_updates:
            now += self._apply_update(ledger)
            updates_done += 1
        ledger.horizon_s = now


def _spread(chunks: list[dict], batch: list[dict]) -> list[dict]:
    """Assign each request the chunk it landed in (requests are packed in
    order; a request spanning chunks reports its first one)."""
    out = []
    ci, used = 0, 0
    for q in batch:
        if ci < len(chunks) - 1 and used >= chunks[ci]["real"]:
            ci += 1
            used = 0
        out.append(chunks[ci])
        used += len(q["ids"])
    return out
