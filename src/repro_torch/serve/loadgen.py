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

Still to port: ``validate_bench_serve``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.serve.engine import CACHE_POLICIES, QueryEngine

LOAD_MODES = ("open", "closed")


def _pctl(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if len(xs) else 0.0


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
                degraded: dict | None = None) -> dict:
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
