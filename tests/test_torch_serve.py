"""The port's serving path against the reference's, on the CPU.

Both sides are built the same way — reference params (carried across with
``params_from_numpy``) + a ``GraphStore`` over the same arrays,
``warm="refresh"`` — and served the same queries. Logits agree at
atol = rtol = 1e-4: they pass through three dense products that XLA and
torch sum in different orders, one step looser than the single SpMM.
Host-side state (invalidation sets, the load stream) is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph.data import make_dataset
from repro.models.gcn import gcn_init as jgcn_init
from repro.serve import GraphStore as JStore
from repro.serve import LoadGenerator as JLoad
from repro.serve import QueryEngine as JEngine
from repro.serve import ServedModel as JModel
from repro_torch.convert import params_from_numpy
from repro_torch.federated.server import build_eval_graph, eval_logits
from repro_torch.graph.csr import build_padded_neighbors
from repro_torch.serve import GraphStore, LoadGenerator, QueryEngine, ServedModel
from repro_torch.serve import engine as tengine

TOL = 1e-4
BUCKETS = (8, 32)
MAX_DEG = 8


@pytest.fixture(scope="module")
def world():
    g = make_dataset("pubmed", scale=64, seed=0)
    idx, mask = build_padded_neighbors(g.adjacency_lists(), MAX_DEG, seed=0)
    jp = jgcn_init(jax.random.PRNGKey(0), g.n_features, g.n_classes)
    return g, idx, mask, {k: np.asarray(v) for k, v in jp.items()}


def port_engine(world, backend="gather", warm="refresh", cache_dtype="fp32", **kw):
    g, idx, mask, p = world
    model = ServedModel(params_from_numpy(p, "cpu"), GraphStore(g.features, idx, mask),
                        backend=backend, warm=warm, cache_dtype=cache_dtype,
                        device="cpu")
    return model, QueryEngine(model, buckets=BUCKETS, **kw)


def ref_engine(world, backend="gather", **kw):
    g, idx, mask, p = world
    model = JModel({k: jnp.asarray(v) for k, v in p.items()},
                   JStore(g.features, idx, mask), backend=backend, warm="refresh")
    return model, JEngine(model, buckets=BUCKETS, **kw)


def serve_all(engine, n, policy, step=32):
    return np.concatenate([engine.query(np.arange(i, min(i + step, n)), policy=policy)
                           for i in range(0, n, step)])


@pytest.mark.parametrize("backend", ["gather", "segment", "spmm"])
def test_served_logits_match_reference_and_eval_path(world, backend):
    g = world[0]
    n = g.n_nodes
    _, te = port_engine(world, backend)
    _, je = ref_engine(world, backend)
    assert te.warmup() == 0                     # CPU tensors: no kernel launch
    je.warmup()
    port = {p: serve_all(te, n, p) for p in ("historical", "fresh")}
    for policy, got in port.items():
        want = serve_all(je, n, policy)
        assert got.shape == want.shape == (n, g.n_classes)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL, err_msg=policy)
    np.testing.assert_allclose(port["historical"], port["fresh"], atol=1e-5, rtol=1e-5)
    # historical logits equal the port's own eval path (the reference holds
    # the same of itself, tests/test_serve.py): bit for bit where both take
    # the same per-row sums; the spmm backend multiplies a (bucket, capacity)
    # adjacency here and an (n, n) one there, so it agrees to rounding
    eg = build_eval_graph(g, max_deg=MAX_DEG, seed=0, backend=backend, device="cpu")
    ev = eval_logits(te.model.params, eg).numpy()
    if backend == "spmm":
        np.testing.assert_allclose(port["historical"], ev, atol=1e-5, rtol=1e-5)
    else:
        assert np.array_equal(port["historical"], ev)


def test_updates_invalidate_exactly_like_reference(world):
    tm, te = port_engine(world)
    jm, je = ref_engine(world)
    rng = np.random.default_rng(0)
    n = tm.n_active
    # rows >= 1 only: the reference's padded scatter can overwrite a fresh
    # row 0 with its stale cached value (test_refresh_of_row_zero_is_exact)
    for _ in range(4):
        e = rng.integers(1, n, (3, 2))
        assert np.array_equal(te.add_edges(e), je.add_edges(e))
    for c in (1, 2):
        feats = rng.standard_normal((c, tm.store.n_features)).astype(np.float32)
        att = [(tm.n_active, int(rng.integers(1, n)))]
        (ti, ta), (ji, ja) = te.add_nodes(feats, att), je.add_nodes(feats, att)
        assert np.array_equal(ti, ji) and np.array_equal(ta, ja)
    assert np.array_equal(tm.valid, jm.valid)
    assert np.array_equal(tm.invalid_rows(), jm.invalid_rows())
    assert tm.n_invalidated == jm.n_invalidated
    q = np.unique(np.concatenate([tm.invalid_rows(), np.arange(5)]))
    np.testing.assert_allclose(te.query(q, policy="fresh"), je.query(q, policy="fresh"),
                               atol=TOL, rtol=TOL)
    # refresh re-embeds exactly the invalid rows and restores agreement
    n_invalid = len(tm.invalid_rows())
    assert n_invalid > 0 and te.refresh() == je.refresh() == n_invalid
    assert tm.valid[: tm.n_active].all() and len(tm.invalid_rows()) == 0
    assert np.array_equal(tm.valid, jm.valid)
    hist, fresh = te.query(q, policy="historical"), te.query(q, policy="fresh")
    np.testing.assert_allclose(hist, fresh, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(hist, je.query(q, policy="historical"), atol=TOL, rtol=TOL)
    s, js = tm.summary(), jm.summary()
    assert s.keys() == js.keys()
    for k in ("n_active", "capacity", "valid_frac", "rows_invalidated",
              "rows_refreshed", "h1_finite_frac"):
        assert s[k] == js[k], k


def test_refresh_of_row_zero_is_exact(world):
    """Padded batch rows point at row 0; only real rows may be written.
    (The reference's ``h1.at[rrows].set(...)`` also writes the padding
    entries, each carrying row 0's stale cached value, so a stale row 0
    can stay stale through ``refresh`` and the fresh path.)"""
    g, idx, mask, _ = world
    model, engine = port_engine(world)
    feats = np.full((1, g.n_features), 3.0, np.float32)
    model.store.features[0] = feats
    model.set_features(np.array([0]), feats)
    nbrs = idx[0][mask[0] > 0]
    model.invalidate(np.concatenate([[0], nbrs]))      # row 0's 1-hop rows
    q = np.array([0] + [int(v) for v in nbrs[:3]])
    fresh = engine.query(q, policy="fresh")
    assert engine.refresh() == 1 + len(nbrs)
    np.testing.assert_allclose(engine.query(q, policy="historical"), fresh,
                               atol=1e-5, rtol=1e-5)
    cold_model, cold = port_engine(world, warm="cold")
    cold_model.store.features[0] = feats
    cold_model.set_features(np.array([0]), feats)
    np.testing.assert_allclose(cold.query(q, policy="fresh"), fresh, atol=1e-5, rtol=1e-5)


def _record_stream(engine):
    calls = []
    orig = engine.serve_batch

    def wrapped(requests, policy=None, queue_ms=None):
        calls.append(([np.asarray(r).tolist() for r in requests], policy))
        return orig(requests, policy=policy, queue_ms=queue_ms)

    engine.serve_batch = wrapped
    return calls


def test_loadgen_stream_matches_reference(world):
    tm, te = port_engine(world)
    jm, je = ref_engine(world)
    tcalls, jcalls = _record_stream(te), _record_stream(je)
    kw = dict(seed=3, n_queries=40, n_updates=6, mode="closed", concurrency=4,
              refresh_every=2)
    tl, jl = LoadGenerator(te, **kw).run(), JLoad(je, **kw).run()
    assert te.warmed_up                              # run() warmed the engine
    assert tcalls == jcalls
    assert tl.updates and [(u["kind"], u["n_invalidated"]) for u in tl.updates] \
        == [(u["kind"], u["n_invalidated"]) for u in jl.updates]
    assert [(q.n_nodes, q.bucket, q.policy) for q in tl.queries] \
        == [(q.n_nodes, q.bucket, q.policy) for q in jl.queries]
    assert tl.refresh_rows == jl.refresh_rows
    for f in ("features", "nbr_idx", "nbr_mask"):
        assert np.array_equal(getattr(tm.store, f), getattr(jm.store, f))
    assert np.array_equal(tm.valid, jm.valid)
    payload = tl.summary(backend="gather", devices=1, quick=True, mode="closed",
                         policy_mix={"historical": 0.9, "fresh": 0.1},
                         degraded=te.degraded_snapshot())
    assert payload["n_queries"] == 40 and payload["n_updates"] == 6
    assert sum(b["n"] for b in payload["buckets"]) == 40
    # the open loop packs by measured service times (not exact across
    # runs), so it is only driven here
    ol = LoadGenerator(te, seed=1, n_queries=12, n_updates=3, mode="open",
                       rate=2000.0).run()
    assert len(ol.queries) == 12 and len(ol.updates) == 3
    with pytest.raises(ValueError, match="mode"):
        LoadGenerator(te, mode="diagonal")


def test_poisoned_fresh_falls_back_to_warm_cache(world):
    model, engine = port_engine(world)
    engine.warmup()
    q = np.arange(12)
    warm = engine.query(q, policy="historical")
    clean = model.feat.clone()
    model.feat[:] = float("nan")
    [got], info = engine.serve_batch([q], policy="fresh")
    assert np.isfinite(got).all() and np.array_equal(got, warm)
    assert info["fell_back"] and engine.n_fallbacks == 1
    assert info["policy"] == "fresh"
    assert all(c["policy"] == "historical" for c in info["chunks"])
    # fallback off: the raw non-finite fresh logits come back, no counter
    smodel, strict = port_engine(world, fallback=False)
    smodel.feat[:] = float("nan")
    assert not np.isfinite(strict.query(q, policy="fresh")).all()
    assert strict.n_fallbacks == 0
    model.feat[:] = clean
    assert np.isfinite(engine.query(q, policy="fresh")).all()


def test_runtime_error_in_aggregation_does_not_fall_back(world, monkeypatch):
    """Only the non-finite check falls back; a failing kernel (build or
    launch: RuntimeError) propagates even with fallback on."""
    _, engine = port_engine(world, fallback=True)

    def broken(*a, **k):
        raise RuntimeError("spmm_block_f32 launch failed")

    monkeypatch.setattr(tengine, "neighbor_aggregate", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        engine.query(np.arange(4), policy="fresh")
    assert engine.n_fallbacks == 0


def test_degraded_modes(world):
    _, engine = port_engine(world, deadline_ms=5.0, max_queue=2)
    q = [np.arange(8)]
    assert engine.serve_batch(q, policy="fresh", queue_ms=1.0)[1]["policy"] == "fresh"
    assert engine.serve_batch(q, policy="fresh", queue_ms=9.0)[1]["policy"] == "historical"
    assert engine.n_degraded == 1
    assert engine.admit(1) and not engine.admit(2) and engine.n_rejected == 1
    assert engine.degraded_snapshot() == {"n_rejected": 1, "n_degraded": 1,
                                          "n_fallbacks": 0}
    with pytest.raises(ValueError):
        QueryEngine(engine.model, cache_policy="psychic")
    with pytest.raises(ValueError):
        engine.query([10 ** 6])


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
def test_quantized_cache_serves_and_refreshes(world, cache_dtype):
    g = world[0]
    m32, e32 = port_engine(world)
    mq, eq = port_engine(world, cache_dtype=cache_dtype)
    jm = JModel({k: jnp.asarray(v) for k, v in world[3].items()},
                JStore(g.features, world[1], world[2]), warm="cold",
                cache_dtype=cache_dtype)
    assert mq.cache_resident_bytes() == jm.cache_resident_bytes()
    ids = np.arange(64)
    # quantization error of the cache, not a parity tolerance
    np.testing.assert_allclose(eq.query(ids), e32.query(ids),
                               atol={"bf16": 0.05, "int8": 0.25}[cache_dtype])
    eq.add_edges([(0, 1), (2, 3)])
    assert eq.refresh() == 4 and len(mq.nonfinite_rows()) == 0
    assert mq.h1.dtype == {"bf16": torch.bfloat16, "int8": torch.int8}[cache_dtype]


def test_capacity_growth_keeps_the_warm_cache(world):
    g, idx, mask, p = world
    n = g.n_nodes
    model = ServedModel(params_from_numpy(p, "cpu"),
                        GraphStore(g.features, idx, mask, capacity=n + 1),
                        warm="refresh", device="cpu")
    engine = QueryEngine(model, buckets=BUCKETS)
    before = model.h1[:n].clone()
    feats = np.ones((3, g.n_features), np.float32)
    ids, _ = engine.add_nodes(feats, [(n, 0), (n + 2, 5)])
    assert model.store.n_grows == 1 and model.h1.shape[0] == model.store.capacity
    assert torch.equal(model.h1[:n], before)
    assert torch.equal(model.feat[ids], torch.from_numpy(feats))
    engine.refresh()
    assert np.isfinite(engine.query(ids, policy="fresh")).all()
