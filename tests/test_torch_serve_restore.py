"""The port's deployment path against the reference's, on the CPU.

A federation trained by the port (``small_fed``: pubmed scale 32, 8
clients; fedais 2 rounds, spmm backends) is saved by the port's
``save_federation`` and restored by both ``ServedModel.restore``s:

* historical and fresh logits agree at 1e-4 (three dense products summed
  in another order, as ``test_torch_serve.py``), for ``warm="refresh"``
  and ``"tables"``, and ``table_age`` is exact. Fresh queries keep off row
  0's neighbourhood: the reference's padded scatter can write a stale row 0
  (ROADMAP C3);
* on the port, the two-call pipeline (``fused=False``) gives the fused
  path's logits bit for bit under gather, segment and spmm, under both
  policies, and writes the same cache on a refresh;
* a warmup prepares 3 bodies a bucket fused and 5 two-call, the
  reference's trace counts, and serving prepares nothing more; a capacity
  growth prepares every body again;
* ``validate_bench_serve`` agrees with the reference's on a good payload
  and on each broken one.
"""
import copy

import numpy as np
import pytest

from repro.serve import QueryEngine as JEngine
from repro.serve import ServedModel as JModel
from repro.serve import validate_bench_serve as jvalidate
from repro_torch.api import FedEngine, method_config
from repro_torch.federated.partition import partition_graph
from repro_torch.graph.data import make_dataset
from repro_torch.serve import (
    LoadGenerator,
    QueryEngine,
    ServedModel,
    save_federation,
    validate_bench_serve,
)
from test_torch_async import one_torch_thread  # noqa: F401  (autouse fixture)

TOL = 1e-4
ROUNDS = 2
BUCKETS = (8, 32)


@pytest.fixture(scope="module")
def trained(tmp_path_factory, small_fed):
    g = make_dataset("pubmed", scale=32, seed=0)
    fed = partition_graph(g, 8, alpha=0.5, seed=0)
    eng = FedEngine(g, fed, method_config("fedais", tau0=2), rounds=ROUNDS,
                    clients_per_round=2, seed=0, eval_every=ROUNDS, train_backend="spmm",
                    eval_backend="spmm", device="cpu")
    state = eng.init_state()
    eng.run(state)
    d = str(tmp_path_factory.mktemp("fed_ckpt"))
    save_federation(d, ROUNDS, state)
    jg, jfed = small_fed
    return g, fed, jg, jfed, d


def _restore(trained, backend="spmm", warm="refresh", **kw):
    g, fed, _, _, d = trained
    model = ServedModel.restore(d, g, fed, backend=backend, warm=warm, seed=0, device="cpu")
    return model, QueryEngine(model, buckets=BUCKETS, **kw)


def _away_from_row_zero(store, n, size, seed):
    """``size`` query ids whose rows and neighbours are all >= 1."""
    nbr0 = set(store.nbr_idx[0][store.nbr_mask[0] > 0].tolist()) | {0}
    ok = [i for i in range(1, n)
          if not ({i} | set(store.nbr_idx[i][store.nbr_mask[i] > 0].tolist())) & nbr0]
    return np.random.default_rng(seed).choice(ok, size=size, replace=False)


@pytest.mark.parametrize("warm", ["refresh", "tables"])
def test_port_checkpoint_serves_like_the_reference_restore(trained, warm):
    _, _, jg, jfed, d = trained
    model, engine = _restore(trained, warm=warm)
    jmodel = JModel.restore(d, jg, jfed, backend="segment", warm=warm, seed=0)
    jengine = JEngine(jmodel, buckets=BUCKETS)
    assert model.restored_step == jmodel.restored_step == ROUNDS
    assert model.table_age.dtype == jmodel.table_age.dtype
    assert np.array_equal(model.table_age, jmodel.table_age)
    n = model.n_active
    hist = np.concatenate([engine.query(np.arange(i, min(i + 32, n)), policy="historical")
                           for i in range(0, n, 32)])
    jhist = np.concatenate([jengine.query(np.arange(i, min(i + 32, n)), policy="historical")
                            for i in range(0, n, 32)])
    np.testing.assert_allclose(hist, jhist, atol=TOL, rtol=TOL)
    q = _away_from_row_zero(model.store, n, 24, seed=1)
    np.testing.assert_allclose(engine.query(q, policy="fresh"),
                               jengine.query(q, policy="fresh"), atol=TOL, rtol=TOL)
    s, js = model.summary(), jmodel.summary()
    assert s.keys() == js.keys()
    for k in ("n_active", "capacity", "restored_step", "warm", "table_age_mean",
              "table_age_max", "cache_resident_bytes"):
        assert s[k] == js[k], k


def test_restore_takes_the_newest_loadable_step(trained, tmp_path):
    g, fed, _, _, d = trained
    import shutil

    from repro_torch.faults import tear_file

    shutil.copy(f"{d}/step_{ROUNDS:08d}.msgpack", tmp_path / f"step_{1:08d}.msgpack")
    shutil.copy(f"{d}/step_{ROUNDS:08d}.msgpack", tmp_path / f"step_{5:08d}.msgpack")
    assert ServedModel.restore(str(tmp_path), g, fed, device="cpu").restored_step == 5
    tear_file(str(tmp_path / f"step_{5:08d}.msgpack"))
    assert ServedModel.restore(str(tmp_path), g, fed, device="cpu").restored_step == 1
    assert ServedModel.restore(str(tmp_path), g, fed, step=1, device="cpu").restored_step == 1


@pytest.mark.parametrize("backend", ["gather", "segment", "spmm"])
def test_twocall_pipeline_is_the_fused_path_bit_for_bit(trained, backend):
    model, fused = _restore(trained, backend=backend)
    two = QueryEngine(model, buckets=BUCKETS, fused=False)
    fused.warmup()
    two.warmup()
    rng = np.random.default_rng(7)
    n = model.n_active
    for size in (1, 8, 33, 64):
        ids = rng.integers(0, n, size=size)
        for policy in ("historical", "fresh"):
            assert np.array_equal(fused.query(ids, policy=policy),
                                  two.query(ids, policy=policy)), f"{policy}/{size}"
    # a refresh writes the same cache either way, from the same snapshot,
    # after edge inserts changed the rows' neighbourhoods
    snap = model.h1.clone()
    rows = fused.add_edges(rng.integers(1, n, (20, 2)))
    assert fused.refresh() == len(rows)
    want = model.h1.clone()
    model.h1.copy_(snap)
    model.invalidate(rows)
    assert two.refresh() == len(rows)
    assert bool((model.h1 == want).all()) and not bool((want == snap).all())
    for policy in ("historical", "fresh"):
        ids = rng.integers(0, n, size=20)
        assert np.array_equal(fused.query(ids, policy=policy), two.query(ids, policy=policy))
    assert fused.trace_count == fused.trace_count_after_warmup
    assert two.trace_count == two.trace_count_after_warmup


def test_prepared_bodies_are_the_reference_trace_counts(trained):
    _, _, jg, jfed, d = trained
    model, fused = _restore(trained, backend="segment")
    two = QueryEngine(model, buckets=BUCKETS, fused=False)
    fused.warmup()
    two.warmup()
    jmodel = JModel.restore(d, jg, jfed, backend="segment", seed=0)
    jfused, jtwo = JEngine(jmodel, buckets=(8,)), JEngine(jmodel, buckets=(8,), fused=False)
    jfused.warmup()
    jtwo.warmup()
    # per bucket: the reference's own counts (tests/test_serve.py pins 3 and 5)
    assert fused.trace_count_after_warmup == jfused.trace_count_after_warmup * len(BUCKETS)
    assert two.trace_count_after_warmup == jtwo.trace_count_after_warmup * len(BUCKETS)
    assert (fused.trace_count_after_warmup, two.trace_count_after_warmup) == (6, 10)
    gen = LoadGenerator(fused, seed=3, n_queries=40, n_updates=6, mode="closed",
                        concurrency=4, policy_mix={"historical": 0.5, "fresh": 0.5})
    gen.run()
    for size in (1, 8, 9, 32, 70):
        two.query(np.arange(size), policy="fresh")
    assert fused.trace_count == fused.trace_count_after_warmup
    assert two.trace_count == two.trace_count_after_warmup


def test_capacity_growth_prepares_every_body_again(trained):
    g, fed, _, _, d = trained
    model = ServedModel.restore(d, g, fed, backend="gather", capacity=g.n_nodes + 1, seed=0,
                                device="cpu")
    engine = QueryEngine(model, buckets=BUCKETS)
    engine.warmup()
    before, gen = engine.trace_count, model.generation
    engine.add_nodes(np.ones((3, g.n_features), np.float32), [(g.n_nodes, 0)])
    assert model.generation == gen + 1 and model.h1.shape[0] == model.store.capacity
    assert engine.trace_count == before + 3 * len(BUCKETS) == engine.trace_count_after_warmup
    engine.query(np.arange(10), policy="fresh")
    assert engine.refresh() > 0 and engine.trace_count == engine.trace_count_after_warmup


def _good_payload(trained):
    model, engine = _restore(trained, backend="gather")
    engine.warmup()
    gen = LoadGenerator(engine, seed=0, n_queries=30, n_updates=3, mode="closed",
                        concurrency=4, policy_mix={"historical": 0.9, "fresh": 0.1})
    ledger = gen.run()
    return ledger.summary(
        backend="gather", devices=1, quick=True, mode="closed", policy_mix=gen.policy_mix,
        model_summary=model.summary(),
        cache={"cache_dtype": "fp32", "resident_bytes": model.cache_resident_bytes(),
               "serve_accuracy": 0.5},
        fused={"bucket": 8, "p50_ms": 0.4, "twocall_p50_ms": 0.9, "speedup": 2.25,
               "recompiles_after_warmup": 0})


BROKEN = {
    "not_a_dict": lambda p: [p],
    "missing_bench": lambda p: {k: v for k, v in p.items() if k != "bench"},
    "missing_buckets": lambda p: {k: v for k, v in p.items() if k != "buckets"},
    "bench": lambda p: {**p, "bench": "fault_tolerance"},
    "devices": lambda p: {**p, "devices": 0},
    "quick": lambda p: {**p, "quick": 1},
    "mode": lambda p: {**p, "mode": "diagonal"},
    "policy_mix": lambda p: {**p, "policy_mix": {"psychic": 1.0}},
    "n_queries": lambda p: {**p, "n_queries": 0},
    "p99_below_p50": lambda p: {**p, "p99_ms": p["p50_ms"] / 2},
    "occupancy": lambda p: {**p, "batch_occupancy": 1.5},
    "hit_rate": lambda p: {**p, "cache_hit_rate": -0.1},
    "rows_refreshed": lambda p: {**p, "rows_refreshed": -1},
    "buckets_empty": lambda p: {**p, "buckets": []},
    "bucket_keys": lambda p: {**p, "buckets": [{"bucket": 8}]},
    "bucket_count": lambda p: {**p, "n_queries": p["n_queries"] + 1},
    "cache_keys": lambda p: {**p, "cache": {"cache_dtype": "fp32"}},
    "cache_dtype": lambda p: {**p, "cache": {**p["cache"], "cache_dtype": "fp8"}},
    "cache_accuracy": lambda p: {**p, "cache": {**p["cache"], "serve_accuracy": 2.0}},
    "fused_keys": lambda p: {**p, "fused": {"bucket": 8}},
    "fused_speedup": lambda p: {**p, "fused": {**p["fused"], "speedup": 0.0}},
    "fused_recompiles": lambda p: {**p, "fused": {**p["fused"],
                                                  "recompiles_after_warmup": -1}},
}


def test_validate_bench_serve_agrees_with_the_reference(trained):
    good = _good_payload(trained)
    assert validate_bench_serve(good) == jvalidate(good) == []
    for name, broken in BROKEN.items():
        bad = broken(copy.deepcopy(good))
        got = validate_bench_serve(bad)
        assert got == jvalidate(bad), name
        assert got, name
