"""End-to-end federated serving pipeline: train -> checkpoint -> serve.

Port of ``repro/launch/serve_fed.py``. Trains a federation with the
``FedEngine``, checkpoints it with ``save_federation`` (the reference's
msgpack format), restores it into a :class:`ServedModel` and a warmed
:class:`QueryEngine`, then drives synthetic traffic (queries and live graph
updates) through the :class:`LoadGenerator` and writes the schema-checked
latency ledger (``--out``, by default ``BENCH_serve_torch.json`` at the
repo root; the reference's ``BENCH_serve.json`` is its own)::

    PYTHONPATH=src python -m repro_torch.launch.serve_fed --quick --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_fed --quick --backend spmm

The device is ``cuda:0`` unless ``--device`` names another. On the card the
fused serve path replays a CUDA graph per (body, bucket).

``--parity-check`` asserts that the served "historical" logits over every
node are bit-identical to the port's eval path before any traffic runs.
``--cache-dtype {fp32,bf16,int8}`` keeps the h1 cache resident in that wire
format; the ledger's ``cache`` column records its resident bytes and the
test accuracy of the served logits. ``--parity-check`` is fp32 only.

Before traffic the pipeline times the fused path against the two-call
pipeline (``fused=False``) on the same warm model: bit parity first, then
fused p50 <= two-call p50 and nothing prepared after warmup (the ledger's
``fused`` column).

``--max-features`` (the dataset's feature width, 128 by default as the
reference's ``make_dataset``) and ``--train-backend`` (the training and
eval aggregation backend, ``gather`` by default as the reference's engine)
let a run use the paper's widths and the SpMM kernel in training too.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


def build_args(argv=None) -> argparse.Namespace:
    from repro_torch.federated.quant import SYNC_DTYPES
    from repro_torch.serve import CACHE_POLICIES, LOAD_MODES, SERVE_BACKENDS

    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--quick", action="store_true",
                    help="tiny federation + 200 queries / 20 updates")
    ap.add_argument("--dataset", default="pubmed")
    ap.add_argument("--scale", type=int, default=None,
                    help="synthetic dataset scale (default: 64 quick, 8 full)")
    ap.add_argument("--max-features", type=int, default=128,
                    help="feature width cap of the synthetic dataset")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=None,
                    help="training rounds (default: 3 quick, 30 full)")
    ap.add_argument("--cohort", type=int, default=4)
    ap.add_argument("--method", default="fedais")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="segment", choices=SERVE_BACKENDS)
    ap.add_argument("--train-backend", default="gather", choices=SERVE_BACKENDS,
                    help="aggregation backend of training and its eval")
    ap.add_argument("--warm", default="refresh", choices=("refresh", "tables"))
    ap.add_argument("--policy", default="historical", choices=CACHE_POLICIES,
                    help="dominant cache policy in the traffic mix")
    ap.add_argument("--mode", default="open", choices=LOAD_MODES)
    ap.add_argument("--rate", type=float, default=500.0,
                    help="open-loop Poisson arrival rate (req/s)")
    ap.add_argument("--concurrency", type=int, default=8,
                    help="closed-loop client count")
    ap.add_argument("--queries", type=int, default=None,
                    help="query count (default: 200 quick, 2000 full)")
    ap.add_argument("--updates", type=int, default=None,
                    help="streaming update count (default: 20 quick, 200 full)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temp dir)")
    ap.add_argument("--out", default=os.path.join(REPO_ROOT, "BENCH_serve_torch.json"))
    ap.add_argument("--cache-dtype", default="fp32", choices=list(SYNC_DTYPES),
                    help="resident wire format of the h1 embedding cache")
    ap.add_argument("--parity-check", action="store_true",
                    help="assert served historical logits == eval logits bit for "
                         "bit before running traffic (fp32 cache only)")
    ap.add_argument("--device", default="cuda:0",
                    help="torch device of training and serving (cuda:0 or cpu)")
    args = ap.parse_args(argv)
    if args.parity_check and args.cache_dtype != "fp32":
        ap.error("--parity-check demands bit-identical logits; a "
                 f"{args.cache_dtype} cache is lossy by design (the "
                 "accuracy column of the ledger tracks its effect)")
    args.scale = args.scale if args.scale is not None else (64 if args.quick else 8)
    args.rounds = args.rounds if args.rounds is not None else (3 if args.quick else 30)
    args.queries = args.queries if args.queries is not None else (200 if args.quick else 2000)
    args.updates = args.updates if args.updates is not None else (20 if args.quick else 200)
    return args


def train_and_checkpoint(args, ckpt_dir: str):
    """Run the federation and save the serving checkpoint. Returns
    ``(graph, fed, state)``. If ``ckpt_dir`` already holds a checkpoint and
    no parity check is asked for, training is skipped and the checkpoint
    reused (``state`` None)."""
    from repro_torch.api import FedEngine, method_config
    from repro_torch.checkpoint import latest_step
    from repro_torch.federated.partition import partition_graph
    from repro_torch.graph.data import make_dataset
    from repro_torch.serve import save_federation

    g = make_dataset(args.dataset, scale=args.scale, max_features=args.max_features,
                     seed=args.seed)
    fed = partition_graph(g, args.clients, alpha=0.5, seed=args.seed)
    have = latest_step(ckpt_dir)
    if have is not None and not args.parity_check:
        print(f"# reusing checkpoint step {have} in {ckpt_dir}")
        return g, fed, None
    mcfg = method_config(args.method, tau0=2)
    engine = FedEngine(g, fed, mcfg, rounds=args.rounds, clients_per_round=args.cohort,
                       seed=args.seed, eval_every=args.rounds,
                       train_backend=args.train_backend, eval_backend=args.train_backend,
                       device=args.device)
    state = engine.init_state()
    result = engine.run(state)
    path = save_federation(ckpt_dir, args.rounds, state)
    print(f"# trained {args.method} {args.rounds} rounds on {args.dataset} "
          f"scale={args.scale} K={args.clients} ({engine.last_executor}): "
          f"test_acc={result.final.get('acc', float('nan')):.3f}")
    print(f"# checkpoint: {path}")
    return g, fed, state


def _serve_all(engine, n: int) -> np.ndarray:
    """Historical logits of nodes [0, n) through the warmed buckets."""
    return np.concatenate([engine.query(np.arange(i, min(i + 128, n)), policy="historical")
                           for i in range(0, n, 128)])


def parity_check(model, engine, graph, fed, state, seed: int) -> None:
    """Served historical logits must be bit-identical to the port's
    full-graph eval path (``build_eval_graph`` -> ``eval_logits``)."""
    from repro_torch.federated.server import build_eval_graph, eval_logits

    eg = build_eval_graph(graph, max_deg=fed.max_deg, seed=seed, backend=model.backend,
                          device=model.device)
    want = eval_logits(state.params, eg).cpu().numpy()
    got = _serve_all(engine, graph.features.shape[0])
    if not np.array_equal(got, want):
        raise AssertionError("served historical logits are not bit-identical to the "
                             f"eval path (max abs diff {float(np.abs(got - want).max())})")
    print(f"# parity-check: {len(got)} nodes bit-identical to build_eval_graph")


def serve_accuracy(engine, graph) -> float:
    """Test-split accuracy of the served historical logits (the accuracy
    half of the cache column), through the warmed buckets, so a quantized
    cache pays its dequantization and rounding as traffic does."""
    logits = _serve_all(engine, graph.features.shape[0])
    mask = np.asarray(graph.test_mask, bool)
    pred = logits.argmax(-1)
    return float((pred[mask] == np.asarray(graph.labels)[mask]).mean())


def fused_ab(engine, graph, seed: int, reps: int = 200) -> dict:
    """Time the fused bucket path against the two-call pipeline on the same
    warm model (smallest bucket, historical policy, interleaved reps).
    Asserts bit parity first, then gates fused p50 <= two-call p50 with
    nothing prepared after warmup — the ``fused`` ledger column."""
    from repro_torch.serve import QueryEngine

    twin = QueryEngine(engine.model, cache_policy="historical", fused=False)
    b = engine.buckets[0]
    n = graph.features.shape[0]
    rng = np.random.default_rng((seed, 0xAB))
    ids = rng.integers(0, n, size=b).astype(np.int64)
    want = engine.query(ids, policy="historical")
    got = twin.query(ids, policy="historical")
    if not np.array_equal(got, want):
        raise AssertionError("two-call logits diverge from the fused bucket path")
    fused_ts, two_ts = [], []
    for _ in range(reps):
        qs = rng.integers(0, n, size=b).astype(np.int64)
        t0 = time.perf_counter()
        engine.query(qs, policy="historical")
        fused_ts.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        twin.query(qs, policy="historical")
        two_ts.append(time.perf_counter() - t0)
    p50 = float(np.median(fused_ts) * 1e3)
    two_p50 = float(np.median(two_ts) * 1e3)
    recompiles = engine.trace_count - engine.trace_count_after_warmup
    col = {"bucket": int(b), "p50_ms": p50, "twocall_p50_ms": two_p50,
           "speedup": two_p50 / p50, "recompiles_after_warmup": recompiles}
    print(f"# fused A/B (bucket {b}, {reps} reps): fused p50={p50:.3f}ms vs "
          f"two-call p50={two_p50:.3f}ms ({col['speedup']:.2f}x)")
    if recompiles:
        raise SystemExit(f"fused A/B prepared {recompiles} serve shape(s) after warmup")
    if p50 > two_p50:
        raise SystemExit(f"fused bucket path regressed: p50 {p50:.3f}ms > "
                         f"two-call {two_p50:.3f}ms")
    return col


def serve_pipeline(args) -> tuple[dict, dict]:
    """The train -> checkpoint -> restore -> serve pipeline. Returns the
    validated payload (also written to ``args.out``) and the run's objects
    (``graph``, ``fed``, ``state``, ``model``, ``engine``, ``ckpt_dir``,
    and ``traffic``: the SpMM launches and graph replays of the traffic)."""
    from repro_torch.kernels.spmm.ops import block_spmm
    from repro_torch.serve import LoadGenerator, QueryEngine, ServedModel, validate_bench_serve

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="serve_fed_ckpt_")
    g, fed, state = train_and_checkpoint(args, ckpt_dir)

    model = ServedModel.restore(ckpt_dir, g, fed, backend=args.backend, warm=args.warm,
                                seed=args.seed, cache_dtype=args.cache_dtype,
                                device=args.device)
    engine = QueryEngine(model, cache_policy=args.policy)
    engine.warmup()
    print(f"# restored step {model.restored_step}; warmup prepared "
          f"{engine.trace_count_after_warmup} serve bodies over buckets {engine.buckets} "
          f"({engine.graph_count} CUDA graphs)")

    if args.parity_check:
        parity_check(model, engine, g, fed, state, args.seed)
        if engine.trace_count != engine.trace_count_after_warmup:
            raise AssertionError("parity check prepared a serve shape")

    # the accuracy half of the cache column, on the warm cache before
    # traffic mutates the graph
    acc = serve_accuracy(engine, g)
    cache_col = {"cache_dtype": model.cache_dtype,
                 "resident_bytes": model.cache_resident_bytes(), "serve_accuracy": acc}
    print(f"# cache: {model.cache_dtype} {cache_col['resident_bytes']:,}B resident, "
          f"test accuracy {acc:.4f}")
    if engine.trace_count != engine.trace_count_after_warmup:
        raise AssertionError("accuracy sweep prepared a serve shape")

    fused_col = fused_ab(engine, g, args.seed)

    mix = ({"historical": 0.9, "fresh": 0.1} if args.policy == "historical"
           else {"fresh": 0.9, "historical": 0.1})
    gen = LoadGenerator(engine, seed=args.seed, n_queries=args.queries,
                        n_updates=args.updates, mode=args.mode, rate=args.rate,
                        concurrency=args.concurrency, policy_mix=mix)
    launches, replays = block_spmm.launches, dict(engine.replays)
    ledger = gen.run()
    traffic = {"spmm_launches": block_spmm.launches - launches,
               "replays": {k: v - replays.get(k, 0) for k, v in engine.replays.items()}}

    retraced = engine.trace_count - engine.trace_count_after_warmup
    if retraced:
        raise AssertionError(f"{retraced} serve shapes prepared after warmup")

    payload = ledger.summary(backend=args.backend, devices=1, quick=bool(args.quick),
                             mode=args.mode, policy_mix=mix, model_summary=model.summary(),
                             cache=cache_col, fused=fused_col)
    problems = validate_bench_serve(payload)
    if problems:
        raise SystemExit("refusing to write an invalid serve ledger:\n  "
                         + "\n  ".join(problems))
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    print(f"# wrote {args.out}")
    print(f"# {payload['n_queries']} queries / {payload['n_updates']} updates "
          f"({args.mode}-loop): {payload['queries_per_s']:.1f} q/s, "
          f"p50={payload['p50_ms']:.2f}ms p99={payload['p99_ms']:.2f}ms, "
          f"occupancy={payload['batch_occupancy']:.2f}, "
          f"hit_rate={payload['cache_hit_rate']:.3f}")
    return payload, {"graph": g, "fed": fed, "state": state, "model": model,
                     "engine": engine, "ckpt_dir": ckpt_dir, "traffic": traffic}


def run_pipeline(args) -> dict:
    """The full pipeline; returns the validated payload (and writes it)."""
    return serve_pipeline(args)[0]


def main(argv=None) -> int:
    run_pipeline(build_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
