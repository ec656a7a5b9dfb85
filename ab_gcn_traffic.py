"""One checkout's GCN serving traffic on the card, for comparing two trees.

    python3 ab_gcn_traffic.py ROOT TAG [RUNS]

runs, from the checkout at ROOT (this one: ``.``; another: unpack it with
``git archive`` into a directory ``.gitignore`` lists), ``chip_smoke.py``'s
phases 4 and 5 with that tree's modules: the pubmed configuration (19,717
nodes, 500 features, max degree 32), ``ServedModel`` (spmm, warm refresh)
→ ``QueryEngine`` (warmup) → ``LoadGenerator`` (closed loop, 8 clients, 200
queries and 20 updates, 90/10 historical/fresh, seed 0), RUNS times (5 by
default) on one engine, and prints one line ``AB {json}``: each run's p50,
p99 and queries/s. The traffic is host-bound, so its numbers move with the
host: compare two trees only within one call, in turns (A, B, B, A), each
in its own process:

    for t in A B B A; do python3 ab_gcn_traffic.py <root of $t> $t; done

Needs one card; builds that tree's SpMM kernel at first use.
"""
import json
import os
import sys


def main(argv) -> int:
    root, tag = os.path.abspath(argv[1]), argv[2]
    runs = int(argv[3]) if len(argv) > 3 else 5
    sys.path[:0] = [os.path.join(root, "src")]
    os.chdir(root)
    import numpy as np
    import torch

    from repro_torch.graph.csr import build_padded_neighbors
    from repro_torch.graph.data import make_dataset
    from repro_torch.kernels import build
    from repro_torch.models.gcn import gcn_init
    from repro_torch.serve import GraphStore, LoadGenerator, QueryEngine, ServedModel

    if not torch.cuda.is_available():
        print("ab_gcn_traffic: no CUDA device", file=sys.stderr)
        return 1
    build.build(["spmm"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = make_dataset("pubmed", scale=1, max_features=500, seed=0)
    idx, mask = build_padded_neighbors(g.adjacency_lists(), 32, seed=0)
    store = GraphStore(g.features, idx, mask)
    params = gcn_init(torch.Generator().manual_seed(0), g.n_features, g.n_classes, device=dev)
    model = ServedModel(params, store, backend="spmm", warm="refresh", device=dev)
    engine = QueryEngine(model, fallback=False)
    engine.warmup()
    ids = np.sort(np.random.default_rng(0).choice(g.n_nodes, size=256, replace=False))
    for i in range(0, 256, 128):
        engine.query(ids[i: i + 128], policy="historical")
    out = []
    for r in range(runs):
        load = LoadGenerator(engine, seed=r, n_queries=200, n_updates=20, mode="closed",
                             concurrency=8, policy_mix={"historical": 0.9, "fresh": 0.1})
        summ = load.run().summary(backend="spmm", devices=1, quick=False, mode="closed",
                                  policy_mix=load.policy_mix,
                                  degraded=engine.degraded_snapshot())
        torch.cuda.synchronize()
        out.append({k: summ[k] for k in ("p50_ms", "p99_ms", "queries_per_s")})
    print("AB " + json.dumps({"tag": tag, "root": root, "runs": out,
                              "fallbacks": engine.n_fallbacks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
