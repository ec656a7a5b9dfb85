"""Quickstart: FedAIS vs FedAll on a synthetic Pubmed-like graph (port of
``examples/quickstart.py``).

Runs the paper's Algorithm 1 end to end and prints the accuracy /
communication trade-off the paper is about. The defaults are the
reference's (Pubmed at 1/32 scale, 16 clients, 5 a round, 10 rounds, the
``gather`` aggregation); ``--backend spmm`` trains and evaluates through
the block-sparse SpMM kernel.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
        [--rounds 10] [--scale 32] [--backend gather|segment|spmm]
"""
from __future__ import annotations

import argparse

from repro_torch.api import FedEngine, method_config
from repro_torch.federated.partition import partition_graph
from repro_torch.graph.data import make_dataset
from repro_torch.models.gcn import AGG_BACKENDS

METHODS = ("fedais", "fedall")
CLIENTS, COHORT, SEED = 16, 5, 0    # the reference's: 16 clients, 5 a round


def build_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0; 'cpu' runs the plain versions)")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--scale", type=int, default=32, help="Pubmed downscale factor")
    ap.add_argument("--backend", default="gather", choices=AGG_BACKENDS,
                    help="neighbour aggregation in training and eval")
    return ap.parse_args(argv)


def method_of(name: str):
    """The reference's method configurations: FedAIS syncs every 4
    iterations to start with, FedAll every iteration."""
    return method_config(name, tau0=4 if name == "fedais" else 1)


def run(args: argparse.Namespace, *, init_state=None) -> dict:
    """Train each of ``METHODS``; returns ``{method: RunResult}``.
    ``init_state(engine)``, if given, builds the engine's starting state
    (the tests start from the reference's params and draws)."""
    graph = make_dataset("pubmed", scale=args.scale, seed=SEED)
    print(f"graph: {graph.n_nodes} nodes, {len(graph.edges)} edges, "
          f"{graph.n_classes} classes")
    fed = partition_graph(graph, n_clients=CLIENTS, alpha=0.5, seed=SEED)
    print(f"partition: {fed.n_clients} clients, n_max={fed.n_max}, "
          f"cross-client edges={fed.n_cross_edges}")
    results = {}
    for method in METHODS:
        eng = FedEngine(graph, fed, method_of(method), rounds=args.rounds,
                        clients_per_round=COHORT, seed=SEED, verbose=False,
                        train_backend=args.backend, eval_backend=args.backend,
                        device=args.device)
        state = init_state(eng) if init_state is not None else eng.init_state()
        res = results[method] = eng.run(state)
        f = res.final
        print(f"{method:8s} acc={f['acc']*100:5.1f}%  f1={f['f1']*100:5.1f}%  "
              f"comm={f['comm_total_bytes']/1e6:7.1f} MB "
              f"(embeddings {f['comm_embed_bytes']/1e6:6.1f} MB)  "
              f"est. wall-clock={f['wall_clock_s']:.1f}s")
    print("\nFedAIS should match or beat FedAll's accuracy at a fraction of "
          "the embedding-synchronization traffic (paper Fig. 3/4).")
    return results


def main(argv=None) -> int:
    run(build_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
