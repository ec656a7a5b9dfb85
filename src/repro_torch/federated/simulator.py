"""Federated training simulator — the legacy entry point.

Port of ``repro/federated/simulator.py``: ``run_federated`` builds a
default-configured ``FedEngine`` and runs it. Prefer the engine::

    from repro_torch.api import FedEngine
    res = FedEngine(graph, fed, "fedais", rounds=30).run()
"""
from __future__ import annotations

from repro_torch.api.engine import FedEngine, RunResult  # noqa: F401  (re-export)
from repro_torch.core.fedais import MethodConfig
from repro_torch.federated.costs import DelayModel
from repro_torch.federated.partition import FederatedGraph
from repro_torch.graph.data import GraphData


def run_federated(
    graph: GraphData,
    fed: FederatedGraph,
    mcfg: MethodConfig,
    *,
    rounds: int = 30,
    clients_per_round: int = 10,
    seed: int = 0,
    target_acc: float | None = None,
    delay: DelayModel = DelayModel(),
    eval_every: int = 1,
    verbose: bool = False,
    device=None,
) -> RunResult:
    """Build a default-configured FedEngine and run it (``device=None`` is
    ``cuda:0``)."""
    return FedEngine(
        graph, fed, mcfg,
        rounds=rounds, clients_per_round=clients_per_round, seed=seed,
        target_acc=target_acc, delay=delay, eval_every=eval_every,
        verbose=verbose, device=device,
    ).run()
