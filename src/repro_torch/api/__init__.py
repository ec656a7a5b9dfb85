"""repro_torch.api — the federated training surface of the port.

Port of ``repro/api``: ``FedEngine(graph, fed, "fedais", ...).run()`` with
the stepwise executor on one device::

    from repro_torch.api import FedEngine

    res = FedEngine(graph, fed, "fedais", rounds=10, clients_per_round=5,
                    train_backend="spmm", eval_backend="spmm").run()

``device=None`` is ``cuda:0``; the CPU tests pass ``device="cpu"``.
"""
from repro_torch.api.callbacks import (
    BaseCallback,
    EarlyStopCallback,
    EvalCallback,
    HistoryCallback,
    RoundContext,
    VerboseCallback,
    default_callbacks,
)
from repro_torch.api.engine import EngineState, FedEngine, RunResult
from repro_torch.api.protocols import (
    AdaptiveSyncController,
    FedAvg,
    FixedSyncController,
    PaperCostModel,
    SyncScheduler,
    UniformSelector,
    WeightedFedAvg,
)
from repro_torch.api.registry import (
    available_aggregators,
    available_methods,
    available_schedulers,
    build_aggregator,
    build_scheduler,
    build_strategy,
    method_config,
    register_aggregator,
    register_method,
    register_scheduler,
    unregister_method,
)
from repro_torch.api.strategies import (
    MethodStrategy,
    register_strategy_kind,
    strategy_kind_for,
)

__all__ = [
    "AdaptiveSyncController", "BaseCallback", "EarlyStopCallback", "EngineState",
    "EvalCallback", "FedAvg", "FedEngine", "FixedSyncController", "HistoryCallback",
    "MethodStrategy", "PaperCostModel", "RoundContext", "RunResult", "SyncScheduler",
    "UniformSelector", "VerboseCallback", "WeightedFedAvg", "available_aggregators",
    "available_methods", "available_schedulers", "build_aggregator", "build_scheduler",
    "build_strategy", "default_callbacks", "method_config", "register_aggregator",
    "register_method", "register_scheduler", "register_strategy_kind",
    "strategy_kind_for", "unregister_method",
]
