"""repro_torch.api — the federated training surface of the port.

Port of ``repro/api``: ``FedEngine(graph, fed, "fedais", ...).run()`` on one
device, through the fused executor (a CUDA graph per round key on the
card) where every component is fusable, else the stepwise one; with a
``mesh`` (``repro_torch.sharding``) on every rank of it, client-sharded or
pod-sharded::

    from repro_torch.api import FedEngine

    res = FedEngine(graph, fed, "fedais", rounds=10, clients_per_round=5,
                    train_backend="spmm", eval_backend="spmm").run()

``device=None`` is ``cuda:0``; the CPU tests pass ``device="cpu"``. Every
registered method runs (``available_methods()``), under either scheduler
(``scheduler="async"`` or ``AsyncScheduler(...)``), any aggregator, and any
wire dtype (``sync_dtype="fp32" | "bf16" | "int8"``), with or without a
``faults=FaultPlan(...)`` and its ``guard`` (``repro_torch.faults``).

Extension points: the registries (``register_method``,
``register_strategy_kind``, ``register_aggregator``,
``register_scheduler``), and components injected into the engine that
satisfy the protocols ``ClientSelector``, ``Aggregator``,
``SyncController``, ``CostModel``, ``RoundScheduler`` and
``RoundCallback``.
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
    Aggregator,
    AsyncScheduler,
    ClientSelector,
    CostModel,
    FedAvg,
    FixedSyncController,
    LossBiasedSelector,
    PaperCostModel,
    RoundCallback,
    RoundScheduler,
    SizeBiasedSelector,
    StalenessWeightedAggregator,
    SyncController,
    SyncScheduler,
    UniformSelector,
    WeightedFedAvg,
    staleness_discount,
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
    BanditStrategy,
    GeneratorStrategy,
    MethodStrategy,
    register_strategy_kind,
    strategy_kind_for,
)

__all__ = [
    "AdaptiveSyncController", "Aggregator", "AsyncScheduler", "BanditStrategy",
    "BaseCallback", "ClientSelector", "CostModel", "EarlyStopCallback",
    "EngineState", "EvalCallback", "FedAvg", "FedEngine",
    "FixedSyncController", "GeneratorStrategy", "HistoryCallback",
    "LossBiasedSelector", "MethodStrategy", "PaperCostModel", "RoundCallback",
    "RoundContext", "RoundScheduler", "RunResult", "SizeBiasedSelector",
    "StalenessWeightedAggregator", "SyncController", "SyncScheduler",
    "UniformSelector", "VerboseCallback",
    "WeightedFedAvg", "available_aggregators", "available_methods", "available_schedulers",
    "build_aggregator", "build_scheduler", "build_strategy", "default_callbacks",
    "method_config", "register_aggregator", "register_method", "register_scheduler",
    "register_strategy_kind", "staleness_discount", "strategy_kind_for",
    "unregister_method",
]
