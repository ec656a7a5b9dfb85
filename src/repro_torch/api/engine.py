"""FedEngine: the federated training engine (Algorithm 1), stepwise.

Port of ``repro/api/engine.py`` (``RunResult``, ``EngineState``,
``FedEngine.__init__``, ``init_state``, ``dispatch``, ``merge``,
``run_round``, ``run``). A round is

    select clients -> strategy hooks -> cohort LocalUpdate -> aggregate
    -> historical write-back -> cost accounting -> callbacks

``dispatch`` runs the cohort's LocalUpdate (``core.fedais``) client by
client on the device; ``merge`` is the server half. The schedulers
(``api.protocols``) sequence the two: lockstep, or buffered-async with
staleness-discounted merges. The tables live on the engine's device
(``device=None`` is ``cuda:0``) and the merge writes the cohort's rows
into them in place: by then no client reads the round-start snapshot any
more, and the outputs an async scheduler still holds are tensors of their
own. The merge takes the reference's unguarded path, which its default
all-pass guard also takes on a healthy run. ``sync_dtype`` is the wire
format of the ghost pull and of the write-back (``federated.quant``).

Not ported yet, and refused when asked for: the fused executor
(``SyncScheduler(fused=True)``, ROADMAP A4), the update guard and fault
injection (``guard``, ``faults``: A6) and a device mesh (``mesh``: A7).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.api.callbacks import RoundContext, default_callbacks
from repro_torch.api.protocols import (
    AdaptiveSyncController,
    PaperCostModel,
    UniformSelector,
    to_host,
)
from repro_torch.api.registry import (
    build_aggregator,
    build_scheduler,
    build_strategy,
    method_config,
)
from repro_torch.core.fedais import (
    MethodConfig,
    TorchDraws,
    batch_size_for,
    make_cohort_update,
)
from repro_torch.core.historical import HistoricalState, init_historical
from repro_torch.device import resolve_device
from repro_torch.faults import FaultCounters
from repro_torch.federated.costs import CostMeter, DelayModel
from repro_torch.federated.partition import FederatedGraph
from repro_torch.federated.quant import check_sync_dtype, quant_roundtrip
from repro_torch.federated.server import build_eval_graph, evaluate_global
from repro_torch.graph.data import GraphData
from repro_torch.models.gcn import (
    AGG_BACKENDS,
    HIDDEN,
    gcn_flops_per_node,
    gcn_init,
    gcn_param_count,
)

_CLIENT_ARRAY_KEYS = (
    "features", "labels", "node_mask", "train_mask",
    "nbr_idx", "nbr_mask", "ghost_owner", "ghost_row", "ghost_mask",
)


@dataclass
class RunResult:
    method: str
    dataset: str
    history: dict = field(default_factory=dict)     # per-round lists
    final: dict = field(default_factory=dict)
    costs: CostMeter = field(default_factory=CostMeter)

    def record(self, **kv):
        for k, v in kv.items():
            self.history.setdefault(k, []).append(v)

    def rounds_to_acc(self, target: float) -> int | None:
        for i, a in enumerate(self.history.get("test_acc", [])):
            if a >= target:
                return i + 1
        return None

    def comm_to_acc(self, target: float) -> float | None:
        for a, c in zip(self.history.get("test_acc", []), self.history.get("comm_total", [])):
            if a >= target:
                return c
        return None


@dataclass
class EngineState:
    """Everything mutable across rounds; components read/write this.

    The reference keeps ``ghost_feat`` beside ``hist`` (whose own
    ``ghost_feat`` it never reads); here ``hist.ghost_feat`` is the one
    (K, g_max, F) table."""

    rng: np.random.Generator          # host RNG (client selection)
    draws: Any                        # device draw provider (core.fedais)
    params: dict                      # global model
    hist: HistoricalState             # ghost_feat / hist1 / age tables
    prev_loss: torch.Tensor           # (K, n_max) last-seen per-node loss
    arrays: dict                      # device-resident stacked client arrays
    result: RunResult
    tau: int = 1                      # current sync interval
    initial_loss: Optional[float] = None
    round: int = 0
    last_eval: Optional[tuple] = None  # (round, metrics) from EvalCallback
    # per-update staleness of the merge being post-processed (None on the
    # sync path); strategies read it to attribute async rewards
    last_staleness: Optional[np.ndarray] = None
    # what the engine/scheduler did about faults (async timeouts, ...)
    fault_events: FaultCounters = field(default_factory=FaultCounters)


class FedEngine:
    """Federated trainer over a partitioned graph, on one device.

    ``method`` is a registered method name (``api.registry``) or an
    explicit MethodConfig. Components can be overridden by keyword; the
    defaults reproduce the paper's Algorithm 1.
    """

    def __init__(
        self,
        graph: GraphData,
        fed: FederatedGraph,
        method: Union[str, MethodConfig],
        *,
        rounds: int = 30,
        clients_per_round: int = 10,
        seed: int = 0,
        target_acc: float | None = None,
        delay: DelayModel = DelayModel(),
        eval_every: int = 1,
        verbose: bool = False,
        selector=None,
        aggregator=None,
        sync=None,
        cost_model=None,
        strategy=None,
        scheduler=None,
        callbacks: Optional[Sequence] = None,
        eval_backend: str = "gather",
        train_backend: str = "gather",
        sync_dtype: str = "fp32",
        guard=None,
        faults=None,
        mesh=None,
        device=None,
    ):
        for name, value, item in (("guard", guard, "A6"), ("faults", faults, "A6"),
                                  ("mesh", mesh, "A7")):
            if value is not None and value is not False:
                raise NotImplementedError(f"FedEngine({name}=...) is not ported yet "
                                          f"(ROADMAP {item})")
        self.sync_dtype = check_sync_dtype(sync_dtype)
        if train_backend not in AGG_BACKENDS:
            raise ValueError(f"unknown train_backend {train_backend!r}; "
                             f"known: {AGG_BACKENDS}")
        self.device = resolve_device(device)
        self.graph, self.fed = graph, fed
        self.mcfg = method_config(method) if isinstance(method, str) else method
        self.rounds = rounds
        self.clients_per_round = clients_per_round
        self.seed = seed
        self.train_backend = train_backend

        # ---- pluggable components ----
        self.strategy = strategy if strategy is not None else build_strategy(self.mcfg)
        self.selector = selector if selector is not None else UniformSelector()
        if aggregator is None:
            aggregator = build_aggregator(self.mcfg.aggregator)
        elif isinstance(aggregator, str):
            aggregator = build_aggregator(aggregator)
        self.aggregator = aggregator
        self.sync = sync if sync is not None else AdaptiveSyncController()
        if cost_model is None:
            cost_model = PaperCostModel(delay)
        elif delay != DelayModel():
            raise ValueError("`delay` only configures the default PaperCostModel; "
                             "give your explicit cost_model its own delay instead")
        self.cost_model = cost_model
        if scheduler is None:
            scheduler = self.mcfg.scheduler
        if isinstance(scheduler, str):
            scheduler = build_scheduler(scheduler)
        self.scheduler = scheduler
        if callbacks is None:
            self.callbacks = default_callbacks(eval_every=eval_every, verbose=verbose,
                                               target_acc=target_acc)
        else:
            if eval_every != 1 or verbose or target_acc is not None:
                raise ValueError(
                    "eval_every/verbose/target_acc only configure the default "
                    "callback stack; with an explicit `callbacks` list, drop "
                    "them and add EvalCallback/VerboseCallback/"
                    "EarlyStopCallback to your list instead")
            self.callbacks = list(callbacks)
        self.last_executor: Optional[str] = None

        # ---- static geometry + the cohort LocalUpdate ----
        self.F, self.H1 = fed.n_features, HIDDEN[0]
        self.n_params = gcn_param_count(self.F, fed.n_classes)
        avg_deg = float(fed.nbr_mask.sum() / np.maximum(fed.node_mask.sum(), 1))
        self.fwd_flops_node = gcn_flops_per_node(self.F, fed.n_classes, avg_deg)
        self.bsz = batch_size_for(self.mcfg, fed.n_max)
        self._cohort = make_cohort_update(self.mcfg, fed.n_max, train_backend=train_backend,
                                          sync_dtype=self.sync_dtype)
        self.eval_graph = build_eval_graph(graph, max_deg=fed.max_deg, seed=seed,
                                           backend=eval_backend, device=self.device)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def init_state(self, params: dict | None = None, draws=None) -> EngineState:
        """Fresh tables on the device. ``params`` (a dict of tensors) replaces
        the seeded ``gcn_init`` draw, and ``draws`` the seeded
        ``TorchDraws`` (the tests pass the reference's initial params and a
        provider that replays its key chain)."""
        fed, seed, dev = self.fed, self.seed, self.device
        K, n_max, g_max, F = fed.n_clients, fed.n_max, fed.g_max, self.F
        if params is None:
            params = gcn_init(torch.Generator().manual_seed(seed + 1), F, fed.n_classes,
                              device=dev)
        state = EngineState(
            rng=np.random.default_rng(seed),
            draws=TorchDraws(seed, dev) if draws is None else draws,
            params={k: v.to(device=dev, dtype=torch.float32) for k, v in params.items()},
            hist=init_historical(K, n_max, g_max, F, self.H1, dev),
            prev_loss=torch.full((K, n_max), -1.0, dtype=torch.float32, device=dev),
            arrays={k: torch.from_numpy(np.asarray(getattr(fed, k))).to(dev)
                    for k in _CLIENT_ARRAY_KEYS},
            result=RunResult(method=self.mcfg.name, dataset=self.graph.name),
            tau=self.sync.initial(self.mcfg),
        )
        self.strategy.setup(self, state)
        return state

    def dispatch(self, state: EngineState, sel: np.ndarray, t: int):
        """Client half of round ``t``: one draw stream per client, the
        strategy hooks, and the cohort's LocalUpdate from the round-start
        tables. Returns the stacked outputs ``(params, hist1, age,
        ghost_feat, stats)``; nothing in ``state`` but the draws moves."""
        state.round = t
        streams = state.draws.clients(len(sel))
        fanouts = self.strategy.choose_fanouts(self, sel)
        self.strategy.pre_round(self, state, sel)
        rows = torch.as_tensor(np.asarray(sel), dtype=torch.long, device=self.device)
        hist = state.hist
        return self._cohort(
            state.params, {k: v[rows] for k, v in state.arrays.items()},
            state.arrays["features"], hist.hist1, hist.hist1[rows], hist.age[rows],
            hist.ghost_feat[rows], state.prev_loss[rows], state.tau, fanouts,
            t * self.mcfg.local_epochs, streams)

    def merge(self, state: EngineState, t: int, sel: np.ndarray, out, *,
              staleness: np.ndarray | None = None, aggregator=None,
              wall_clock_s: float | None = None,
              virtual_time: float | None = None) -> bool:
        """Server half of round ``t``: aggregation, the historical write-back
        (in place), cost accounting, strategy and callback hooks. The light
        stats reach the host here, once per merge. An async scheduler passes
        the per-update ``staleness``, its staleness-aware ``aggregator``, the
        virtual-clock ``wall_clock_s`` it waited (replacing the lockstep
        billing) and the clock's ``virtual_time``. Returns True if a
        callback requested stop."""
        state.round = t
        new_params_stack, new_hist1, new_age, new_ghost_feat, stats = out
        sel = np.asarray(sel)
        if len(sel) == 0:
            state.fault_events.n_empty_merges += 1
        else:
            agg = self.aggregator if aggregator is None else aggregator
            weights = torch.as_tensor(self.fed.client_sizes[sel], dtype=torch.float32,
                                      device=self.device)
            if staleness is None:
                state.params = agg.aggregate(new_params_stack, weights)
            else:
                state.params = agg.aggregate(new_params_stack, weights, staleness)
            # Only an async buffer can hold the same client twice: every
            # update aggregates, but only the last occurrence (the freshest:
            # ``sel`` arrives sorted by dispatch version) writes the client's
            # rows. The dedup comes before the write, since a scatter with
            # repeated rows leaves the winner undefined on CUDA; a cohort
            # without repeats keeps its rows as they are.
            loss_all = stats["loss_all"]
            wsel = sel
            if len(np.unique(sel)) != len(sel):
                _, last_rev = np.unique(sel[::-1], return_index=True)
                keep = np.sort(len(sel) - 1 - last_rev)
                wsel = sel[keep]
                k = torch.as_tensor(keep, dtype=torch.long, device=self.device)
                new_hist1, new_age = new_hist1[k], new_age[k]
                new_ghost_feat, loss_all = new_ghost_feat[k], loss_all[k]
            if self.sync_dtype != "fp32":
                # the write-back is a wire: float rows round-trip through
                # the codec; age stays exact
                new_hist1 = quant_roundtrip(new_hist1, self.sync_dtype)
                new_ghost_feat = quant_roundtrip(new_ghost_feat, self.sync_dtype)
                loss_all = quant_roundtrip(loss_all, self.sync_dtype)
            rows = torch.as_tensor(wsel, dtype=torch.long, device=self.device)
            state.hist.hist1[rows] = new_hist1
            state.hist.age[rows] = new_age
            state.hist.ghost_feat[rows] = new_ghost_feat
            state.prev_loss[rows] = loss_all
        host = {k: to_host(v) for k, v in stats.items() if k != "loss_all"}
        cost = self.cost_model.round_cost(self, state, sel, host) if len(sel) else CostMeter()
        if wall_clock_s is not None:
            cost.wall_clock_s = wall_clock_s    # overlapped (virtual-clock) billing
        state.result.costs.add(cost)
        state.last_staleness = staleness
        try:
            if len(sel):
                self.strategy.post_round(self, state, sel, host)
        finally:
            state.last_staleness = None
        ctx = RoundContext(engine=self, state=state, t=t, rounds=self.rounds,
                           virtual_time=virtual_time, staleness=staleness)
        for cb in self.callbacks:
            cb.on_round_end(ctx)
        return ctx.stop

    def run_round(self, state: EngineState, t: int) -> bool:
        """One lockstep federated round; True if a callback requested stop."""
        self.last_executor = "stepwise"
        state.round = t
        sel = self.selector.select(self, state)
        return self.merge(state, t, sel, self.dispatch(state, sel, t))

    def run(self, state: EngineState | None = None) -> RunResult:
        if state is None:
            state = self.init_state()
        for cb in self.callbacks:
            cb.on_run_start(self, state)
        self.scheduler.run(self, state)
        if state.last_eval is not None and state.last_eval[0] == state.round:
            # EvalCallback already scored this round's (unchanged) params
            final_eval = state.last_eval[1]
        else:
            final_eval = evaluate_global(state.params, self.eval_graph, "test")
        state.result.final = dict(final_eval, **state.result.costs.snapshot())
        for cb in self.callbacks:
            cb.on_run_end(self, state)
        return state.result
