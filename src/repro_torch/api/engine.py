"""FedEngine: the federated training engine (Algorithm 1).

Port of ``repro/api/engine.py`` (``RunResult``, ``EngineState``,
``FedEngine``: ``init_state``, ``dispatch``, ``merge``, ``run_round``,
``_inject_faults``, ``fused_eligibility``, ``sharded_eligibility``,
``pod_sharded_eligibility``, ``_run_chunk``, ``run_fused``, ``run``). A
round is

    select clients -> strategy hooks -> cohort LocalUpdate -> aggregate
    -> historical write-back -> cost accounting -> callbacks

Two executors run it on one device, and two more on a mesh:

* the **stepwise** executor (``run_round`` = ``dispatch`` + ``merge``):
  ``dispatch`` runs the cohort's LocalUpdate (``core.fedais``) client by
  client, ``merge`` is the server half. The async scheduler always uses it.
* the **fused** executor (``run_fused``, ``api.fused``): a round is one
  body over static buffers, captured once per graph key as a CUDA graph
  and replayed each round on the card (run eagerly on the CPU). Chunks end
  at eval rounds; the rounds' light stats reach the host once per chunk,
  and the host tail (cost accounting, ``post_round``, callbacks) replays
  per round from them: the stepwise history, bit for bit.
  ``SyncScheduler`` picks it when every component is fusable
  (``fused_eligibility``).

The tables live on the engine's device (``device=None`` is ``cuda:0``) and
every executor writes the cohort's rows into them in place. ``sync_dtype``
is the wire format of the ghost pull and of the write-back
(``federated.quant``).

Faults (``faults``): a seeded ``FaultPlan`` drops, corrupts and delays
uploads between dispatch and merge (``_inject_faults``), and the merge's
``UpdateGuard`` (``guard=True``, the default: finite only) quarantines the
updates it refuses. An empty plan and an all-pass guard change nothing.
Under a live plan the fused executor runs the fault-aware round
(``fused_faulty``, ``faults.fused``).

With a device ``mesh`` (a ``torch.distributed`` ``DeviceMesh``, one process
per rank, every rank running the same engine from the same seed) the fused
chunk shards its cohort over the mesh's ``"clients"`` axis
(``sharded_fused``, ``sharding.fed``: a weighted all-reduce merge, ragged
cohorts padded with zero-weight dummies), and on a ``("pods", "clients")``
mesh every K-sized table lives in pod shards (``pod_sharded``,
``sharding.tables``: the owner-keyed fetch, the gated ghost all-to-all,
the bucket-routed write-back). Ineligible configurations fall down the
reference's chain: pod-sharded -> client-sharded -> fused -> stepwise
(``pod_sharded_eligibility``, ``sharded_eligibility``).
``merge_reduce="pairwise"`` sums the merge in a fixed tree on both.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.api.callbacks import (
    EarlyStopCallback,
    EvalCallback,
    HistoryCallback,
    RoundContext,
    VerboseCallback,
    default_callbacks,
)
from repro_torch.api.fused import FusedRounds, ShardedRounds
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
from repro_torch.faults import (
    FaultCounters,
    FaultPlan,
    UpdateGuard,
    corrupt_params_stack,
    guard_mask,
)
from repro_torch.federated.costs import CostMeter, DelayModel
from repro_torch.federated.partition import FederatedGraph
from repro_torch.federated.quant import check_sync_dtype, quant_roundtrip
from repro_torch.federated.server import build_eval_graph, evaluate_global
from repro_torch.kernels.spmm.ops import spmm_route
from repro_torch.sharding.fed import axis_size, client_axis_of
from repro_torch.sharding.tables import pod_axes_of
from repro_torch.utils import spans
from repro_torch.utils.spans import span
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

# Default-stack callbacks that act only at eval rounds, which are chunk
# boundaries — the exact types, not subclasses: an override could observe
# mid-chunk state the fused executor no longer materialises per round.
_FUSED_SAFE_CALLBACKS = (EvalCallback, HistoryCallback, VerboseCallback,
                         EarlyStopCallback)


def _check_full_tables(state) -> None:
    if state.pod_shard is not None:
        raise ValueError("the state's tables are this rank's pod shards (a pod-sharded "
                         "run): gather them with sharding.tables.gather_tables before "
                         "another executor takes the state")


def _take(tree, keep: np.ndarray):
    """Rows ``keep`` of every leaf of a stacked cohort output (dicts and
    tuples recursed; tensors indexed on their device, host arrays on the
    host)."""
    if isinstance(tree, dict):
        return {k: _take(v, keep) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_take(v, keep) for v in tree)
    if torch.is_tensor(tree):
        return tree[torch.as_tensor(keep, dtype=torch.long, device=tree.device)]
    return np.asarray(tree)[keep]


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
    # what the engine/scheduler did about faults (dropped uploads,
    # quarantined updates, async timeouts/retries/evictions, ...)
    fault_events: FaultCounters = field(default_factory=FaultCounters)
    # (n_pods, pod, rows_per_pod, n_clients) once a pod-sharded run holds
    # this rank's pod shards in ``hist`` / ``prev_loss`` instead of K rows
    # (``sharding.tables.gather_tables`` gives the K rows back)
    pod_shard: Optional[tuple] = None


class FedEngine:
    """Federated trainer over a partitioned graph, on one device or, with a
    ``mesh``, on every rank of it.

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
        faults: Optional[FaultPlan] = None,
        guard: Union[UpdateGuard, bool, None] = True,
        mesh=None,
        client_sharding: str = "auto",
        table_sharding: str = "auto",
        merge_reduce: str = "psum",
        device=None,
    ):
        self.sync_dtype = check_sync_dtype(sync_dtype)
        if train_backend not in AGG_BACKENDS:
            raise ValueError(f"unknown train_backend {train_backend!r}; "
                             f"known: {AGG_BACKENDS}")
        if (mesh is not None and device is None and getattr(mesh, "device_type", None) == "cuda"
                and torch.cuda.is_available()):
            # the rank's own card (the launcher set it current)
            device = torch.device("cuda", torch.cuda.current_device())
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
        # ---- the mesh (the fused executor's scale-out) ----
        if client_sharding not in ("auto", "divisible", "off"):
            raise ValueError(
                f"unknown client_sharding {client_sharding!r}; known: "
                "auto (pad ragged cohorts) | divisible (shard only when the "
                "cohort splits evenly) | off")
        if table_sharding not in ("auto", "pods", "replicated"):
            raise ValueError(
                f"unknown table_sharding {table_sharding!r}; known: "
                "auto (pod-shard when the mesh has a 'pods' axis) | pods | "
                "replicated")
        if merge_reduce not in ("psum", "pairwise"):
            raise ValueError(
                f"unknown merge_reduce {merge_reduce!r}; known: psum "
                "(weighted all-reduce) | pairwise (fp32 fixed-tree over "
                "gathered partials)")
        self.mesh = mesh
        self.client_sharding = client_sharding
        self.table_sharding = table_sharding
        self.merge_reduce = merge_reduce
        self.client_axis = None
        self.pod_axes = None
        if mesh is not None:
            if not (hasattr(mesh, "mesh_dim_names") and hasattr(mesh, "device_type")):
                raise TypeError(f"mesh must be a torch.distributed DeviceMesh, got "
                                f"{type(mesh).__name__}")
            self.pod_axes = pod_axes_of(mesh)
            self.client_axis = client_axis_of(mesh)
            if self.client_axis is None and self.pod_axes is None:
                raise ValueError(
                    "client sharding needs a mesh with a 'clients' axis (or "
                    f"a single axis); got axes {tuple(mesh.mesh_dim_names)}")
            if mesh.device_type != self.device.type:
                raise ValueError(f"the mesh's ranks run on {mesh.device_type}, the "
                                 f"engine's device is {self.device}")
        if table_sharding == "pods" and self.pod_axes is None:
            raise ValueError(
                "table_sharding='pods' needs a mesh with ('pods', 'clients') "
                f"axes; got {None if mesh is None else tuple(mesh.mesh_dim_names)}")
        # "stepwise" | "fused" | "fused_faulty" | "sharded_fused" | "pod_sharded"
        self.last_executor: Optional[str] = None

        # ---- fault injection + merge guard (repro_torch.faults) ----
        # an empty plan (or None) is inert: every fault branch gates on the
        # plan firing. guard=True checks finiteness, an UpdateGuard adds a
        # delta-norm ceiling, False/None lets every update through.
        if faults is not None and not isinstance(faults, FaultPlan):
            raise ValueError(f"faults must be a FaultPlan or None, got "
                             f"{type(faults).__name__}")
        self.faults = faults
        self._faults_active = faults is not None and not faults.empty
        if guard is True:
            self._guard: Optional[UpdateGuard] = UpdateGuard()
        elif guard is False or guard is None:
            self._guard = None
        elif isinstance(guard, UpdateGuard):
            self._guard = guard
        else:
            raise ValueError("guard must be an UpdateGuard, True (finite "
                             f"check only) or False/None, got {guard!r}")

        # ---- static geometry + the cohort LocalUpdate ----
        self.F, self.H1 = fed.n_features, HIDDEN[0]
        self.n_params = gcn_param_count(self.F, fed.n_classes)
        avg_deg = float(fed.nbr_mask.sum() / np.maximum(fed.node_mask.sum(), 1))
        self.fwd_flops_node = gcn_flops_per_node(self.F, fed.n_classes, avg_deg)
        self.bsz = batch_size_for(self.mcfg, fed.n_max)
        # one SpMM route for every aggregation of the run, from the graph
        # (the dense operand where the eval's (n, n) one fits)
        self.spmm_route = spmm_route(graph.n_nodes)
        self._cohort = make_cohort_update(self.mcfg, fed.n_max, train_backend=train_backend,
                                          sync_dtype=self.sync_dtype,
                                          spmm_route=self.spmm_route)
        self.eval_graph = build_eval_graph(graph, max_deg=fed.max_deg, seed=seed,
                                           backend=eval_backend, device=self.device)
        self._fused: Optional[FusedRounds] = None     # built by the first chunk
        self._sharded: dict = {}                      # pods? -> ShardedRounds

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
        _check_full_tables(state)
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
        billing) and the clock's ``virtual_time``.

        Under an ``UpdateGuard`` (the default) every arriving update must be
        finite (and inside the guard's norm ceiling) to aggregate or write
        its rows; the others are quarantined, counted in
        ``state.fault_events.n_quarantined``. An all-pass guard takes the
        unfiltered path. A merge with no survivor is a server no-op round.
        Cost and ``post_round`` observe the whole cohort that arrived.
        Returns True if a callback requested stop."""
        state.round = t
        new_params_stack, new_hist1, new_age, new_ghost_feat, stats = out
        full_sel, full_stats, full_staleness = np.asarray(sel), stats, staleness
        sel = full_sel
        if self._guard is not None and len(full_sel):
            ok = guard_mask(new_params_stack, state.params, self._guard.max_norm)
            if not ok.all():
                state.fault_events.n_quarantined += int((~ok).sum())
                keep = np.flatnonzero(ok)
                sel = full_sel[keep]
                if staleness is not None:
                    staleness = np.asarray(staleness)[keep]
                (new_params_stack, new_hist1, new_age, new_ghost_feat,
                 stats) = _take(out, keep)
        if len(sel) == 0:
            # every update dropped out or was quarantined: server no-op
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
        host = {k: to_host(v) for k, v in full_stats.items() if k != "loss_all"}
        cost = (self.cost_model.round_cost(self, state, full_sel, host) if len(full_sel)
                else CostMeter())       # nothing arrived, nothing billed
        if wall_clock_s is not None:
            cost.wall_clock_s = wall_clock_s    # overlapped (virtual-clock) billing
        state.result.costs.add(cost)
        state.last_staleness = full_staleness   # aligned with full_sel
        try:
            if len(full_sel):
                self.strategy.post_round(self, state, full_sel, host)
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
        out = self.dispatch(state, sel, t)
        wall = None
        if self._faults_active:
            sel, out, wall = self._inject_faults(state, t, sel, out)
        return self.merge(state, t, sel, out, wall_clock_s=wall)

    def _inject_faults(self, state: EngineState, t: int, sel, out):
        """Apply the FaultPlan between dispatch and merge (the stepwise sync
        path): corrupt the marked members' uploaded params (the merge guard
        quarantines them), drop the lost members' uploads, and re-bill the
        round's wall clock with the stragglers' delay factors (the lockstep
        server waits for every dispatched member, stragglers included, but
        the merge overhead ``o`` is priced from the uploads that arrived).
        Returns (surviving sel, filtered out, wall override)."""
        plan = self.faults
        sel = np.asarray(sel)
        full_sel, full_stats = sel, out[-1]
        cmask = plan.corruptions(t, sel)
        if cmask.any():
            out = (corrupt_params_stack(out[0], cmask, plan.corrupt_value()),) + tuple(out[1:])
        drop = plan.drops(t, sel)
        if drop.any():
            state.fault_events.n_dropped += int(drop.sum())
            keep = np.flatnonzero(~drop)
            sel = sel[keep]
            out = _take(out, keep)
        wall = None
        if plan.straggler_frac > 0.0:
            times = np.asarray(self.cost_model.client_compute_times(
                self, state, full_sel, full_stats), np.float64)
            times = times * plan.delay_factors(full_sel)
            o = self.cost_model.sync_overhead(self, sel, out[-1])
            wall = float(np.max(times)) + o / max(state.tau, 1)
        return sel, out, wall

    # ------------------------------------------------------------------
    # fused executor (the SyncScheduler's default path)
    # ------------------------------------------------------------------

    def fused_eligibility(self, state: EngineState | None = None) -> tuple[bool, str]:
        """Can this engine run the fused executor bit-identically to the
        stepwise one? Every component must declare itself safe for deferred
        host observation: the selector precomputes a chunk's cohorts from
        the host RNG alone, the aggregator runs inside the round body
        (``jit_safe``), the strategy has no per-round host hooks, the cost
        model prices rounds from streamed stats alone, and the callbacks are
        the exact default-stack types. On CUDA (and given the ``state``)
        the draws must come from ``TorchDraws``, whose generator a CUDA
        graph replays; a provider of host draws cannot be captured.
        Returns (ok, reason)."""
        from repro_torch.api.strategies import MethodStrategy

        scls = type(self.strategy)
        fusable = getattr(self.strategy, "fusable", None)
        if fusable is None:
            fusable = (scls.pre_round is MethodStrategy.pre_round
                       and scls.post_round is MethodStrategy.post_round)
        if not fusable:
            return False, f"strategy {scls.__name__} has per-round host hooks"
        if not getattr(self.selector, "precomputable", False):
            return False, (f"selector {type(self.selector).__name__} reads "
                           "per-round state (not precomputable)")
        if not getattr(self.aggregator, "jit_safe", False):
            return False, (f"aggregator {type(self.aggregator).__name__} "
                           "is not jit-traceable (jit_safe)")
        if not getattr(self.cost_model, "fused_safe",
                       isinstance(self.cost_model, PaperCostModel)):
            return False, (f"cost model {type(self.cost_model).__name__} "
                           "not declared fused_safe")
        for cb in self.callbacks:
            if not getattr(cb, "fused_safe", type(cb) in _FUSED_SAFE_CALLBACKS):
                return False, (f"callback {type(cb).__name__} may observe "
                               "per-round state (not fused_safe)")
        if self._faults_active:
            # the fault-aware round hardcodes a masked weighted mean; a
            # custom merge rule takes the stepwise path
            why = self._allreduce_unsafe_reason()
            if why:
                return False, ("fault-aware fused chunk needs a mean-family "
                               "merge: " + why)
        if (self.device.type == "cuda" and state is not None
                and type(state.draws) is not TorchDraws):
            return False, (f"draw provider {type(state.draws).__name__} is not "
                           "TorchDraws: a CUDA graph replays only a device "
                           "generator's draws")
        return True, ""

    def _allreduce_unsafe_reason(self) -> str:
        """Why the aggregator cannot be replaced by the masked weighted mean
        (empty string when it can). The flag must be vouched for by the
        class that provides ``aggregate``: a subclass overriding it without
        re-declaring ``allreduce_safe`` does not inherit eligibility."""
        provider = next((c for c in type(self.aggregator).__mro__
                         if "aggregate" in c.__dict__), None)
        if provider is None or not provider.__dict__.get("allreduce_safe", False):
            return (f"aggregator {type(self.aggregator).__name__} does "
                    "not declare its aggregate() a weighted-mean "
                    "family (allreduce_safe) rule")
        return ""

    def sharded_eligibility(self, m: int | None = None) -> tuple[bool, str]:
        """Can the fused chunk shard its client axis over ``self.mesh``?

        Refines ``fused_eligibility`` (which must already hold: the sharded
        executor is a variant of the fused one): the merge must be a
        weighted mean (``allreduce_safe`` aggregators), the fault plan
        dropout and stragglers only, and with
        ``client_sharding="divisible"`` the cohort ``m`` must split evenly
        across the mesh axis instead of being padded. Ineligible
        configurations fall back to the fused chunk."""
        if self.mesh is None:
            return False, "no mesh configured"
        if self.client_sharding == "off":
            return False, "client_sharding='off'"
        if self.client_axis is None:
            return False, ("mesh has no 'clients' (or single) axis to shard "
                           "the cohort over")
        why = self._allreduce_unsafe_reason()
        if why:
            return False, why
        why = self._sharded_faults_unsafe_reason()
        if why:
            return False, why
        if m is not None and self.client_sharding == "divisible":
            shards = axis_size(self.mesh, self.client_axis)
            if m % shards:
                return False, (f"cohort size {m} does not divide mesh axis "
                               f"size {shards} (client_sharding='divisible' "
                               "disables padding)")
        return True, ""

    def _sharded_faults_unsafe_reason(self) -> str:
        """Why the active FaultPlan cannot run on the sharded executors
        (empty string when it can). Dropout rides the executors'
        zero-weight dummies; corruption needs the fault-aware fused round's
        guard."""
        if self._faults_active and self.faults.corrupt > 0.0:
            return ("sharded executors support dropout/straggler faults "
                    "only; corrupt updates need the fault-aware fused "
                    "chunk's in-trace guard")
        return ""

    def pod_sharded_eligibility(self, m: int | None = None) -> tuple[bool, str]:
        """Can the fused chunk run with pod-sharded tables?

        Refines ``sharded_eligibility`` for the ``("pods", "clients")``
        mesh (``sharding.tables``): the mesh must carry both axes,
        ``table_sharding`` must allow it, and the merge must be a weighted
        mean. Cohorts pad over every rank of the mesh (pods x clients);
        ``client_sharding="divisible"`` demands divisibility instead.
        Ineligible configurations fall down the chain: pod-sharded ->
        client-sharded -> fused -> stepwise."""
        if self.mesh is None:
            return False, "no mesh configured"
        if self.pod_axes is None:
            return False, ("mesh has no ('pods', 'clients') axes "
                           f"(got {tuple(self.mesh.mesh_dim_names)})")
        if self.table_sharding == "replicated":
            return False, "table_sharding='replicated'"
        if self.client_sharding == "off":
            return False, "client_sharding='off'"
        why = self._allreduce_unsafe_reason()
        if why:
            return False, why
        why = self._sharded_faults_unsafe_reason()
        if why:
            return False, why
        if m is not None and self.client_sharding == "divisible":
            shards = self.mesh.size()
            if m % shards:
                return False, (f"cohort size {m} does not divide the mesh's "
                               f"{shards} devices (client_sharding="
                               "'divisible' disables padding)")
        return True, ""

    def _cohort_weights(self, sel_stack: np.ndarray) -> np.ndarray:
        """Per-client aggregation weights for the sharded merges: client
        sizes when the aggregator folds them in (WeightedFedAvg), uniform
        otherwise (FedAvg)."""
        if getattr(self.aggregator, "uses_weights", False):
            return self.fed.client_sizes[sel_stack].astype(np.float32)
        return np.ones(sel_stack.shape, np.float32)

    def _prefetched_cohort(self):
        """The cohort LocalUpdate of the pod-sharded round: ghost sources
        as the exchange delivered them."""
        return make_cohort_update(self.mcfg, self.fed.n_max, train_backend=self.train_backend,
                                  sync_dtype=self.sync_dtype, ghost_source="prefetched",
                                  spmm_route=self.spmm_route)

    def _run_chunk(self, state: EngineState, t0: int, n_rounds: int) -> bool:
        """Select the cohorts of rounds [t0, t0 + n_rounds) on the host, run
        the rounds through the fused executor (on a mesh, the pod-sharded or
        client-sharded one where eligible), then replay the host tail
        (cost accounting, ``post_round``, callbacks) per round from the
        light stats read once. Under a live FaultPlan the chunk's drop and
        corruption masks come from the plan's (round, client) coordinates,
        the rounds take the fault-aware body, and the tail bills as the
        stepwise merge does: dropped members nothing, stragglers stretch
        the wall clock, a round with no survivor is an empty merge.
        Returns True if a callback requested stop."""
        with span("fedais.chunk", device_allocs=True):
            spans.count("chunks")
            spans.count("rounds", n_rounds)
            with span("fedais.chunk.select"):
                sels, fans = [], []
                for t in range(t0, t0 + n_rounds):
                    state.round = t
                    sel = np.asarray(self.selector.select(self, state))
                    sels.append(sel)
                    fans.append(self.strategy.choose_fanouts(self, sel))
                if any(len(s) != len(sels[0]) for s in sels):
                    raise ValueError(
                        "fused executor needs constant cohort sizes across a chunk; "
                        "precomputable selectors must return fixed-size cohorts")
                eoffs = np.arange(t0, t0 + n_rounds, dtype=np.int64) * self.mcfg.local_epochs

                drop_stack = cmask_stack = None
                if self._faults_active:
                    ts = range(t0, t0 + n_rounds)
                    drop_stack = np.stack([self.faults.drops(t, s) for t, s in zip(ts, sels)])
                    cmask_stack = np.stack([self.faults.corruptions(t, s)
                                            for t, s in zip(ts, sels)])
                    state.fault_events.n_dropped += int(drop_stack.sum())
            m = len(sels[0])
            if self.mesh is not None and self.pod_sharded_eligibility(m)[0]:
                self.last_executor = "pod_sharded"
                light = self._sharded_rounds(pods=True).run_chunk(state, sels, fans, eoffs,
                                                                  drop_stack)
            elif self.mesh is not None and self.sharded_eligibility(m)[0]:
                _check_full_tables(state)
                self.last_executor = "sharded_fused"
                light = self._sharded_rounds(pods=False).run_chunk(state, sels, fans, eoffs,
                                                                   drop_stack)
            else:
                _check_full_tables(state)
                self.last_executor = "fused_faulty" if self._faults_active else "fused"
                if self._fused is None:
                    self._fused = FusedRounds(self)
                light = self._fused.run_chunk(state, sels, fans, eoffs, drop_stack, cmask_stack)

            with span("fedais.chunk.host_tail"):
                n_quar_rounds = light.pop("n_quarantined", None)
                if n_quar_rounds is not None:
                    state.fault_events.n_quarantined += int(np.sum(n_quar_rounds))
                for i, t in enumerate(range(t0, t0 + n_rounds)):
                    state.round = t
                    stats_t = {k: v[i] for k, v in light.items()}
                    sel_t, stats_b, wall = sels[i], stats_t, None
                    if self._faults_active:
                        plan = self.faults
                        if drop_stack[i].any():
                            # dropped uploads never reach the server: bill survivors
                            keep = np.flatnonzero(~drop_stack[i])
                            sel_t = sels[i][keep]
                            stats_b = {k: v[keep] for k, v in stats_t.items()}
                        if plan.straggler_frac > 0.0:
                            # as _inject_faults bills: the server waits for every
                            # dispatched member, the overhead prices the arrivals
                            times = np.asarray(self.cost_model.client_compute_times(
                                self, state, sels[i], stats_t), np.float64)
                            times = times * plan.delay_factors(sels[i])
                            o = self.cost_model.sync_overhead(self, sel_t, stats_b)
                            wall = float(np.max(times)) + o / max(state.tau, 1)
                        n_quar_t = 0 if n_quar_rounds is None else int(n_quar_rounds[i])
                        if len(sel_t) - n_quar_t <= 0:
                            state.fault_events.n_empty_merges += 1
                    cost = (self.cost_model.round_cost(self, state, sel_t, stats_b) if len(sel_t)
                            else CostMeter())
                    if wall is not None:
                        cost.wall_clock_s = wall
                    state.result.costs.add(cost)
                    if len(sel_t):
                        self.strategy.post_round(self, state, sel_t, stats_b)
                    ctx = RoundContext(engine=self, state=state, t=t, rounds=self.rounds)
                    for cb in self.callbacks:
                        cb.on_round_end(ctx)
                    if ctx.stop:
                        return True
            return False

    def _sharded_rounds(self, *, pods: bool) -> ShardedRounds:
        if pods not in self._sharded:
            self._sharded[pods] = ShardedRounds(self, pods=pods)
        return self._sharded[pods]

    def run_fused(self, state: EngineState) -> None:
        """Run every round through the fused executor, in chunks that end at
        eval rounds, so the EvalCallback's cadence (server eval, tau update,
        early stop) sees exactly the rounds the stepwise loop would."""
        eval_every = next((cb.eval_every for cb in self.callbacks
                           if isinstance(cb, EvalCallback)), None)
        t = 0
        while t < self.rounds:
            if eval_every is None:          # no eval: one chunk for the run
                t_end = self.rounds - 1
            else:                           # the chunk ends at the next eval round
                nxt = t if t % eval_every == 0 else (t // eval_every + 1) * eval_every
                t_end = min(nxt, self.rounds - 1)
            if self._run_chunk(state, t, t_end - t + 1):
                return
            t = t_end + 1

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
