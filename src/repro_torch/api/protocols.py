"""Pluggable components of the FedEngine, and their defaults.

Port of ``repro/api/protocols.py``. The six extension protocols, one per
axis of the method space that Algorithm 1 fixes to a single choice:

    ClientSelector  which clients participate in a round
    Aggregator      how client models merge on the server
    SyncController  how the embedding-sync interval tau evolves (Eq. 11)
    CostModel       what a round costs (bytes / FLOPs / wall-clock)
    RoundScheduler  when client updates merge (lockstep vs buffered-async)
    RoundCallback   side effects at round boundaries (eval, logging, ...)

A custom component is any object with the protocol's methods; pass it to
``FedEngine(..., selector=..., aggregator=...)``. The defaults: the client
selectors, the aggregators
(with the staleness-weighted wrapper), the sync-interval controllers, the
paper's cost model and the two round schedulers, lockstep and
buffered-async. Each default reproduces the reference's choice. The class
attributes the reference's executors read (``precomputable``,
``uses_weights``, ``jit_safe``, ``allreduce_safe``, ``fused_safe``) are
kept with the reference's values.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Optional, Protocol, Sequence, Union, runtime_checkable

import numpy as np
import torch

from repro_torch.faults import corrupt_params_stack
from repro_torch.federated.costs import (
    BYTES_F32,
    CostMeter,
    DelayModel,
    VirtualClock,
    model_bytes,
    seq_sum,
)
from repro_torch.federated.server import fedavg, fedavg_weighted, select_clients, update_tau

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.api.engine import EngineState, FedEngine
    from repro_torch.core.fedais import MethodConfig


def to_host(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _stack_rows(entries, pick):
    """Stack row ``e["pos"]`` of ``pick(e["out"])`` over ``entries``, leaf by
    leaf (dicts and tuples recursed): tensors stay tensors on their device,
    host arrays stay host arrays, dtypes kept."""
    def rec(leaves):
        first = leaves[0]
        if isinstance(first, dict):
            return {k: rec([x[k] for x in leaves]) for k in first}
        if isinstance(first, tuple):
            return tuple(rec(list(xs)) for xs in zip(*leaves))
        rows = [x[e["pos"]] for x, e in zip(leaves, entries)]
        return torch.stack(rows) if torch.is_tensor(first) else np.stack(rows)

    return rec([pick(e["out"]) for e in entries])


@runtime_checkable
class ClientSelector(Protocol):
    def select(self, engine: "FedEngine", state: "EngineState") -> np.ndarray:
        """Return the ids of the clients participating this round, drawn
        without replacement (the synchronous merge's write-back scatters by
        client id). A selector whose draws depend only on the host RNG and
        static data may set ``precomputable = True`` to allow the fused
        executor."""
        ...


class UniformSelector:
    """Uniform without replacement from the host RNG — the paper's choice.
    Ids are distinct, which the merge's write-back relies on."""

    # depends only on the host RNG stream + static geometry
    precomputable = True

    def select(self, engine, state) -> np.ndarray:
        return select_clients(state.rng, engine.fed.n_clients, engine.clients_per_round)


class SizeBiasedSelector:
    """Sample clients with probability proportional to local dataset size.
    Empty clients are never selected; the round shrinks if fewer non-empty
    clients exist than m."""

    precomputable = True    # client sizes are static; only the RNG advances

    def select(self, engine, state):
        sizes = engine.fed.client_sizes.astype(np.float64)
        p = sizes / max(sizes.sum(), 1.0)
        m = min(engine.clients_per_round, engine.fed.n_clients,
                int(np.count_nonzero(p)))
        return state.rng.choice(engine.fed.n_clients, size=m, replace=False, p=p)


class LossBiasedSelector:
    """Prefer clients whose last-seen mean local loss is highest (never-seen
    clients rank first) — the round-level analogue of Eq. 7's node scores.
    ``state.prev_loss`` lives on the device: one copy to the host per
    round, and the host ranks."""

    precomputable = False   # reads state.prev_loss, which changes every round

    def select(self, engine, state):
        pl = to_host(state.prev_loss)
        # padded slots of a visited client hold 0.0 (loss_all is node-masked),
        # so average only over real nodes with an observed loss
        node_mask = np.asarray(engine.fed.node_mask) > 0
        real = (pl >= 0) & node_mask
        mean_loss = (pl * real).sum(axis=1) / np.maximum(real.sum(axis=1), 1)
        # unseen (but non-empty) clients rank first; clients with no nodes at
        # all can never produce a loss and rank last
        scores = np.where(real.any(axis=1), mean_loss, np.inf)
        scores = np.where(node_mask.any(axis=1), scores, -np.inf)
        # random tie-break keeps unseen clients in shuffled order
        tie = state.rng.random(engine.fed.n_clients)
        order = np.lexsort((tie, -scores))
        m = min(engine.clients_per_round, engine.fed.n_clients)
        return order[:m]


@runtime_checkable
class Aggregator(Protocol):
    def aggregate(self, stacked_params, weights=None):
        """Merge a (m, ...) stacked client param dict into one global dict."""
        ...


class FedAvg:
    """Unweighted mean over the selected clients — Algorithm 1 line 7."""

    uses_weights = False
    jit_safe = True
    allreduce_safe = True   # sum(w*x)/sum(w) with uniform w

    def aggregate(self, stacked_params, weights=None):
        return fedavg(stacked_params)


class WeightedFedAvg:
    """Dataset-size-weighted FedAvg; the engine passes
    ``fed.client_sizes[sel]`` as the weights."""

    uses_weights = True
    jit_safe = True
    allreduce_safe = True   # sum(w*x)/sum(w): exactly a weighted all-reduce

    def aggregate(self, stacked_params, weights=None):
        if weights is None:
            raise ValueError("WeightedFedAvg needs per-client weights")
        dev = next(iter(stacked_params.values())).device
        return fedavg_weighted(stacked_params,
                               torch.as_tensor(weights, dtype=torch.float32, device=dev))


def staleness_discount(staleness, *, mode: str = "poly", a: float = 0.5) -> np.ndarray:
    """FedAsync-style staleness discount s(τ) for late-merging updates.

    ``poly``  s(τ) = (1 + τ)^-a      (FedAsync's polynomial family)
    ``exp``   s(τ) = exp(-a τ)
    ``const`` s(τ) = 1               (FedBuff: uniform buffer average)
    """
    s = np.asarray(staleness, np.float64)
    if mode == "poly":
        return (1.0 + s) ** -a
    if mode == "exp":
        return np.exp(-a * s)
    if mode == "const":
        return np.ones_like(s)
    raise ValueError(f"unknown staleness mode {mode!r}; known: poly|exp|const")


@dataclass
class StalenessWeightedAggregator:
    """Wraps a base Aggregator with multiplicative staleness discounts.

    An update dispatched at server version v and merged at version V has
    staleness τ = V - v; its aggregation weight is scaled by s(τ), composed
    with the base aggregator's own weights when it uses them. When every
    update is fresh (every s(τ) = 1) the merge delegates to the base
    aggregator unchanged — what makes a full-quorum AsyncScheduler
    bit-identical to the synchronous engine. The discounts are host
    float64; the weighted mean runs on the params' device.
    """

    base: object = field(default_factory=FedAvg)
    mode: str = "poly"
    a: float = 0.5

    uses_weights = True
    jit_safe = False

    def aggregate(self, stacked_params, weights=None, staleness=None):
        if staleness is None:
            return self.base.aggregate(stacked_params, weights)
        d = staleness_discount(staleness, mode=self.mode, a=self.a)
        if d.size and float(d.min()) == 1.0:   # all fresh: exactly the base merge
            return self.base.aggregate(stacked_params, weights)
        # a stale merge becomes a discounted weighted mean — only valid for
        # mean-family bases; a custom rule must declare how it composes
        uses_weights = getattr(self.base, "uses_weights", None)
        if uses_weights is None:
            raise TypeError(
                f"{type(self.base).__name__} does not declare `uses_weights`; "
                "StalenessWeightedAggregator can only fold discounts into "
                "mean-family aggregators — set `uses_weights` on the base "
                "(True to compose with its weights, False for a plain "
                "discounted mean) or implement staleness in the base itself")
        if uses_weights and weights is not None:
            d = d * to_host(weights).astype(np.float64)
        dev = next(iter(stacked_params.values())).device
        return fedavg_weighted(stacked_params,
                               torch.as_tensor(d, dtype=torch.float32, device=dev))


@runtime_checkable
class SyncController(Protocol):
    def initial(self, mcfg: "MethodConfig") -> int:
        ...

    def update(self, mcfg: "MethodConfig", test_loss: float,
               initial_loss: float) -> int:
        ...


class AdaptiveSyncController:
    """Eq. 11 when ``mcfg.adaptive_sync``, else the fixed interval tau0."""

    def initial(self, mcfg):
        return mcfg.tau0

    def update(self, mcfg, test_loss, initial_loss):
        return update_tau(mcfg, test_loss, initial_loss, mcfg.tau0)


class FixedSyncController:
    """Always tau0, regardless of the loss trajectory."""

    def initial(self, mcfg):
        return mcfg.tau0

    def update(self, mcfg, test_loss, initial_loss):
        return mcfg.tau0


@runtime_checkable
class CostModel(Protocol):
    def round_cost(self, engine: "FedEngine", state: "EngineState",
                   sel: np.ndarray, stats: dict) -> CostMeter:
        ...

    # the async scheduler prices per-client finish times with these three

    def client_compute_times(self, engine: "FedEngine", state: "EngineState",
                             sel: np.ndarray, stats: dict) -> np.ndarray:
        ...

    def client_comm_times(self, engine: "FedEngine", state: "EngineState",
                          sel: np.ndarray, stats: dict) -> np.ndarray:
        ...

    def sync_overhead(self, engine: "FedEngine", sel: np.ndarray,
                      stats: dict) -> float:
        ...


@dataclass
class PaperCostModel:
    """The paper's analytic byte/FLOP/delay accounting (Fig. 3/4 axes),
    vectorized over the cohort; meters accumulate with ``seq_sum``, so the
    totals match the reference's to the bit. ``stats`` may be host arrays
    or device tensors (copied to the host where read)."""

    delay: DelayModel = field(default_factory=DelayModel)

    # prices a round from the stats + state.tau alone
    fused_safe = True

    def client_flops(self, engine, sel, stats) -> np.ndarray:
        sizes = np.asarray(engine.fed.client_sizes[sel], np.int64)
        nodes = sizes + engine.mcfg.local_epochs * np.minimum(
            engine.bsz, np.maximum(sizes, 1))
        return 3.0 * engine.fwd_flops_node * nodes \
            + engine.strategy.extra_flops(engine, sizes)

    def client_embed_bytes(self, engine, stats) -> np.ndarray:
        n_pulled = to_host(stats["n_ghost_pulled"]).astype(np.float64)
        return n_pulled * sum((engine.F, engine.H1)) * BYTES_F32

    def client_compute_times(self, engine, state, sel, stats) -> np.ndarray:
        """Per-client local compute time this round (seconds, float64)."""
        return np.asarray(
            self.delay.compute_time(self.client_flops(engine, sel, stats)),
            np.float64)

    def client_comm_times(self, engine, state, sel, stats) -> np.ndarray:
        """Per-client network time this round (seconds, float64): the model
        down/up-link plus the client's own embedding-sync traffic."""
        per = 2.0 * model_bytes(engine.n_params) \
            + self.client_embed_bytes(engine, stats)
        return np.asarray(self.delay.comm_time(per), np.float64)

    def sync_overhead(self, engine, sel, stats) -> float:
        """The per-merge server-side communication overhead ``o`` (seconds);
        the wall-clock meter amortizes it by the sync interval tau."""
        embed_total = seq_sum(self.client_embed_bytes(engine, stats))
        return self.delay.comm_time(
            embed_total / max(len(sel), 1) + 2 * model_bytes(engine.n_params))

    def round_cost(self, engine, state, sel, stats) -> CostMeter:
        cost = CostMeter()
        m = len(sel)
        comm_model = 2 * model_bytes(engine.n_params) \
            + engine.strategy.round_model_bytes(engine)
        comm_embed = self.client_embed_bytes(engine, stats)
        flops = self.client_flops(engine, sel, stats)
        cost.comm_model_bytes += seq_sum(np.full(m, comm_model))
        cost.comm_embed_bytes += seq_sum(comm_embed)
        cost.compute_flops += seq_sum(flops)
        o = self.delay.comm_time(
            cost.comm_embed_bytes / max(m, 1)
            + 2 * model_bytes(engine.n_params))
        per_client_compute = self.delay.compute_time(flops)
        cost.wall_clock_s = float(np.max(per_client_compute)) + o / max(state.tau, 1)
        cost.sync_events = int(to_host(stats["n_sync"]).sum())
        return cost


@runtime_checkable
class RoundScheduler(Protocol):
    """Owns the execution structure of a run: when cohorts dispatch, when
    updates merge, and what wall-clock a merge bills. The engine exposes the
    two halves of a round (``dispatch``, ``merge``) and the scheduler
    sequences them."""

    def run(self, engine: "FedEngine", state: "EngineState") -> None:
        ...


@runtime_checkable
class RoundCallback(Protocol):
    """Side-effect hooks; ``api.callbacks`` holds the default stack."""

    def on_run_start(self, engine: "FedEngine", state: "EngineState") -> None:
        ...

    def on_round_end(self, ctx) -> None:
        ...

    def on_run_end(self, engine: "FedEngine", state: "EngineState") -> None:
        ...


@dataclass
class SyncScheduler:
    """The paper's lockstep loop: every round dispatches a fresh cohort and
    blocks until all of it merges — the same history through either
    executor.

    ``fused`` selects the executor: ``None`` (default) takes the fused one
    (``FedEngine.run_fused``) whenever every component is fusable
    (``FedEngine.fused_eligibility``), else the per-round stepwise loop;
    ``True`` forces fused (raising with the reason if ineligible);
    ``False`` forces stepwise. A fused run whose capture fails raises; it
    never turns stepwise on its own."""

    fused: Optional[bool] = None

    def run(self, engine, state):
        fused = self.fused
        if fused is None:
            fused, _ = engine.fused_eligibility(state)
        elif fused:
            ok, why = engine.fused_eligibility(state)
            if not ok:
                raise ValueError(f"fused executor unavailable: {why}")
        if fused:
            engine.run_fused(state)
            return
        for t in range(engine.rounds):
            if engine.run_round(state, t):
                break


@dataclass
class AsyncScheduler:
    """Buffered-staleness asynchronous rounds (FedAsync/FedBuff-style).

    ``concurrency`` clients are always in flight. Each dispatched client
    finishes at a virtual time priced by the engine's cost model (per-client
    compute time, scaled by a per-client ``speed_factors`` multiplier).
    Arrivals buffer at the server; once ``quorum`` of them are in, the server
    merges the buffer with staleness-discounted aggregation weights
    (StalenessWeightedAggregator), advances one version, bills only the time
    it actually waited (VirtualClock), and re-dispatches that many fresh
    clients from the new global model. Stragglers merge late with staleness
    τ = merge_version - dispatch_version. The event order is host float64
    arithmetic, the reference's sums in the reference's order, so the merge
    schedule is the reference's exactly.

    With ``quorum == concurrency`` and homogeneous speed factors every merge
    is a full fresh cohort — history-identical to SyncScheduler.

    Fault tolerance (all off by default):

    * ``comm_factors`` — per-client communication-time multipliers: each
      finish time adds ``client_comm_times * factor``.
    * ``timeout_s`` — a server-side wait budget per dispatched client; a
      client that would arrive later times out, is re-dispatched with a
      budget of ``timeout_s * backoff**attempt`` up to ``max_retries``
      times, then abandoned and its slot backfilled with a fresh client.
    * ``max_staleness`` — arrivals older than this many versions are
      evicted unmerged (their slot backfills fresh).
    * an engine ``FaultPlan`` — dropped uploads never arrive (without a
      timeout the slot is lost and counted ``n_lost``, with one it times
      out), stragglers stretch finish times by ``delay_factors``, corrupt
      uploads are poisoned at dispatch and quarantined by the engine's
      merge guard.

    Every event is counted in ``EngineState.fault_events``.

    A dispatched cohort's outputs wait in the heap while later merges write
    the tables in place; they are fresh tensors (the LocalUpdate's stacked
    results), never views of ``state``'s tables, so those writes leave them
    as they were.
    """

    quorum: Optional[int] = None          # arrivals per merge; None -> concurrency
    concurrency: Optional[int] = None     # clients in flight; None -> clients_per_round
    staleness_mode: str = "poly"
    staleness_a: float = 0.5
    speed_factors: Optional[Union[Sequence[float], np.ndarray]] = None
    comm_factors: Optional[Union[Sequence[float], np.ndarray]] = None
    timeout_s: Optional[float] = None     # per-client server wait budget
    max_retries: int = 2                  # re-dispatches after a timeout
    backoff: float = 2.0                  # timeout budget growth per retry
    max_staleness: Optional[int] = None   # evict arrivals older than this

    def _per_client(self, values, n_clients: int, name: str) -> np.ndarray:
        if values is None:
            return np.ones(n_clients, np.float64)
        arr = np.asarray(values, np.float64)
        if arr.shape != (n_clients,):
            raise ValueError(
                f"{name} must have shape ({n_clients},), got {arr.shape}")
        return arr

    def run(self, engine, state):
        M = self.concurrency if self.concurrency is not None else engine.clients_per_round
        Q = self.quorum if self.quorum is not None else M
        if not 1 <= Q <= M:
            raise ValueError(f"quorum {Q} must be in [1, concurrency {M}]")
        if self.max_retries < 0 or self.backoff < 1.0:
            raise ValueError("max_retries must be >= 0 and backoff >= 1")
        factors = self._per_client(self.speed_factors, engine.fed.n_clients,
                                   "speed_factors")
        comm_f = (None if self.comm_factors is None else
                  self._per_client(self.comm_factors, engine.fed.n_clients,
                                   "comm_factors"))
        plan = getattr(engine, "faults", None)
        plan = plan if (plan is not None and not plan.empty) else None
        agg = engine.aggregator
        if isinstance(agg, StalenessWeightedAggregator):
            # the scheduler's staleness knobs only parameterize its default
            # wrapper, never an explicitly staleness-aware aggregator
            if (self.staleness_mode, self.staleness_a) != ("poly", 0.5):
                raise ValueError(
                    "staleness_mode/staleness_a only configure the "
                    "scheduler's default wrapper; the engine aggregator is "
                    "already a StalenessWeightedAggregator — set mode/a on "
                    "it instead")
        else:
            agg = StalenessWeightedAggregator(
                base=agg, mode=self.staleness_mode, a=self.staleness_a)

        clock = VirtualClock()
        heap: list = []          # (event_time, seq, entry) — seq: stable ties
        seq = 0
        version = 0              # server model version (merge count)
        n_timeouts = 0
        # circuit breaker: a run whose every retry times out again (total
        # dropout included) ends, truncated, instead of looping against the
        # virtual clock
        timeout_budget = engine.rounds * M * (self.max_retries + 2) * 8

        def dispatch_cohort(m: int, *, at: Optional[float] = None,
                            attempt: int = 0, forced_sel=None) -> None:
            nonlocal seq
            if forced_sel is not None:
                sel = np.asarray(forced_sel)
            else:
                saved = engine.clients_per_round
                engine.clients_per_round = m    # selectors size cohorts from this
                try:
                    sel = np.asarray(engine.selector.select(engine, state))
                finally:
                    engine.clients_per_round = saved
            out = engine.dispatch(state, sel, version)
            if plan is not None:
                cmask = plan.corruptions(version, sel)
                if cmask.any():
                    out = (corrupt_params_stack(out[0], cmask, plan.corrupt_value()),
                           ) + tuple(out[1:])
                drops = plan.drops(version, sel)
                dfact = plan.delay_factors(sel)
            else:
                drops = np.zeros(len(sel), bool)
                dfact = np.ones(len(sel), np.float64)
            times = engine.cost_model.client_compute_times(engine, state, sel, out[-1])
            ctimes = (None if comm_f is None else
                      engine.cost_model.client_comm_times(engine, state, sel, out[-1]))
            base = clock.now if at is None else at
            for pos, cli in enumerate(sel):
                rel = float(times[pos]) * float(factors[cli])
                if ctimes is not None:
                    rel += float(ctimes[pos]) * float(comm_f[cli])
                rel *= float(dfact[pos])
                entry = dict(version=version, pos=pos, client=int(cli),
                             cohort=len(sel), out=out, rel_time=rel,
                             dispatch_time=base, attempt=attempt)
                budget = (None if self.timeout_s is None
                          else self.timeout_s * self.backoff ** attempt)
                if drops[pos] and budget is None:
                    # the upload is lost and the server waits forever for
                    # it: without a timeout this in-flight slot leaks
                    state.fault_events.n_lost += 1
                elif budget is not None and (drops[pos] or rel > budget):
                    entry["timed_out"] = True
                    heapq.heappush(heap, (base + budget, seq, entry))
                    seq += 1
                else:
                    heapq.heappush(heap, (base + rel, seq, entry))
                    seq += 1

        if engine.rounds <= 0:
            return    # SyncScheduler is a no-op here too; don't burn a cohort
        dispatch_cohort(M)
        buffer: list = []
        t = 0
        while t < engine.rounds and heap:
            when, _, entry = heapq.heappop(heap)
            if entry.get("timed_out"):
                state.fault_events.n_timeouts += 1
                n_timeouts += 1
                if n_timeouts > timeout_budget:
                    break           # graceful truncation, never a spin
                if entry["attempt"] < self.max_retries:
                    state.fault_events.n_retries += 1
                    dispatch_cohort(1, at=when, attempt=entry["attempt"] + 1,
                                    forced_sel=[entry["client"]])
                else:
                    state.fault_events.n_aborted += 1
                    dispatch_cohort(1, at=when)     # backfill a fresh slot
                continue
            if (self.max_staleness is not None
                    and version - entry["version"] > self.max_staleness):
                state.fault_events.n_evicted += 1
                dispatch_cohort(1, at=when)         # replace the stale slot
                continue
            buffer.append(entry)
            if len(buffer) < Q:
                continue
            last = entry                       # the quorum-completing arrival
            # canonical merge order (dispatch version, cohort position): a
            # deterministic restack, and for a single full cohort exactly the
            # dispatch order the synchronous engine aggregates in
            entries = sorted(buffer, key=lambda e: (e["version"], e["pos"]))
            buffer = []
            sel = np.asarray([e["client"] for e in entries])
            if (len({e["version"] for e in entries}) == 1
                    and [e["pos"] for e in entries]
                    == list(range(entries[0]["cohort"]))):
                out = entries[0]["out"]        # one whole cohort: reuse as-is
            else:
                out = _stack_rows(entries, lambda o: o)
            staleness = np.asarray([version - e["version"] for e in entries])
            o = engine.cost_model.sync_overhead(engine, sel, out[-1])
            elapsed = clock.merge_elapsed(
                last["dispatch_time"], last["rel_time"], o / max(state.tau, 1))
            stop = engine.merge(
                state, t, sel, out, staleness=staleness, aggregator=agg,
                wall_clock_s=elapsed, virtual_time=clock.now)
            version += 1
            t += 1
            if stop:
                break
            if t < engine.rounds:
                dispatch_cohort(len(entries))

        # Bill work that was dispatched but never merged (in flight or
        # buffered when the run ended): those downloads, pulls and local
        # epochs really ran, so comm/compute meters count them; only
        # wall-clock is forgiven. With a full quorum nothing is left over.
        leftovers = buffer + [e for _, _, e in heap]
        if leftovers:
            leftovers.sort(key=lambda e: (e["version"], e["pos"]))
            sel = np.asarray([e["client"] for e in leftovers])
            stats = _stack_rows(leftovers, lambda o: o[-1])
            cost = engine.cost_model.round_cost(engine, state, sel, stats)
            cost.wall_clock_s = 0.0
            state.result.costs.add(cost)
