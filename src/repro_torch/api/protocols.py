"""Pluggable components of the FedEngine, and their defaults.

Port of ``repro/api/protocols.py``: the client selector, the aggregators,
the sync-interval controllers, the paper's cost model and the lockstep
scheduler. Each default reproduces the reference's choice.

Still to port: ``SizeBiasedSelector``, ``LossBiasedSelector``,
``StalenessWeightedAggregator`` and ``AsyncScheduler`` (ROADMAP A2), and
the fused executor behind ``SyncScheduler(fused=True)`` (A4).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.federated.costs import BYTES_F32, CostMeter, DelayModel, model_bytes, seq_sum
from repro_torch.federated.server import fedavg, fedavg_weighted, select_clients, update_tau


class UniformSelector:
    """Uniform without replacement from the host RNG — the paper's choice.
    Ids are distinct, which the merge's write-back relies on."""

    def select(self, engine, state) -> np.ndarray:
        return select_clients(state.rng, engine.fed.n_clients, engine.clients_per_round)


class FedAvg:
    """Unweighted mean over the selected clients — Algorithm 1 line 7."""

    uses_weights = False

    def aggregate(self, stacked_params, weights=None):
        return fedavg(stacked_params)


class WeightedFedAvg:
    """Dataset-size-weighted FedAvg; the engine passes
    ``fed.client_sizes[sel]`` as the weights."""

    uses_weights = True

    def aggregate(self, stacked_params, weights=None):
        if weights is None:
            raise ValueError("WeightedFedAvg needs per-client weights")
        return fedavg_weighted(stacked_params, torch.as_tensor(weights, dtype=torch.float32))


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


@dataclass
class PaperCostModel:
    """The paper's analytic byte/FLOP/delay accounting (Fig. 3/4 axes),
    vectorized over the cohort; meters accumulate with ``seq_sum``, so the
    totals match the reference's to the bit. ``stats`` are host arrays."""

    delay: DelayModel = field(default_factory=DelayModel)

    def client_flops(self, engine, sel, stats) -> np.ndarray:
        sizes = np.asarray(engine.fed.client_sizes[sel], np.int64)
        nodes = sizes + engine.mcfg.local_epochs * np.minimum(
            engine.bsz, np.maximum(sizes, 1))
        return 3.0 * engine.fwd_flops_node * nodes \
            + engine.strategy.extra_flops(engine, sizes)

    def client_embed_bytes(self, engine, stats) -> np.ndarray:
        n_pulled = np.asarray(stats["n_ghost_pulled"], np.float64)
        return n_pulled * sum((engine.F, engine.H1)) * BYTES_F32

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
        cost.sync_events = int(np.asarray(stats["n_sync"]).sum())
        return cost


@dataclass
class SyncScheduler:
    """The paper's lockstep loop: every round dispatches a fresh cohort and
    blocks until all of it merges, through the stepwise executor
    (``FedEngine.run_round``). ``fused=True`` asks for the fused executor,
    which is not ported (ROADMAP A4) and raises; ``None`` and ``False``
    run stepwise."""

    fused: Optional[bool] = None

    def run(self, engine, state):
        if self.fused:
            raise NotImplementedError(
                "the fused executor is not ported yet (ROADMAP A4); use "
                "SyncScheduler(fused=None) for the stepwise executor")
        for t in range(engine.rounds):
            if engine.run_round(state, t):
                break
