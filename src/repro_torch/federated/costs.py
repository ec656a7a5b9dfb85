"""Communication / computation cost meters + the paper's delay model.

A copy of ``repro/federated/costs.py`` (numpy only): ``seq_sum`` keeps its
left-to-right order, so the meters match the reference's to the bit.

Everything is counted analytically (bytes of what crosses the network,
FLOPs of what runs on clients) so iid/non-iid/scale sweeps are exact and
deterministic — matching how the paper reports Fig. 3/4 cost axes.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BYTES_F32 = 4


def seq_sum(x) -> float:
    """Left-to-right float64 sum, bit-identical to a Python accumulation loop
    starting from 0.0 (np.sum's pairwise blocking rounds differently). Lets
    the cost model vectorize per-client accounting without perturbing meters
    that tests and benchmarks pin exactly."""
    arr = np.asarray(x, np.float64).ravel()
    return float(arr.cumsum()[-1]) if arr.size else 0.0


@dataclass
class CostMeter:
    comm_model_bytes: float = 0.0      # model up/down-link
    comm_embed_bytes: float = 0.0      # cross-client embedding sync
    compute_flops: float = 0.0
    wall_clock_s: float = 0.0
    sync_events: int = 0

    @property
    def comm_total_bytes(self) -> float:
        return self.comm_model_bytes + self.comm_embed_bytes

    def add(self, other: "CostMeter") -> None:
        self.comm_model_bytes += other.comm_model_bytes
        self.comm_embed_bytes += other.comm_embed_bytes
        self.compute_flops += other.compute_flops
        self.wall_clock_s += other.wall_clock_s
        self.sync_events += other.sync_events

    def snapshot(self) -> dict:
        return {
            "comm_model_bytes": self.comm_model_bytes,
            "comm_embed_bytes": self.comm_embed_bytes,
            "comm_total_bytes": self.comm_total_bytes,
            "compute_flops": self.compute_flops,
            "wall_clock_s": self.wall_clock_s,
            "sync_events": self.sync_events,
        }


@dataclass(frozen=True)
class DelayModel:
    """Client compute speed + network bandwidth for the wall-clock estimate
    (paper's c and o). Defaults roughly a commodity edge client."""

    client_flops_per_s: float = 50e9     # 50 GFLOP/s effective
    bandwidth_bytes_per_s: float = 12.5e6  # 100 Mbit/s
    latency_s: float = 0.05

    # Both delays accept a scalar OR a per-client np.ndarray and return the
    # same shape — the cost model prices whole cohorts in one call, and the
    # AsyncScheduler's per-client heterogeneity knobs (speed_factors for
    # compute, comm_factors for links) multiply these baselines elementwise.

    def compute_time(self, flops):
        return flops / self.client_flops_per_s

    def comm_time(self, bytes_):
        return self.latency_s + bytes_ / self.bandwidth_bytes_per_s


@dataclass
class VirtualClock:
    """Server-side virtual clock for overlapped (asynchronous) rounds.

    Synchronous accounting bills ``max(client compute) + sync overhead`` per
    round: every client blocks until the slowest finishes. Under overlap the
    server keeps clients in flight across merges, so a merge bills only the
    wait from the previous merge completion (``now``) until the
    quorum-completing update arrived, plus the server-side overhead.

    ``merge_elapsed`` works from the arriving update's *relative* client time
    rather than subtracting absolute timestamps: when the update was
    dispatched exactly at ``now`` (no overlap — the synchronous regime) the
    billed time is bit-identical to the synchronous meter's
    ``max(compute) + overhead``, which is what pins the async/sync parity
    test.
    """

    now: float = 0.0

    def merge_elapsed(self, dispatch_time: float, client_time: float,
                      overhead: float) -> float:
        """Advance past a merge; returns the wall-clock billed to it."""
        wait = (dispatch_time - self.now) + client_time
        elapsed = max(wait, 0.0) + overhead
        self.now += elapsed
        return elapsed


def model_bytes(n_params: int) -> float:
    return n_params * BYTES_F32


def embed_sync_bytes(n_ghosts: float, dims: tuple[int, ...]) -> float:
    """One synchronization event: per ghost, one embedding per layer."""
    return float(n_ghosts) * sum(dims) * BYTES_F32
