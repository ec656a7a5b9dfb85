"""Deterministic fault injection for the federated engine.

Port of ``repro/faults/plan.py``. A ``FaultPlan`` is a seeded description
of what can go wrong in a deployment (clients dropping out mid-round,
stragglers, poisoned or overflowed uploads, torn checkpoint writes),
evaluated per ``(kind, round, client)`` coordinate, so every executor
(stepwise, fused, async) sees the same faults for the same plan. The
decisions are host numpy, ``np.random.default_rng((seed, kind, round,
client))`` with the reference's salts, so a plan gives the reference's
decisions for every seed and coordinate.

The plan only describes faults. The engine (``api.engine``) drops,
corrupts and delays between its dispatch and merge halves and quarantines
through the ``UpdateGuard``; the async scheduler (``api.protocols``) loses
dropped uploads and stretches finish times; the fused executor takes the
in-round masked merge of ``faults.fused``. ``tear_file`` simulates a torn
checkpoint write. An empty plan is inert: every consumer gates on a fault
actually firing.
"""
from __future__ import annotations

import os
from dataclasses import asdict, dataclass
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["FaultPlan", "FaultCounters", "UpdateGuard", "guard_stats", "guard_mask",
           "corrupt_params_stack", "tear_file", "CORRUPT_MODES"]

CORRUPT_MODES = ("nan", "inf", "scale")

# Event-kind salts: each fault family draws from its own stream, so raising
# `dropout` never reshuffles who gets corrupted.
_DROP, _CORRUPT, _STRAGGLE, _TORN = 11, 13, 17, 19


@dataclass(frozen=True)
class FaultPlan:
    """Seeded, rate-parameterised fault scenario (module docstring).

    dropout          P(a dispatched client's upload never reaches the
                     server) per (round, client).
    straggler_frac   fraction of the client population that is a permanent
                     straggler (static per client).
    straggler_mult   compute/comm time multiplier for stragglers.
    corrupt          P(a client's uploaded params are corrupted) per
                     (round, client).
    corrupt_mode     "nan" | "inf" (caught by the finite guard) | "scale"
                     (a finite blow-up by corrupt_scale; needs
                     UpdateGuard.max_norm to catch).
    torn_write       P(a checkpoint save is torn mid-write) per step.
    """

    seed: int = 0
    dropout: float = 0.0
    straggler_frac: float = 0.0
    straggler_mult: float = 4.0
    corrupt: float = 0.0
    corrupt_mode: str = "nan"
    corrupt_scale: float = 1e6
    torn_write: float = 0.0

    def __post_init__(self):
        for name in ("dropout", "straggler_frac", "corrupt", "torn_write"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"FaultPlan.{name} must be in [0, 1], got {v}")
        if self.corrupt_mode not in CORRUPT_MODES:
            raise ValueError(f"unknown corrupt_mode {self.corrupt_mode!r}; "
                             f"known: {' | '.join(CORRUPT_MODES)}")
        if self.straggler_mult < 1.0:
            raise ValueError("straggler_mult must be >= 1 (a straggler is "
                             f"slower, not faster), got {self.straggler_mult}")

    @property
    def empty(self) -> bool:
        """True when the plan injects nothing (consumers treat it as None)."""
        return not (self.dropout or self.straggler_frac or self.corrupt or self.torn_write)

    def _fires(self, rate: float, *coords: int) -> bool:
        return np.random.default_rng(
            (self.seed,) + tuple(int(c) for c in coords)).random() < rate

    def drops(self, t: int, sel: Sequence[int]) -> np.ndarray:
        """Bool mask over the cohort: whose round-``t`` upload is lost."""
        sel = np.asarray(sel)
        if self.dropout <= 0.0:
            return np.zeros(len(sel), bool)
        return np.array([self._fires(self.dropout, _DROP, t, c) for c in sel])

    def corruptions(self, t: int, sel: Sequence[int]) -> np.ndarray:
        """Bool mask over the cohort: whose round-``t`` upload is corrupted."""
        sel = np.asarray(sel)
        if self.corrupt <= 0.0:
            return np.zeros(len(sel), bool)
        return np.array([self._fires(self.corrupt, _CORRUPT, t, c) for c in sel])

    def corrupt_value(self) -> float:
        """The per-element multiplier a corrupted upload is scaled by."""
        return {"nan": float("nan"), "inf": float("inf"),
                "scale": float(self.corrupt_scale)}[self.corrupt_mode]

    def stragglers(self, clients: Sequence[int]) -> np.ndarray:
        """Bool mask: which of ``clients`` are (static) stragglers."""
        clients = np.asarray(clients)
        if self.straggler_frac <= 0.0:
            return np.zeros(len(clients), bool)
        return np.array([self._fires(self.straggler_frac, _STRAGGLE, c) for c in clients])

    def delay_factors(self, clients: Sequence[int]) -> np.ndarray:
        """Per-client wall-time multipliers (straggler_mult or 1.0)."""
        f = np.ones(len(np.asarray(clients)), np.float64)
        f[self.stragglers(clients)] = self.straggler_mult
        return f

    def tears_write(self, step: int) -> bool:
        """Does the checkpoint save at ``step`` tear mid-write?"""
        return self.torn_write > 0.0 and self._fires(self.torn_write, _TORN, step)

    def describe(self) -> str:
        """Compact scenario slug for logs."""
        parts = []
        if self.dropout:
            parts.append(f"drop{self.dropout:g}")
        if self.straggler_frac:
            parts.append(f"strag{self.straggler_frac:g}x{self.straggler_mult:g}")
        if self.corrupt:
            parts.append(f"corrupt{self.corrupt:g}:{self.corrupt_mode}")
        if self.torn_write:
            parts.append(f"torn{self.torn_write:g}")
        return "+".join(parts) or "none"

    def snapshot(self) -> dict:
        return asdict(self)


@dataclass
class FaultCounters:
    """What the engine/scheduler actually did about faults, accumulated on
    ``EngineState.fault_events``, so a run can assert nothing was silently
    averaged in or silently lost."""

    n_dropped: int = 0        # cohort uploads that never reached a merge
    n_quarantined: int = 0    # non-finite / norm-exploded updates rejected
    n_empty_merges: int = 0   # merges with no survivor (server no-op round)
    n_timeouts: int = 0       # async waits that expired before arrival
    n_retries: int = 0        # async re-dispatches after a timeout
    n_aborted: int = 0        # async clients abandoned after max_retries
    n_evicted: int = 0        # async updates evicted past max_staleness
    n_lost: int = 0           # async slots lost with no timeout configured

    def any(self) -> bool:
        return any(v for v in vars(self).values())

    def snapshot(self) -> dict:
        return dict(vars(self))


@dataclass(frozen=True)
class UpdateGuard:
    """Merge-side admission rule for client updates: every element finite,
    and (when ``max_norm`` is set) the update's global L2 distance from the
    current server params at most ``max_norm``. The finite check alone
    catches "nan"/"inf" corruption; "scale" needs the norm ceiling. A guard
    that admits everything changes nothing."""

    max_norm: Optional[float] = None


def guard_stats(stacked: dict, ref: dict, *, norms: bool = True):
    """Per member of a stacked (m, ...) update dict, on its device: whether
    every element is finite, and (``norms``) the sum of squared deltas
    against ``ref`` over all leaves, non-finite deltas counted as 0.
    Returns ``(ok (m,) bool, sumsq (m,) fp32 or None)``. The stepwise guard
    and the fused executor's in-round guard both take these."""
    ok = sumsq = None
    for k, x in stacked.items():
        flat = x.reshape(x.shape[0], -1)
        fin = torch.isfinite(flat).all(dim=1)
        ok = fin if ok is None else ok & fin
        if norms:
            d = flat - ref[k].reshape(1, -1)
            d = torch.where(torch.isfinite(d), d, 0.0)
            s = (d * d).sum(dim=1)
            sumsq = s if sumsq is None else sumsq + s
    return ok, sumsq


def guard_mask(stacked: dict, ref: dict, max_norm: Optional[float]) -> np.ndarray:
    """Host admission mask for a stacked (m, ...) update dict: True where
    the member passes the UpdateGuard (the norm compared in float64, as the
    reference compares it)."""
    ok, sumsq = guard_stats(stacked, ref, norms=max_norm is not None)
    ok = ok.cpu().numpy().astype(bool)
    if max_norm is not None:
        ok &= np.sqrt(sumsq.cpu().numpy().astype(np.float64)) <= float(max_norm)
    return ok


def corrupt_params_stack(params_stack: dict, mask: np.ndarray, value: float) -> dict:
    """Multiply the masked members' rows of a stacked (m, ...) params dict
    by ``value`` (NaN/inf poison or a finite blow-up); the other rows are
    multiplied by 1.0, which leaves them as they were."""
    m = len(mask)
    mult = np.ones(m, np.float32)
    mult[np.asarray(mask, bool)] = value
    mj = None
    out = {}
    for k, x in params_stack.items():
        if mj is None:
            mj = torch.from_numpy(mult).to(x.device)
        out[k] = x * mj.reshape((m,) + (1,) * (x.ndim - 1)).to(x.dtype)
    return out


def tear_file(path: str, keep_frac: float = 0.5) -> int:
    """Simulate a torn write: truncate ``path`` to ``keep_frac`` of its
    bytes (at least 1 byte removed). Returns the new size."""
    size = os.path.getsize(path)
    keep = min(int(size * keep_frac), size - 1)
    keep = max(keep, 0)
    with open(path, "rb+") as f:
        f.truncate(keep)
    return keep
