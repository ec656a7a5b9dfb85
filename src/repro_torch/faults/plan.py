"""The fault ledger. A copy of ``FaultCounters`` from
``repro/faults/plan.py``; the fault plan and the update guard are still
to port (ROADMAP A6)."""
from __future__ import annotations

from dataclasses import dataclass


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
