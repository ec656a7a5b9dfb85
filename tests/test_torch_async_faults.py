"""The async scheduler's fault handling against the reference's: a client
20x slower than its wait budget allows times out, is retried once with a
doubled budget, times out again and is aborted (its slot backfilled with a
fresh client), beside a staleness cap of 0 that evicts late arrivals. The
merge schedule and every counter of ``EngineState.fault_events`` are held
exact (``test_torch_async_schedule.run_both``).
"""
import numpy as np

from test_torch_async_schedule import port_fed, run_both  # noqa: F401  (fixture)
from test_torch_async import one_torch_thread  # noqa: F401  (autouse fixture)


def test_timeouts_retries_aborts_evictions_match_the_reference(small_fed, port_fed):  # noqa: F811
    def make(n):
        return dict(quorum=2, speed_factors=np.where(np.arange(n) == 0, 20.0, 1.0),
                    timeout_s=0.05, max_retries=1, max_staleness=0)

    *_, state, log = run_both(small_fed, port_fed, make, 4, 3)
    ev = state.fault_events
    assert ev.n_timeouts > 0 and ev.n_retries > 0 and ev.n_aborted > 0 and ev.n_evicted > 0
    assert ev.n_timeouts == ev.n_retries + ev.n_aborted
    assert ev.n_lost == ev.n_dropped == ev.n_quarantined == ev.n_empty_merges == 0
    assert all(0 not in sel for sel, _ in log)      # the slow client never merges
