"""The async scheduler's fault-plan branch against the reference's.

Under an engine ``FaultPlan`` the async scheduler loses dropped uploads
(counted ``n_lost`` without a timeout; with one they time out, retry with
backoff and are aborted after ``max_retries``), stretches the stragglers'
finish times by ``delay_factors`` and poisons corrupt uploads at dispatch,
which the engine's merge guard quarantines. The event order is host
float64 arithmetic on the clients' sizes, so every merge's cohort and
staleness and every fault counter are held equal to the reference's
(``test_torch_faults.run``, ``jrun``: the same partition, initial params
and draws), and the run ends with finite params. Total dropout ends,
truncated, at the circuit breaker with the params as they started.
"""
import pytest
import torch

import repro.api as japi
import repro.faults as jfaults
from repro_torch import api
from repro_torch.faults import FaultPlan
from test_torch_async import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_faults import jrun, params_finite, run, small4  # noqa: F401  (fixture)

CASES = {
    "drop_no_timeout": (dict(seed=5, dropout=0.5), dict(), 4),
    "timeout_retry_abort": (dict(seed=5, dropout=0.5),
                            dict(timeout_s=5.0, max_retries=1, backoff=2.0), 4),
    # (a merge that the guard empties on an eval round stops the reference's
    # HistoryCallback, np.max of no staleness: ROADMAP C5; this seed's
    # quarantines fall elsewhere)
    "corrupt_stragglers_evict": (dict(seed=7, corrupt=0.3, straggler_frac=0.5),
                                 dict(quorum=2, concurrency=3, max_staleness=0), 5),
    "total_dropout": (dict(seed=5, dropout=1.0), dict(timeout_s=5.0, max_retries=2), 1),
}


@pytest.mark.parametrize("name", list(CASES))
def test_async_faults_match_the_reference(small4, name):  # noqa: F811
    plan, sched, rounds = CASES[name]
    _, jstate, _, jlog = jrun(small4, rounds=rounds, scheduler=japi.AsyncScheduler(**sched),
                              faults=jfaults.FaultPlan(**plan))
    _, state, _, log = run(small4, rounds=rounds, scheduler=api.AsyncScheduler(**sched),
                           faults=FaultPlan(**plan))
    assert log == jlog
    ev = state.fault_events
    assert ev.snapshot() == jstate.fault_events.snapshot()
    assert params_finite(state)
    if name == "drop_no_timeout":
        assert ev.n_lost > 0 and ev.n_timeouts == 0
    elif name == "timeout_retry_abort":
        assert ev.n_timeouts > 0 and ev.n_retries > 0 and ev.n_aborted > 0 and ev.n_lost == 0
        assert ev.n_timeouts == ev.n_retries + ev.n_aborted
        assert state.round + 1 == rounds          # the run still completed
    elif name == "corrupt_stragglers_evict":
        assert ev.n_quarantined > 0 and ev.n_evicted > 0
    else:
        assert ev.n_timeouts > 0 and log == []
        _, fresh, _, _ = run(small4, rounds=0)
        for k in state.params:
            assert torch.equal(state.params[k], fresh.params[k]), k
