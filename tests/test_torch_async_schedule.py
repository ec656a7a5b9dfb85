"""Whole async runs of the port against the reference's: the merge schedule
and the billing of dispatches that never merged.

Both engines run ``fedais`` on ``small_fed`` under the same
``AsyncScheduler``; the port replays the reference's key chain
(``test_torch_fedais.JaxDraws``) from the reference's initial params. The
event order is host float64 arithmetic on the clients' sizes (the cost
model's compute times), so the schedule — the cohort and the staleness of
every merge — and the fault counters are held exact. Fault handling
(timeouts, retries, aborts, evictions) is in ``test_torch_async_faults.py``.
The work dispatched but never merged is billed: its model bytes, FLOPs and
syncs are held exact against the reference's meters.
"""
import numpy as np
import pytest

import repro.api as japi
from repro_torch.api import AsyncScheduler, FedEngine
from repro_torch.convert import params_from_numpy
from repro_torch.federated.costs import model_bytes
from repro_torch.federated.partition import partition_graph
from repro_torch.graph.data import make_dataset
from test_torch_async import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_fedais import JaxDraws, _init_params


@pytest.fixture(scope="module")
def port_fed():
    g = make_dataset("pubmed", scale=32, seed=0)
    return g, partition_graph(g, 8, alpha=0.5, seed=0)


def _schedule_log(eng):
    """Record each merge's (cohort, staleness)."""
    log = []
    real = eng.merge

    def merge(state, t, sel, out, **kw):
        log.append((np.asarray(sel).tolist(), np.asarray(kw["staleness"]).tolist()))
        return real(state, t, sel, out, **kw)

    eng.merge = merge
    return log


def run_both(small_fed, port_fed, make, rounds, m):
    """The reference's and the port's run under ``AsyncScheduler(**make(K))``:
    ``(ref result, ref state, ref log, result, state, log)``."""
    g, fed = small_fed
    jeng = japi.FedEngine(g, fed, "fedais", rounds=rounds, clients_per_round=m, seed=0,
                          scheduler=japi.AsyncScheduler(**make(fed.n_clients)))
    jlog = _schedule_log(jeng)
    jstate = jeng.init_state()
    ref = jeng.run(jstate)
    tg, tfed = port_fed
    eng = FedEngine(tg, tfed, "fedais", rounds=rounds, clients_per_round=m, seed=0,
                    scheduler=AsyncScheduler(**make(tfed.n_clients)), device="cpu",
                    train_backend="spmm", eval_backend="spmm")
    log = _schedule_log(eng)
    state = eng.init_state(params=params_from_numpy(_init_params(tfed), "cpu"),
                           draws=JaxDraws(0))
    got = eng.run(state)
    assert log == jlog and len(log) == rounds
    assert got.history["merged"] == ref.history["merged"]
    assert got.history["staleness_max"] == ref.history["staleness_max"]
    assert state.fault_events.snapshot() == jstate.fault_events.snapshot()
    assert np.isfinite(got.history["test_loss"]).all()
    assert got.history["virtual_time"] == got.history["wall_clock"]
    return ref, jstate, jlog, got, state, log


def test_heterogeneous_schedule_matches_the_reference(small_fed, port_fed):
    """A partial quorum with log-normal client speeds: stragglers merge
    late, on the reference's schedule."""
    def make(n):
        return dict(quorum=2, speed_factors=np.exp(np.random.default_rng(0).normal(0, 0.8, n)))

    ref, _, _, got, state, log = run_both(small_fed, port_fed, make, 4, 3)
    assert max(got.history["staleness_max"]) >= 1 and not state.fault_events.any()
    # the dispatches still in flight at the end are billed as the
    # reference bills them (model bytes, FLOPs and syncs exact)
    assert got.history["comm_total"][-1] < got.final["comm_total_bytes"]
    for k in ("comm_model_bytes", "compute_flops", "sync_events"):
        assert got.final[k] == ref.final[k], k


def test_async_bills_unmerged_dispatches(port_fed):
    g, fed = port_fed
    eng = FedEngine(g, fed, "fedais", rounds=2, clients_per_round=3, seed=0, device="cpu",
                    scheduler=AsyncScheduler(quorum=2))
    res = eng.run()
    # dispatched 3 + 2, merged 2 + 2
    assert res.final["comm_model_bytes"] == 5 * 2 * model_bytes(eng.n_params)
    assert res.history["comm_total"][-1] < res.final["comm_total_bytes"]
    assert res.history["merged"] == [2, 2]
