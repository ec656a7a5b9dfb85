"""Fault injection and the update guard: the port against the reference's
``repro.faults`` and its own executors against each other.

The reference's contracts (``tests/test_faults.py``), held on the port:

* ``FaultPlan``'s decisions are the reference's for every seed, round and
  client (host numpy streams with the same salts); ``guard_mask`` and
  ``corrupt_params_stack`` agree on the same numpy inputs;
* an empty plan and an all-pass guard change nothing, bit for bit, through
  the stepwise, fused and async executors;
* under drops, corruption (each mode) and stragglers, the fault counters
  and the merged cohorts are the reference's for the same seed, and the
  fault-aware fused executor (``fused_faulty``) gives the faulty stepwise
  history, params and tables to the bit (the reference holds its floats to
  allclose there: its masked merge sums interleaved zeros, the port's
  moves the survivors to the front);
* nothing is silently averaged in: poisoned updates are quarantined, a
  cohort with no survivor is a server no-op round, and the guard switched
  off lets the poison through.

The port runs on ``small4`` (pubmed scale 32, 4 clients, the reference's
fixture) from the reference's initial params, drawing from the reference's
key chain (``test_torch_fedais.JaxDraws``), so both sides train the same
batches. The async scheduler's plan branch is in ``test_torch_faults_async.py``.
"""
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.faults as jfaults
from repro.federated.partition import partition_graph as jpartition_graph
from repro.graph.data import make_dataset as jmake_dataset
from repro_torch import api
from repro_torch.convert import params_from_numpy
from repro_torch.faults import (
    CORRUPT_MODES,
    FaultCounters,
    FaultPlan,
    UpdateGuard,
    corrupt_params_stack,
    guard_mask,
    tear_file,
)
from repro_torch.federated.partition import partition_graph
from repro_torch.graph.data import make_dataset
from test_torch_async import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_fedais import JaxDraws, _init_params
from test_torch_fused import assert_same_state

ROUNDS, COHORT = 4, 2


@pytest.fixture(scope="module")
def small4():
    """(port graph, port partition, reference graph, reference partition)."""
    g = make_dataset("pubmed", scale=32, seed=0)
    jg = jmake_dataset("pubmed", scale=32, seed=0)
    return (g, partition_graph(g, 4, alpha=0.5, seed=0), jg,
            jpartition_graph(jg, 4, alpha=0.5, seed=0))


def _merge_log(eng):
    """Record the cohort each merge receives (after the plan's drops) and,
    from the async scheduler, its staleness."""
    log = []
    real = eng.merge

    def merge(state, t, sel, out, **kw):
        staleness = kw.get("staleness")
        log.append((np.asarray(sel).tolist(),
                    None if staleness is None else np.asarray(staleness).tolist()))
        return real(state, t, sel, out, **kw)

    eng.merge = merge
    return log


def run(small4, *, fused=False, rounds=ROUNDS, m=COHORT, scheduler=None, **kw):
    g, fed = small4[:2]
    eng = api.FedEngine(g, fed, "fedais", rounds=rounds, clients_per_round=m, seed=0,
                        eval_every=2, device="cpu", train_backend="spmm",
                        eval_backend="spmm",
                        scheduler=scheduler or api.SyncScheduler(fused=fused), **kw)
    log = _merge_log(eng)
    state = eng.init_state(params=params_from_numpy(_init_params(fed), "cpu"),
                           draws=JaxDraws(0))
    return eng, state, eng.run(state), log


def jrun(small4, *, rounds=ROUNDS, m=COHORT, scheduler=None, **kw):
    jg, jfed = small4[2:]
    eng = japi.FedEngine(jg, jfed, "fedais", rounds=rounds, clients_per_round=m, seed=0,
                         eval_every=2, scheduler=scheduler or japi.SyncScheduler(fused=False),
                         **kw)
    log = _merge_log(eng)
    state = eng.init_state()
    return eng, state, eng.run(state), log


def assert_history_equal(a, b):
    assert set(a.history) == set(b.history)
    for k in a.history:
        assert a.history[k] == b.history[k], k
    assert a.final == b.final


def params_finite(state) -> bool:
    return all(bool(torch.isfinite(v).all()) for v in state.params.values())


# ---------------------------------------------------------------------------
# the plan and the guard against the reference's
# ---------------------------------------------------------------------------

def test_plan_validation_matches_the_reference():
    for kw, word in (({"dropout": 1.5}, "dropout"), ({"corrupt_mode": "martian"},
                                                      "corrupt_mode"),
                     ({"straggler_mult": 0.5}, "straggler_mult"),
                     ({"torn_write": -0.1}, "torn_write")):
        with pytest.raises(ValueError, match=word):
            FaultPlan(**kw)
        with pytest.raises(ValueError, match=word):
            jfaults.FaultPlan(**kw)
    assert CORRUPT_MODES == jfaults.CORRUPT_MODES
    for kw in ({}, {"dropout": 0.1}, {"dropout": 0.4, "corrupt": 0.2, "corrupt_mode": "inf"},
               {"straggler_frac": 0.25, "straggler_mult": 3.0, "torn_write": 0.5}):
        a, b = FaultPlan(**kw), jfaults.FaultPlan(**kw)
        assert (a.empty, a.describe(), a.snapshot()) == (b.empty, b.describe(), b.snapshot())
    for mode in CORRUPT_MODES:
        a = FaultPlan(corrupt_mode=mode, corrupt_scale=42.0).corrupt_value()
        b = jfaults.FaultPlan(corrupt_mode=mode, corrupt_scale=42.0).corrupt_value()
        assert a == b or (np.isnan(a) and np.isnan(b))


@pytest.mark.parametrize("seed", [0, 3, 7, 12345])
def test_plan_decisions_match_the_reference(seed):
    kw = dict(seed=seed, dropout=0.35, corrupt=0.3, straggler_frac=0.4,
              straggler_mult=5.0, torn_write=0.2)
    a, b = FaultPlan(**kw), jfaults.FaultPlan(**kw)
    clients = np.arange(40)
    for t in range(12):
        sel = np.random.default_rng(seed + t).choice(40, size=7, replace=False)
        np.testing.assert_array_equal(a.drops(t, sel), b.drops(t, sel))
        np.testing.assert_array_equal(a.corruptions(t, sel), b.corruptions(t, sel))
        assert a.tears_write(t) == b.tears_write(t)
    np.testing.assert_array_equal(a.stragglers(clients), b.stragglers(clients))
    np.testing.assert_array_equal(a.delay_factors(clients), b.delay_factors(clients))
    assert a.drops(0, clients).any() and a.corruptions(0, clients).any()
    # rate-0 families never fire; rate-1 always fire
    assert not FaultPlan(seed=seed).drops(0, clients).any()
    assert FaultPlan(seed=seed, dropout=1.0).drops(0, clients).all()


def _stack(rng, m=5):
    stack = {"w": rng.standard_normal((m, 6, 4)).astype(np.float32),
             "b": rng.standard_normal((m, 4)).astype(np.float32)}
    ref = {"w": rng.standard_normal((6, 4)).astype(np.float32),
           "b": rng.standard_normal(4).astype(np.float32)}
    return stack, ref


@pytest.mark.parametrize("value", [float("nan"), float("inf"), 1e6, 3.0])
def test_guard_and_corruption_match_the_reference(value):
    rng = np.random.default_rng(1)
    stack, ref = _stack(rng)
    mask = np.array([0, 1, 0, 1, 0], bool)
    t_stack = {k: torch.from_numpy(v) for k, v in stack.items()}
    t_ref = {k: torch.from_numpy(v) for k, v in ref.items()}
    got = corrupt_params_stack(t_stack, mask, value)
    want = jfaults.corrupt_params_stack(stack, mask, value)
    for k in stack:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        # the rows multiplied by 1.0 are as they were
        np.testing.assert_array_equal(got[k].numpy()[~mask], stack[k][~mask])
    want_np = {k: np.asarray(v) for k, v in want.items()}
    for max_norm in (None, 1e3, 5.0):
        ok = guard_mask(got, t_ref, max_norm)
        np.testing.assert_array_equal(ok, jfaults.guard_mask(want_np, ref, max_norm))
    # non-finite poison fails the finite check alone; a finite blow-up
    # needs the norm ceiling
    finite = np.isfinite(value)
    assert guard_mask(got, t_ref, None).tolist() == [True, finite, True, finite, True]
    if value == 1e6:
        assert guard_mask(got, t_ref, 1e3).tolist() == [True, False, True, False, True]


def test_counters_snapshot():
    c = FaultCounters()
    assert not c.any()
    c.n_dropped = 3
    assert c.any() and c.snapshot()["n_dropped"] == 3
    assert c.snapshot().keys() == jfaults.FaultCounters().snapshot().keys()


def test_tear_file(tmp_path):
    p = tmp_path / "ckpt.bin"
    p.write_bytes(bytes(range(200)))
    assert tear_file(str(p)) == 100 and p.read_bytes() == bytes(range(100))
    assert tear_file(str(p), keep_frac=1.0) == 99      # at least a byte goes
    q = tmp_path / "ref.bin"
    q.write_bytes(bytes(range(99)))
    assert jfaults.tear_file(str(q), keep_frac=0.3) == tear_file(str(p), keep_frac=0.3)
    assert p.read_bytes() == q.read_bytes()


# ---------------------------------------------------------------------------
# the inertness contract: empty plans and all-pass guards change nothing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("executor", ["stepwise", "fused", "async"])
def test_empty_plan_and_open_guard_are_inert(small4, executor):
    def go(**kw):
        if executor == "async":
            kw["scheduler"] = api.AsyncScheduler()
        eng, state, res, _ = run(small4, fused=executor == "fused" or False, **kw)
        # the async scheduler drives dispatch and merge itself
        assert eng.last_executor == (None if executor == "async" else executor)
        return state, res

    s0, r0 = go()
    for kw in ({"faults": FaultPlan()}, {"guard": False}, {"guard": None},
               {"guard": UpdateGuard(max_norm=1e9)}):
        s1, r1 = go(**kw)
        assert_history_equal(r0, r1)
        assert_same_state(s0, s1)
        assert not s1.fault_events.any()


# ---------------------------------------------------------------------------
# faults: the reference's counters and cohorts, fused = stepwise to the bit
# ---------------------------------------------------------------------------

SCENARIOS = {
    "drop_corrupt_nan": dict(plan=dict(seed=7, dropout=0.35, corrupt=0.3)),
    "corrupt_inf": dict(plan=dict(seed=2, corrupt=1.0, corrupt_mode="inf")),
    "scale_norm_ceiling": dict(plan=dict(seed=2, corrupt=0.5, corrupt_mode="scale"),
                               guard=1e3),
    "drop_stragglers_weighted": dict(plan=dict(seed=7, dropout=0.4, straggler_frac=0.5),
                                     aggregator="weighted"),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_faulty_runs_match_the_reference_and_each_other(small4, name):
    sc = SCENARIOS[name]
    kw, jkw = {}, {}
    if "guard" in sc:
        kw["guard"] = UpdateGuard(max_norm=sc["guard"])
        jkw["guard"] = jfaults.UpdateGuard(max_norm=sc["guard"])
    if "aggregator" in sc:
        kw["aggregator"] = jkw["aggregator"] = sc["aggregator"]
    _, js, jres, jlog = jrun(small4, faults=jfaults.FaultPlan(**sc["plan"]), **jkw)
    _, s1, r1, log1 = run(small4, faults=FaultPlan(**sc["plan"]), **kw)
    e2, s2, r2, log2 = run(small4, fused=None, faults=FaultPlan(**sc["plan"]), **kw)
    assert e2.last_executor == "fused_faulty" and log2 == []
    want = js.fault_events.snapshot()
    assert s1.fault_events.snapshot() == s2.fault_events.snapshot() == want
    assert s1.fault_events.any()
    assert log1 == jlog and len(log1) == ROUNDS
    assert r1.history["tau"] == jres.history["tau"]
    # fused_faulty = faulty stepwise, to the bit
    assert_history_equal(r1, r2)
    assert_same_state(s1, s2)
    assert params_finite(s1)
    if "straggler_frac" in sc["plan"]:
        # stragglers stretch the billed wall clock by the reference's rule
        assert r1.history["wall_clock"][0] == jres.history["wall_clock"][0]
        np.testing.assert_allclose(r1.history["wall_clock"], jres.history["wall_clock"],
                                   rtol=1e-2)


@pytest.mark.parametrize("fused", [False, None], ids=["stepwise", "fused"])
@pytest.mark.parametrize("kind", ["all_dropped", "all_nan", "all_scaled"])
def test_no_survivor_rounds_are_noops(small4, fused, kind):
    plan, kw = {"all_dropped": (FaultPlan(seed=1, dropout=1.0), {}),
                "all_nan": (FaultPlan(seed=2, corrupt=1.0), {}),
                "all_scaled": (FaultPlan(seed=2, corrupt=1.0, corrupt_mode="scale"),
                               {"guard": UpdateGuard(max_norm=1e3)})}[kind]
    eng, state, _, _ = run(small4, fused=fused, faults=plan, **kw)
    _, fresh, _, _ = run(small4, rounds=0)
    for k in state.params:
        assert torch.equal(state.params[k], fresh.params[k]), k
    ev = state.fault_events
    if kind == "all_dropped":
        assert ev.n_dropped == ROUNDS * COHORT
    else:
        assert ev.n_quarantined == ROUNDS * COHORT
    assert ev.n_empty_merges == ROUNDS
    assert params_finite(state)


@pytest.mark.parametrize("fused", [False, None], ids=["stepwise", "fused"])
def test_guard_off_lets_poison_through(small4, fused):
    plan = FaultPlan(seed=2, corrupt=1.0, corrupt_mode="nan")
    eng, state, _, _ = run(small4, fused=fused, faults=plan, guard=False)
    assert eng.last_executor == ("fused_faulty" if fused is None else "stepwise")
    assert state.fault_events.n_quarantined == 0
    assert not params_finite(state)
    # the finite-only default guard lets a finite blow-up through
    _, loose, _, _ = run(small4, fused=fused,
                         faults=FaultPlan(seed=2, corrupt=1.0, corrupt_mode="scale"))
    assert max(float(v.abs().max()) for v in loose.params.values()) > 1e3


def test_custom_merge_rule_takes_stepwise_under_faults(small4):
    """The fault-aware round hardcodes the masked mean: an aggregator that
    does not vouch for a mean-family rule makes a faulty run stepwise, with
    the reference's reason."""
    class Median(api.FedAvg):
        def aggregate(self, stacked, weights=None):
            return {k: v.median(dim=0).values for k, v in stacked.items()}

    class JMedian(japi.FedAvg):
        def aggregate(self, stacked, weights=None):
            return {k: np.median(v, axis=0) for k, v in stacked.items()}

    JMedian.__name__ = "Median"
    g, fed, jg, jfed = small4
    plan = dict(seed=1, dropout=0.5)
    eng = api.FedEngine(g, fed, "fedais", rounds=1, device="cpu", aggregator=Median(),
                        faults=FaultPlan(**plan))
    jeng = japi.FedEngine(jg, jfed, "fedais", rounds=1, aggregator=JMedian(),
                          faults=jfaults.FaultPlan(**plan))
    got = eng.fused_eligibility()
    assert got == jeng.fused_eligibility() and not got[0] and "mean-family" in got[1]
    # without a plan the same aggregator is fusable
    assert api.FedEngine(g, fed, "fedais", rounds=1, device="cpu",
                         aggregator=Median()).fused_eligibility()[0]
