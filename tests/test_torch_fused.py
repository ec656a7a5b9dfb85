"""The port's fused executor against its stepwise executor and against the
reference's fused executor.

The contract is the reference's (``tests/test_fused.py``): the fused
executor gives the stepwise history bit for bit. On the CPU the fused
round runs eagerly, the same body the card captures as a CUDA graph. Runs
use ``train_backend="spmm"``: its CPU backward sums in a fixed order, so
two runs of one computation agree to the bit. Eligibility verdicts and
reasons, the chunk plan (the rounds of each chunk) and the refusal of a
forced fused run are held against the reference's for the same components;
a whole fused run against the reference's fused run at the whole-run tier
(ROADMAP, North star) with multi-round chunks.
"""
import numpy as np
import pytest
import torch

import repro.api as japi
from repro_torch import api
from repro_torch.convert import params_from_numpy
from repro_torch.core.fedais import TorchDraws
from repro_torch.federated.partition import partition_graph
from repro_torch.graph.data import make_dataset
from test_torch_async import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_engine import JRecording, TRecording, assert_whole_run_tier
from test_torch_fedais import JaxDraws, _init_params

PARITY_KEYS = ("test_acc", "test_loss", "tau", "comm_total", "comm_embed",
               "flops", "wall_clock")
FUSABLE = ("fedall", "fedrandom", "fedpns", "fedlocal", "fedais1", "fedais2")


@pytest.fixture(scope="module")
def port_fed():
    g = make_dataset("pubmed", scale=32, seed=0)
    return g, partition_graph(g, 8, alpha=0.5, seed=0)


def run(port_fed, method, fused, **kw):
    g, fed = port_fed
    eng = api.FedEngine(g, fed, method, seed=0, device="cpu", train_backend="spmm",
                        eval_backend="spmm", scheduler=api.SyncScheduler(fused=fused), **kw)
    state = eng.init_state()
    return eng, state, eng.run(state)


def assert_bit_parity(step, fused):
    for k in PARITY_KEYS:
        assert step.history[k] == fused.history[k], f"history[{k!r}] diverged"
    assert step.final == fused.final


def assert_same_state(a, b):
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    for name in ("hist1", "age", "ghost_feat"):
        assert torch.equal(getattr(a.hist, name), getattr(b.hist, name)), name
    assert torch.equal(a.prev_loss, b.prev_loss)


def test_fused_matches_stepwise_fedais(port_fed):
    """Multi-round chunks (eval_every=2): the history, the params and every
    table to the bit."""
    kw = dict(rounds=5, clients_per_round=3, eval_every=2)
    e1, s1, step = run(port_fed, api.method_config("fedais", tau0=4), False, **kw)
    e2, s2, fused = run(port_fed, api.method_config("fedais", tau0=4), None, **kw)
    assert (e1.last_executor, e2.last_executor) == ("stepwise", "fused")
    assert_bit_parity(step, fused)
    assert_same_state(s1, s2)


@pytest.mark.parametrize("method", FUSABLE)
def test_fused_matches_stepwise_each_method(port_fed, method):
    kw = dict(rounds=3, clients_per_round=3, eval_every=2)
    _, s1, step = run(port_fed, api.method_config(method, tau0=4), False, **kw)
    eng, s2, fused = run(port_fed, api.method_config(method, tau0=4), None, **kw)
    assert eng.last_executor == "fused"
    assert_bit_parity(step, fused)
    assert_same_state(s1, s2)


@pytest.mark.parametrize("method", ["fedsage+", "fedgraph"])
def test_host_hook_methods_run_stepwise(port_fed, method):
    """Per-round host hooks make a strategy ineligible: ``fused=None`` runs
    stepwise, with the forced-stepwise history."""
    kw = dict(rounds=2, clients_per_round=2)
    _, _, step = run(port_fed, method, False, **kw)
    eng, _, auto = run(port_fed, method, None, **kw)
    assert eng.last_executor == "stepwise"
    assert_bit_parity(step, auto)


def test_fused_matches_stepwise_weighted_and_early_stop(port_fed):
    kw = dict(rounds=6, clients_per_round=3, eval_every=3, target_acc=0.2)
    mcfg = api.method_config("fedais", aggregator="weighted")
    g, fed = port_fed
    res = []
    for fused in (False, True):
        eng = api.FedEngine(g, fed, mcfg, seed=2, device="cpu", train_backend="spmm",
                            eval_backend="spmm", scheduler=api.SyncScheduler(fused=fused),
                            **kw)
        res.append(eng.run())
    assert_bit_parity(*res)
    # the target is met at the first eval: both stop there
    assert res[0].history["round"] == res[1].history["round"] == [0]


def _spy():
    class Spy(api.BaseCallback):
        pass

    class JSpy(japi.BaseCallback):
        pass

    Spy.__name__ = JSpy.__name__ = "Spy"
    return Spy, JSpy


def _components(g, fed, jg, jfed, case):
    """The same components on both sides: (port engine, reference engine)."""
    Spy, JSpy = _spy()
    kw, jkw = {}, {}
    method = "fedais"
    if case in ("fedsage+", "fedgraph"):
        method = case
    elif case == "loss_biased":
        kw["selector"], jkw["selector"] = api.LossBiasedSelector(), japi.LossBiasedSelector()
    elif case in ("spy", "spy_safe"):
        spy, jspy = Spy(), JSpy()
        if case == "spy_safe":
            spy.fused_safe = jspy.fused_safe = True
        kw["callbacks"] = [api.EvalCallback(1), api.HistoryCallback(), spy]
        jkw["callbacks"] = [japi.EvalCallback(1), japi.HistoryCallback(), jspy]
    eng = api.FedEngine(g, fed, method, rounds=1, device="cpu", **kw)
    jeng = japi.FedEngine(jg, jfed, method, rounds=1, **jkw)
    return eng, jeng


@pytest.mark.parametrize("case", ["default", "fedsage+", "fedgraph", "loss_biased", "spy",
                                  "spy_safe"])
def test_eligibility_matches_the_reference(port_fed, small_fed, case):
    eng, jeng = _components(*port_fed, *small_fed, case)
    got, want = eng.fused_eligibility(), jeng.fused_eligibility()
    assert got == want
    assert got[0] == (case in ("default", "spy_safe"))


def test_eligibility_on_cuda_needs_torch_draws(port_fed):
    """The port's own reason: on CUDA a graph replays only a device
    generator's draws (checked on a CPU engine dressed as a CUDA one)."""
    g, fed = port_fed
    eng = api.FedEngine(g, fed, "fedais", rounds=1, device="cpu")
    state = eng.init_state(draws=JaxDraws(0))
    assert eng.fused_eligibility(state) == (True, "")
    eng.device = torch.device("cuda", 0)
    ok, why = eng.fused_eligibility(state)
    assert not ok and "TorchDraws" in why
    state.draws = TorchDraws(0, torch.device("cpu"))
    assert eng.fused_eligibility(state) == (True, "")


def test_forced_fused_raises_when_ineligible(port_fed):
    g, fed = port_fed
    eng = api.FedEngine(g, fed, "fedgraph", rounds=1, clients_per_round=2, device="cpu",
                        scheduler=api.SyncScheduler(fused=True))
    with pytest.raises(ValueError, match="fused executor unavailable: strategy"):
        eng.run()
    assert api.build_scheduler("sync_fused").fused is True


def _chunk_plan(eng, stop_at=None):
    plan = []

    def chunk(state, t0, n):
        plan.append((t0, n))
        return stop_at is not None and t0 + n - 1 >= stop_at

    eng._run_chunk = chunk
    eng.run_fused(None)
    return plan


@pytest.mark.parametrize("eval_every,rounds,stop_at", [(1, 4, None), (2, 7, None),
                                                       (3, 8, None), (3, 8, 4), (2, 5, 0)])
def test_chunk_plan_matches_the_reference(port_fed, small_fed, eval_every, rounds, stop_at):
    """Chunks end at eval rounds (and at a stop), as the reference's
    ``run_fused`` cuts them."""
    g, fed = port_fed
    jg, jfed = small_fed
    eng = api.FedEngine(g, fed, "fedais", rounds=rounds, eval_every=eval_every, device="cpu")
    jeng = japi.FedEngine(jg, jfed, "fedais", rounds=rounds, eval_every=eval_every)
    assert _chunk_plan(eng, stop_at) == _chunk_plan(jeng, stop_at)


def test_tables_update_in_place(port_fed):
    """The fused rounds write the tables where they lie and keep the params
    in one set of buffers for the whole run."""
    g, fed = port_fed
    eng = api.FedEngine(g, fed, "fedais", rounds=6, clients_per_round=3, eval_every=2,
                        device="cpu", train_backend="spmm", eval_backend="spmm")
    state = eng.init_state()
    tables = {n: getattr(state.hist, n) for n in ("hist1", "age", "ghost_feat")}
    tables["prev_loss"] = state.prev_loss
    ptrs = {n: t.data_ptr() for n, t in tables.items()}
    eng._run_chunk(state, 0, 1)
    params = {k: v.data_ptr() for k, v in state.params.items()}
    for t0, n in ((1, 2), (3, 2), (5, 1)):
        eng._run_chunk(state, t0, n)
    assert eng.last_executor == "fused"
    now = {n: getattr(state.hist, n) for n in ("hist1", "age", "ghost_feat")}
    now["prev_loss"] = state.prev_loss
    for n, t in now.items():
        assert t is tables[n] and t.data_ptr() == ptrs[n], n
    assert {k: v.data_ptr() for k, v in state.params.items()} == params
    assert (state.prev_loss.sum(1) != 0).any()


def test_a_failing_fused_round_raises(port_fed, monkeypatch):
    """No fallback: a fused round that fails (on the card, a failed capture
    or replay) raises out of ``run``; the engine never runs the round
    stepwise instead."""
    from repro_torch.api import fused

    def broken(self, *a, **k):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(fused.FusedRounds, "_round", broken)
    g, fed = port_fed
    eng = api.FedEngine(g, fed, "fedais", rounds=2, clients_per_round=2, device="cpu")
    stepwise = []
    monkeypatch.setattr(eng, "run_round", lambda *a: stepwise.append(a))
    with pytest.raises(RuntimeError, match="capture failed"):
        eng.run()
    assert eng.last_executor == "fused" and stepwise == []


def test_executors_interleave_on_one_state(port_fed):
    """A stepwise round between fused chunks rebinds the params; the next
    chunk copies them back into its buffers, and the run stays the
    stepwise run to the bit."""
    g, fed = port_fed
    kw = dict(rounds=4, clients_per_round=3, device="cpu", train_backend="spmm",
              eval_backend="spmm")
    step = api.FedEngine(g, fed, "fedais", scheduler=api.SyncScheduler(fused=False), **kw)
    s1 = step.init_state()
    step.run(s1)
    mixed = api.FedEngine(g, fed, "fedais", **kw)
    s2 = mixed.init_state()
    mixed._run_chunk(s2, 0, 1)
    mixed.run_round(s2, 1)
    mixed._run_chunk(s2, 2, 1)      # an eval every round: chunks of one
    mixed._run_chunk(s2, 3, 1)
    assert mixed.last_executor == "fused"
    assert s1.result.history == s2.result.history
    assert_same_state(s1, s2)


def test_whole_run_matches_the_reference_fused(small_fed, port_fed):
    """Both executors fused, chunks of two rounds (eval_every=2): identical
    cohorts, tau schedule and flops, comm within 1% after round 0, test_acc
    within the whole-run band of ``test_torch_engine``."""
    jg, jfed = small_fed
    rounds, m = 5, 4
    jsel = JRecording()
    jeng = japi.FedEngine(jg, jfed, "fedais", rounds=rounds, clients_per_round=m, seed=0,
                          eval_every=2, selector=jsel)
    ref = jeng.run()
    assert jeng.last_executor == "fused"
    g, fed = port_fed
    sel = TRecording()
    eng = api.FedEngine(g, fed, "fedais", rounds=rounds, clients_per_round=m, seed=0,
                        eval_every=2, selector=sel, train_backend="spmm",
                        eval_backend="spmm", device="cpu")
    state = eng.init_state(params=params_from_numpy(_init_params(fed), "cpu"),
                           draws=JaxDraws(0))
    got = eng.run(state)
    assert eng.last_executor == "fused"
    assert got.history["round"] == [0, 2, 4]
    assert_whole_run_tier(got, ref, sel.cohorts, jsel.cohorts)
    assert np.isfinite(got.history["test_loss"]).all()
