"""The port's chaos harness against the reference's, on the CPU.

* ``validate_bench_faults`` agrees with the reference's on a good payload
  and on each broken one;
* for one ``FaultPlan`` (drops, stragglers and NaN corruption at once) and
  each scheduler, the port's ``run_one`` row equals the reference's in
  executor, rounds completed, crash, finite params and every fault counter
  (the plan's decisions and the async clock are host numpy on both sides),
  and its final accuracy is within the whole-run tier's final band. The
  port's engine starts from the reference's initial params and replays its
  key chain (``test_torch_fedais.JaxDraws``, as ``test_torch_engine.py``):
  with draws of its own, 63 test nodes after a few faulty rounds move by
  up to 0.3;
* ``run_serve_chaos`` at a tiny size restores the step before a torn
  newest checkpoint and falls back to the warm cache on poisoned features,
  which it poisons and restores in place.
"""
import copy
import math

import numpy as np
import pytest

from repro.faults import FaultPlan as JFaultPlan
from repro.federated.partition import partition_graph as jpartition_graph
from repro.graph.data import make_dataset as jmake_dataset
from repro.launch import fed_chaos as jchaos
from repro_torch.api import FedEngine
from repro_torch.convert import params_from_numpy
from repro_torch.faults import FaultPlan
from repro_torch.federated.partition import partition_graph
from repro_torch.graph.data import make_dataset
from repro_torch.launch import fed_chaos
from test_torch_async import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_fedais import JaxDraws, _init_params

ARGV = ["--quick", "--rounds", "3", "--clients", "4", "--cohort", "2"]
PLAN = dict(seed=7, dropout=0.3, straggler_frac=0.25, corrupt=0.2, corrupt_mode="nan")
ACC_FINAL = 0.05        # the whole-run tier's final band (test_torch_engine.py)


@pytest.fixture(scope="module")
def graphs():
    return (make_dataset("pubmed", scale=32, seed=0), jmake_dataset("pubmed", scale=32, seed=0))


def check_row(graphs, scheduler, monkeypatch):
    """The port's ``run_one`` row against the reference's under ``PLAN``."""
    g, jg = graphs
    real_init = FedEngine.init_state

    def init_state(self, params=None, draws=None):
        return real_init(self, params=params_from_numpy(_init_params(self.fed), "cpu"),
                         draws=JaxDraws(self.seed))

    monkeypatch.setattr(FedEngine, "init_state", init_state)
    args = fed_chaos.build_args(ARGV + ["--device", "cpu"])
    jargs = jchaos.build_args(ARGV)
    fed = partition_graph(g, args.clients, alpha=0.5, seed=args.seed)
    jfed = jpartition_graph(jg, jargs.clients, alpha=0.5, seed=jargs.seed)
    row = fed_chaos.run_one(g, fed, args, FaultPlan(**PLAN),
                            fed_chaos._schedulers(args)[scheduler], baseline_acc=0.9)
    jrow = jchaos.run_one(jg, jfed, jargs, JFaultPlan(**PLAN),
                          jchaos._schedulers(jargs)[scheduler], baseline_acc=0.9)
    assert not row["crashed"], row.get("error")
    for k in ("executor", "rounds_completed", "crashed", "params_finite", "faults", "dropout",
              "straggler_frac", "corrupt", "corrupt_mode", "baseline_acc"):
        assert row[k] == jrow[k], k
    assert row["rounds_completed"] == args.rounds and row["params_finite"]
    assert any(row["faults"].values())
    assert abs(row["final_acc"] - jrow["final_acc"]) <= ACC_FINAL
    assert math.isclose(row["acc_delta"], 0.9 - row["final_acc"])


@pytest.mark.parametrize("scheduler", ["sync_fused", "async"])
def test_run_one_row_matches_the_reference(graphs, scheduler, monkeypatch):
    """(The stepwise scheduler's row: ``test_torch_chaos_stepwise.py``, so
    that each file stays near 20 s.)"""
    check_row(graphs, scheduler, monkeypatch)


def test_run_one_reports_a_crash_without_raising(graphs):
    g, _ = graphs
    args = fed_chaos.build_args(ARGV + ["--device", "cpu", "--method", "no-such-method"])
    fed = partition_graph(g, args.clients, alpha=0.5, seed=args.seed)
    row = fed_chaos.run_one(g, fed, args, None, fed_chaos._schedulers(args)["sync_fused"])
    assert row["crashed"] and row["error"] and row["rounds_completed"] == 0


def test_serve_chaos_recovers_the_torn_step_and_falls_back(graphs):
    args = fed_chaos.build_args(ARGV + ["--scale", "64", "--device", "cpu"])
    serve, ckpt = fed_chaos.run_serve_chaos(args)
    assert ckpt == {"torn_step": 2, "recovered_step": 1, "recovered": True}
    assert serve["fresh_fell_back"] and serve["fallback_finite"]
    assert serve["fallback_matches_warm"] and serve["recovered_fresh_ok"]
    assert serve["n_fallbacks"] >= 1 and serve["h1_finite_frac"] == 1.0
    assert set(jchaos._SERVE_KEYS) <= set(serve) and set(jchaos._CKPT_KEYS) <= set(ckpt)


def _good_payload():
    row = {"scenario": "drop0.3", "scheduler": "sync_fused", "executor": "fused_faulty",
           "dropout": 0.3, "straggler_frac": 0.0, "corrupt": 0.0, "corrupt_mode": "nan",
           "baseline_acc": 0.9, "final_acc": 0.85, "acc_delta": 0.05, "rounds_completed": 6,
           "params_finite": True, "crashed": False, "faults": {"n_dropped": 3}}
    base = {**row, "scenario": "baseline", "dropout": 0.0, "final_acc": 0.9,
            "acc_delta": 0.0, "faults": {}}
    return {"bench": "fault_tolerance", "devices": 1, "quick": True, "seed": 0,
            "dataset": "pubmed", "scale": 32, "clients": 8, "rounds": 6, "cohort": 4,
            "method": "fedais", "acc_bound": 0.3, "max_acc_delta": 0.05, "crashes": 0,
            "all_finite": True, "rows": [base, row],
            "serve": {"n_fallbacks": 1, "n_degraded": 0, "n_rejected": 0, "n_shed": 2,
                      "fresh_fell_back": True, "fallback_finite": True,
                      "fallback_matches_warm": True, "h1_finite_frac": 1.0},
            "ckpt": {"torn_step": 2, "recovered_step": 1, "recovered": True}}


def _row(p, **kw):
    p["rows"][1].update(kw)
    return p


BROKEN = {
    "not_a_dict": lambda p: [p],
    "missing_rows": lambda p: {k: v for k, v in p.items() if k != "rows"},
    "bench": lambda p: {**p, "bench": "serve_latency"},
    "devices": lambda p: {**p, "devices": 0},
    "quick": lambda p: {**p, "quick": "yes"},
    "seed": lambda p: {**p, "seed": 0.5},
    "acc_bound": lambda p: {**p, "acc_bound": 0},
    "max_acc_delta_type": lambda p: {**p, "max_acc_delta": "big"},
    "crashes": lambda p: {**p, "crashes": -1},
    "all_finite": lambda p: {**p, "all_finite": 1},
    "rows_empty": lambda p: {**p, "rows": []},
    "row_keys": lambda p: {**p, "rows": [{"scenario": "x"}]},
    "row_rate": lambda p: _row(p, dropout=1.5),
    "row_bool": lambda p: _row(p, crashed=0),
    "row_rounds": lambda p: _row(p, rounds_completed=-1),
    "row_faults": lambda p: _row(p, faults=None),
    "row_acc": lambda p: _row(p, final_acc="high"),
    "crash_count": lambda p: {**p, "crashes": 1},
    "max_delta": lambda p: {**p, "max_acc_delta": 0.2},
    "serve_type": lambda p: {**p, "serve": []},
    "serve_keys": lambda p: {**p, "serve": {"n_fallbacks": 0}},
    "serve_frac": lambda p: {**p, "serve": {**p["serve"], "h1_finite_frac": 2.0}},
    "ckpt_type": lambda p: {**p, "ckpt": 1},
    "ckpt_keys": lambda p: {**p, "ckpt": {"torn_step": 2}},
    "ckpt_recovered": lambda p: {**p, "ckpt": {**p["ckpt"], "recovered": "yes"}},
}


def test_validate_bench_faults_agrees_with_the_reference():
    good = _good_payload()
    assert fed_chaos.validate_bench_faults(good) == jchaos.validate_bench_faults(good) == []
    for name, broken in BROKEN.items():
        bad = broken(copy.deepcopy(good))
        got = fed_chaos.validate_bench_faults(bad)
        assert got == jchaos.validate_bench_faults(bad), name
        assert got, name
    assert np.isfinite(good["max_acc_delta"])
