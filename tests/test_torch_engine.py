"""A whole FedAIS run of the port's ``FedEngine`` against the reference's.

``FedEngine(g, fed, "fedais", rounds=6, clients_per_round=4)`` on
``small_fed`` (pubmed scale 32, 8 clients), both engines from the
reference's initial params, the port drawing from the reference's key
chain (``test_torch_fedais.JaxDraws``). The port runs each training
backend; the reference runs gather (its spmm backend's Pallas interpreter
is too slow for six rounds).

The whole-run tier (ROADMAP, North star): identical cohorts, history keys,
tau schedule and flops column. The byte and wall-clock columns are exact
in round 0 and within 1% after: the params the cohort brings back differ
by AdamW's amplified rounding (tests/test_torch_fedais.py), so a node near
a tie in the next round's importance scores can change sides and move a
ghost row, the reference's own tolerance for a change of summation order
(``tests/test_train_backend.py:31``). test_acc stays within 0.1 of the
reference in every round (63 test nodes: 6 of them) and within 0.05 at
the end.
"""
import numpy as np
import pytest

from repro.api import FedEngine as JEngine
from repro.api import UniformSelector as JUniformSelector
from repro_torch.api import FedEngine, UniformSelector
from repro_torch.convert import params_from_numpy
from repro_torch.federated.partition import partition_graph
from repro_torch.graph.data import make_dataset
from test_torch_fedais import JaxDraws, _init_params

ROUNDS, M = 6, 4
COMM_KEYS = ("comm_total", "comm_embed", "wall_clock")
ACC_ROUND, ACC_FINAL = 0.1, 0.05


class _Recording:
    """A selector that keeps the cohorts it drew."""

    def __init__(self):
        self.cohorts = []

    def select(self, engine, state):
        sel = super().select(engine, state)
        self.cohorts.append(np.asarray(sel).tolist())
        return sel


class JRecording(_Recording, JUniformSelector):
    pass


class TRecording(_Recording, UniformSelector):
    pass


@pytest.fixture(scope="module")
def reference(small_fed):
    g, fed = small_fed
    sel = JRecording()
    res = JEngine(g, fed, "fedais", rounds=ROUNDS, clients_per_round=M, seed=0,
                  selector=sel).run()
    return res, sel.cohorts


@pytest.mark.parametrize("backend", ["gather", "spmm"])
def test_whole_run_matches(reference, backend):
    ref, ref_cohorts = reference
    g = make_dataset("pubmed", scale=32, seed=0)
    fed = partition_graph(g, 8, alpha=0.5, seed=0)
    sel = TRecording()
    eng = FedEngine(g, fed, "fedais", rounds=ROUNDS, clients_per_round=M, seed=0,
                    selector=sel, train_backend=backend, eval_backend=backend,
                    device="cpu")
    state = eng.init_state(params=params_from_numpy(_init_params(fed), "cpu"),
                           draws=JaxDraws(0))
    got = eng.run(state)
    assert eng.last_executor == "stepwise"
    assert sel.cohorts == ref_cohorts[:ROUNDS]
    assert set(got.history) == set(ref.history) and set(got.final) == set(ref.final)
    for k in ("round", "tau", "flops"):
        assert got.history[k] == ref.history[k], k
    for k in COMM_KEYS:
        assert got.history[k][0] == ref.history[k][0], k
        np.testing.assert_allclose(got.history[k], ref.history[k], rtol=1e-2, err_msg=k)
    acc, ref_acc = np.asarray(got.history["test_acc"]), np.asarray(ref.history["test_acc"])
    assert np.abs(acc - ref_acc).max() <= ACC_ROUND
    assert abs(got.final["acc"] - ref.final["acc"]) <= ACC_FINAL
    assert np.isfinite(got.history["test_loss"]).all()
    assert got.final["comm_total_bytes"] == got.history["comm_total"][-1]
    # the tables the merges wrote: every client that trained has fresh rows
    trained = sorted({c for cohort in sel.cohorts for c in cohort})
    assert (state.prev_loss[trained] >= 0).all() and (state.prev_loss.sum(1) != 0).any()
