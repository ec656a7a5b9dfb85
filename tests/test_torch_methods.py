"""FedSage+ and FedGraph, whole runs of the port against the reference.

``FedEngine(g, fed, m, rounds=3, clients_per_round=4)`` on ``small_fed``
for ``m`` in (``fedsage+``, ``fedgraph``): both engines start from the
reference's initial GCN params (and, for FedSage+, its generator params,
assigned to ``engine.strategy.gen_params`` after ``init_state``), the port
draws from the reference's key chain (``test_torch_fedais.JaxDraws``) and
runs both its gather and spmm training backends; the reference runs
gather. Held at the whole-run tier (``test_torch_engine``): identical
cohorts, round/tau/flops exact, comm columns exact in round 0 and within
1% after, test_acc within 0.1 a round and 0.05 at the end. FedGraph's
fanouts are held exact too: in three rounds every arm a client picks is
exploratory or its first greedy pick (a bandit's greedy choice could flip
on a near-tie of rewards, which differ by AdamW's amplified rounding).
"""
import jax
import numpy as np
import pytest

from repro.api import FedEngine as JEngine
from repro.federated import baselines as JB
from repro_torch.api import FedEngine
from repro_torch.convert import params_from_numpy
from repro_torch.federated.baselines import FANOUT_ACTIONS
from repro_torch.federated.partition import partition_graph
from repro_torch.graph.data import make_dataset
from test_torch_async import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_engine import JRecording, TRecording, assert_whole_run_tier
from test_torch_fedais import JaxDraws, _init_params

ROUNDS, M = 3, 4
METHODS = ("fedsage+", "fedgraph")


def _record_fanouts(eng, log):
    real = eng.strategy.choose_fanouts

    def choose(engine, sel):
        out = real(engine, sel)
        log.append(np.asarray(out).tolist())
        return out

    eng.strategy.choose_fanouts = choose


@pytest.fixture(scope="module", params=METHODS)
def reference(request, small_fed):
    g, fed = small_fed
    sel, fanouts = JRecording(), []
    eng = JEngine(g, fed, request.param, rounds=ROUNDS, clients_per_round=M, seed=0,
                  selector=sel)
    _record_fanouts(eng, fanouts)
    return request.param, eng.run(), sel.cohorts, fanouts


@pytest.fixture(scope="module")
def port_fed():
    g = make_dataset("pubmed", scale=32, seed=0)
    return g, partition_graph(g, 8, alpha=0.5, seed=0)


@pytest.mark.parametrize("backend", ["gather", "spmm"])
def test_method_whole_run_matches(reference, port_fed, backend):
    method, ref, ref_cohorts, ref_fanouts = reference
    g, fed = port_fed
    sel, fanouts = TRecording(), []
    eng = FedEngine(g, fed, method, rounds=ROUNDS, clients_per_round=M, seed=0,
                    selector=sel, train_backend=backend, eval_backend=backend,
                    device="cpu")
    state = eng.init_state(params=params_from_numpy(_init_params(fed), "cpu"),
                           draws=JaxDraws(0))
    if method == "fedsage+":
        gp = JB.generator_init(jax.random.PRNGKey(eng.seed + 2), fed.n_features)
        eng.strategy.gen_params = params_from_numpy(
            {k: np.asarray(v) for k, v in gp.items()}, "cpu")
    _record_fanouts(eng, fanouts)
    got = eng.run(state)
    assert_whole_run_tier(got, ref, sel.cohorts, ref_cohorts)
    assert np.isfinite(got.history["test_loss"]).all()
    assert fanouts == ref_fanouts
    if method == "fedsage+":
        # no embedding sync: the generator imputes the ghosts, and its
        # params ride the model link
        assert got.history["comm_embed"] == [0.0] * ROUNDS
        assert got.final["comm_model_bytes"] > 0
        assert state.hist.ghost_feat.abs().sum() > 0
    else:
        assert all(f in FANOUT_ACTIONS for row in fanouts for f in row)
        assert int(eng.strategy.bandit.n.sum()) == M * ROUNDS

