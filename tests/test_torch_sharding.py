"""The client-sharded executor (``sharded_fused``) on gloo ranks.

``FedEngine(..., mesh=make_client_mesh(device="cpu"))`` runs on every rank
of a CPU world started by ``sharding.ranks.RankPool`` (one world of 1 rank
and one of 2 per module, each rank on one torch thread, joined through a
``file://`` store in the test's temporary directory). Every rank runs the
same engine from the same seed (``sharding.ranks.run_engine``); the
baseline is the port's fused executor, run on a rank too.

The contract is the reference's (``tests/test_sharding.py``): the sharded
run is allclose to the fused one (rtol 1e-4, atol 1e-6 on test_acc and
test_loss) with every discrete column exact. On one rank it is more: the
merge adds the same rows in the same order, so params, tables and history
are the fused run's bits. Ragged cohorts pad with dummies whose write-back
lands nowhere (the ages exact); ``divisible`` mode and a merge that is no
weighted mean fall back, with the reference's reasons (the reference's own
eligibility methods run on the port engine's configuration). The params
end bit-equal on every rank. The whole-run tier against the reference is
in tests/test_torch_sharding_tier.py.
"""
from types import SimpleNamespace

import numpy as np
import pytest

from repro.api import FedEngine as JEngine
from repro.api import StalenessWeightedAggregator as JStaleness
from repro_torch.api import FedEngine
from repro_torch.graph.data import make_dataset
from repro_torch.federated.partition import partition_graph
from repro_torch.sharding.ranks import RankPool, run_engine

EXACT_KEYS = ("tau", "comm_total", "comm_embed", "flops", "wall_clock")
CLOSE_KEYS = ("test_acc", "test_loss")
DATA = {"dataset": {"name": "pubmed", "scale": 32, "seed": 0},
        "partition": {"n_clients": 8, "alpha": 0.5, "seed": 0}}


def spec(m=4, rounds=4, mesh="clients", **engine):
    kw = dict(rounds=rounds, clients_per_round=m, seed=0, eval_every=2,
              train_backend="spmm", eval_backend="spmm")
    kw.update(engine)
    return dict(DATA, method={"name": "fedais", "tau0": 4}, mesh=mesh, engine=kw)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    with RankPool(1, device="cpu", store_dir=str(tmp_path_factory.mktemp("one"))) as one, \
            RankPool(2, device="cpu", store_dir=str(tmp_path_factory.mktemp("two"))) as two:
        yield {1: one, 2: two}


def assert_allclose_history(ref, got):
    for k in EXACT_KEYS:
        assert ref["history"][k] == got["history"][k], f"history[{k!r}] diverged"
    for k in CLOSE_KEYS:
        np.testing.assert_allclose(np.asarray(got["history"][k], np.float64),
                                   np.asarray(ref["history"][k], np.float64),
                                   rtol=1e-4, atol=1e-6, err_msg=f"history[{k!r}]")
    assert got["cohorts"] == ref["cohorts"]


def assert_same_on_every_rank(outs):
    for o in outs[1:]:
        for k, v in outs[0]["params"].items():
            assert np.array_equal(o["params"][k], v), k
        assert o["history"] == outs[0]["history"]


@pytest.mark.parametrize("merge_reduce", ["psum", "pairwise"])
def test_one_rank_is_the_fused_run_bit_for_bit(pools, merge_reduce):
    base = pools[1].run(run_engine, spec(mesh=None))[0]
    got = pools[1].run(run_engine, spec(merge_reduce=merge_reduce))[0]
    assert (base["executor"], got["executor"]) == ("fused", "sharded_fused")
    assert got["history"] == base["history"] and got["final"] == base["final"]
    for k, v in base["params"].items():
        assert np.array_equal(got["params"][k], v), k
    for a, b in zip(got["tables"], base["tables"]):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("merge_reduce,aggregator", [("psum", "fedavg"),
                                                     ("pairwise", "fedavg"),
                                                     ("psum", "weighted")])
def test_two_ranks_match_the_fused_run(pools, merge_reduce, aggregator):
    base = pools[2].run(run_engine, spec(mesh=None, aggregator=aggregator))[0]
    outs = pools[2].run(run_engine, spec(merge_reduce=merge_reduce, aggregator=aggregator))
    assert all(o["executor"] == "sharded_fused" for o in outs)
    assert_allclose_history(base, outs[0])
    assert_same_on_every_rank(outs)
    # one merge all-reduce (or gather) and one write-back gather a round
    tag = "merge_allreduce" if merge_reduce == "psum" else "merge_all_gather"
    for r in outs[0]["round_log"]:
        assert sorted(r["collectives"]) == sorted([tag, "wb_all_gather"])


def test_ragged_cohort_pads_a_dummy(pools):
    """m = 3 over 2 ranks pads one zero-weight dummy: the tables after a
    chunk are the fused run's, the ages (ints) exactly, so a stray dummy
    write-back to any row would show."""
    base = pools[2].run(run_engine, dict(spec(m=3, mesh=None), chunks=[[0, 2]]))[0]
    outs = pools[2].run(run_engine, dict(spec(m=3), chunks=[[0, 2]]))
    assert outs[0]["executor"] == "sharded_fused"
    assert np.array_equal(outs[0]["tables"][1], base["tables"][1])
    for a, b in zip(outs[0]["tables"], base["tables"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-3)
    assert_same_on_every_rank(outs)


def _reference_reason(method: str, out: dict, m: int, **attrs):
    """The reference's own eligibility method, run on the port engine's
    configuration (a (2,) client mesh)."""
    fake = SimpleNamespace(mesh=SimpleNamespace(shape={"clients": 2},
                                                devices=np.empty(2)),
                           client_axis="clients", pod_axes=None, client_sharding="auto",
                           table_sharding="auto", aggregator=None, _faults_active=False,
                           faults=None)
    for k, v in attrs.items():
        setattr(fake, k, v)
    fake._allreduce_unsafe_reason = lambda: JEngine._allreduce_unsafe_reason(fake)
    fake._sharded_faults_unsafe_reason = lambda: JEngine._sharded_faults_unsafe_reason(fake)
    return getattr(JEngine, method)(fake, m)


def test_fallbacks_and_their_reasons_match_the_reference(pools):
    """``divisible`` with a ragged cohort runs fused; a merge that is no
    weighted mean (the staleness aggregator) runs stepwise; the verdicts
    and reasons are the reference's."""
    from repro.api import FedAvg as JFedAvg

    outs = pools[2].run(run_engine, spec(m=3, rounds=2, client_sharding="divisible"))
    got = outs[0]
    assert got["executor"] == "fused"
    want = _reference_reason("sharded_eligibility", got, 3, client_sharding="divisible",
                             aggregator=JFedAvg())
    assert got["eligibility"]["sharded"] == want and not want[0] and "divide" in want[1]
    assert got["eligibility"]["pod_sharded"] == _reference_reason(
        "pod_sharded_eligibility", got, 3, client_sharding="divisible", aggregator=JFedAvg())
    outs = pools[2].run(run_engine, spec(m=4, rounds=2, aggregator="staleness"))
    got = outs[0]
    assert got["executor"] == "stepwise" and not got["eligibility"]["fused"][0]
    want = _reference_reason("sharded_eligibility", got, 4, aggregator=JStaleness())
    assert got["eligibility"]["sharded"] == want and "allreduce_safe" in want[1]
    assert_same_on_every_rank(outs)


@pytest.fixture(scope="module")
def port_graph():
    g = make_dataset("pubmed", scale=64, seed=0)
    return g, partition_graph(g, 4, alpha=0.5, seed=0)


def test_engine_validates_the_mesh_options(port_graph):
    """The reference's validation, and the port's own: the mesh's ranks
    must run on the engine's device."""
    g, fed = port_graph
    clients = SimpleNamespace(mesh_dim_names=("clients",), device_type="cpu")
    for kw, match in ((dict(client_sharding="sometimes"), "client_sharding"),
                      (dict(table_sharding="sometimes"), "table_sharding"),
                      (dict(merge_reduce="magic"), "merge_reduce"),
                      (dict(mesh=clients, table_sharding="pods"), "pods"),
                      (dict(mesh=SimpleNamespace(mesh_dim_names=("a", "b"),
                                                 device_type="cpu")), "clients"),
                      (dict(mesh=SimpleNamespace(mesh_dim_names=("clients",),
                                                 device_type="cuda")), "device")):
        with pytest.raises(ValueError, match=match):
            FedEngine(g, fed, "fedais", rounds=1, device="cpu", **kw)
    eng = FedEngine(g, fed, "fedais", rounds=1, device="cpu")
    assert eng.sharded_eligibility() == (False, "no mesh configured")
    assert eng.pod_sharded_eligibility() == (False, "no mesh configured")


def test_meshes_need_a_process_group():
    from repro_torch.sharding.fed import make_client_mesh
    from repro_torch.sharding.tables import make_pod_mesh

    with pytest.raises(RuntimeError, match="process group"):
        make_client_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        make_pod_mesh(1, 1, device="cpu")
    with pytest.raises(ValueError, match="n_pods"):
        make_pod_mesh(0)
