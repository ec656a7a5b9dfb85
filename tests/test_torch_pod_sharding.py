"""The pod-sharded executor (``pod_sharded``) on a 2 x 2 mesh of gloo ranks.

Four CPU ranks (``sharding.ranks.RankPool``, one torch thread each, a
``file://`` store in the test's temporary directory) run
``FedEngine(..., mesh=make_pod_mesh(2, 2, device="cpu"))``, every rank the
same engine from the same seed (``sharding.ranks.run_engine``): the tables
and the static client arrays live in pod shards, the cohort's rows come by
the owner-keyed fetch, the ghost rows by the gated all-to-all, the fresh
rows go back by the two-stage write-back.

Held, per the reference's contract (``tests/test_pod_sharding.py``):

* pod-sharded against client-sharded on the same four ranks with the
  pairwise merge (the same per-rank partial sums in the same fixed tree):
  history, params and K-row tables bit for bit, fp32 and at the int8 wire;
* against the fused run every discrete column exact, test_acc within the
  whole-run tier's band (ROADMAP, North star): with four ranks the merge's
  sum runs in another order than the fused one's, and AdamW carries a
  last-bit difference into every later round (the reference cannot hold
  its own 1-device mesh to allclose on this tree, ROADMAP C). After one
  round the tables are the fused run's bits, a ragged cohort's dummy
  included;
* the sync gate (tau0 8, J 4: round 1's gate off): an off round moves
  no ghost byte, and each round's collectives, calls and bytes, are those
  of ``sharding.ledger.round_collectives`` on the reference's ledger;
* empty pods (3 clients over 4 pods) and the eligibility chain with the
  reference's reasons (its own methods run on the port engine's
  configuration).
"""
from types import SimpleNamespace

import numpy as np
import pytest

from repro.api import FedAvg as JFedAvg
from repro.api import FedEngine as JEngine
from repro_torch.federated.partition import ghost_exchange_buckets, partition_graph
from repro_torch.graph.data import make_dataset
from repro_torch.sharding import ledger
from repro_torch.sharding.ranks import RankPool, run_engine

EXACT_KEYS = ("tau", "comm_total", "comm_embed", "flops", "wall_clock")
ACC_ROUND, ACC_FINAL = 0.1, 0.05      # the whole-run tier (test_torch_engine.py)
DATA = {"dataset": {"name": "pubmed", "scale": 32, "seed": 0},
        "partition": {"n_clients": 8, "alpha": 0.5, "seed": 0}}


def spec(m=4, rounds=4, mesh=(2, 2), tau0=4, data=DATA, **engine):
    kw = dict(rounds=rounds, clients_per_round=m, seed=0, eval_every=2,
              train_backend="spmm", eval_backend="spmm")
    kw.update(engine)
    return dict(data, method={"name": "fedais", "tau0": tau0}, mesh=mesh, engine=kw)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(4, device="cpu", store_dir=str(tmp_path_factory.mktemp("ranks"))) as p:
        yield p


def run(pool, s):
    outs = pool.run(run_engine, s)
    for o in outs[1:]:
        for k, v in outs[0]["params"].items():
            assert np.array_equal(o["params"][k], v), k
    return outs[0]


def assert_bit_equal(a, b):
    assert a["history"] == b["history"] and a["final"] == b["final"]
    for k, v in a["params"].items():
        assert np.array_equal(b["params"][k], v), k
    for x, y in zip(a["tables"], b["tables"]):
        assert np.array_equal(x, y)


def assert_tier(ref, got):
    assert got["cohorts"] == ref["cohorts"]
    for k in EXACT_KEYS:
        assert got["history"][k] == ref["history"][k], k
    acc = np.asarray(got["history"]["test_acc"]) - np.asarray(ref["history"]["test_acc"])
    assert np.abs(acc).max() <= ACC_ROUND
    assert abs(got["final"]["acc"] - ref["final"]["acc"]) <= ACC_FINAL
    assert np.isfinite(got["history"]["test_loss"]).all()


def assert_ledger(out, fed, n_pods, m_pad, sync_dtype="fp32", merge_reduce="pairwise"):
    b = ghost_exchange_buckets(fed.ghost_owner, fed.ghost_row, fed.ghost_mask, n_pods)
    gates = []
    for r in out["round_log"]:
        led = ledger.pod_placement_ledger(
            b, n_pods=n_pods, cohort_pad=m_pad, wb_cap=r["cap"], n_max=fed.n_max,
            g_max=fed.g_max, n_feat=fed.n_features, n_classes=fed.n_classes, tau=4,
            local_epochs=4, max_deg=fed.max_deg, sync_dtype=sync_dtype)
        want = ledger.round_collectives(led, gate=r["gate"], merge_reduce=merge_reduce,
                                        n_ranks=4)
        assert r["collectives"] == want
        gates.append(r["gate"])
    return gates


@pytest.fixture(scope="module")
def fed():
    return partition_graph(make_dataset("pubmed", scale=32, seed=0), 8, alpha=0.5, seed=0)


@pytest.mark.parametrize("sync_dtype", ["fp32", "int8"])
def test_pod_matches_client_sharded_and_fused(pool, fed, sync_dtype):
    fused = run(pool, spec(mesh=None, sync_dtype=sync_dtype))
    clients = run(pool, spec(mesh="clients", merge_reduce="pairwise", sync_dtype=sync_dtype))
    pods = run(pool, spec(merge_reduce="pairwise", sync_dtype=sync_dtype))
    assert (fused["executor"], clients["executor"], pods["executor"]) == (
        "fused", "sharded_fused", "pod_sharded")
    assert_bit_equal(clients, pods)
    assert_tier(fused, pods)
    assert all(assert_ledger(pods, fed, 2, 4, sync_dtype))


def test_sync_gated_ghost_exchange(pool, fed):
    """tau0 8, J 4: the gate is off in round 1 (the adaptive tau may move
    at the eval of round 2); an off round runs no ghost exchange (zero
    bytes), and the run keeps the fused run's discrete columns."""
    fused = run(pool, spec(mesh=None, tau0=8))
    pods = run(pool, spec(tau0=8, merge_reduce="pairwise"))
    gates = assert_ledger(pods, fed, 2, 4)
    assert gates[:3] == [True, False, True]
    for r in pods["round_log"]:
        moved = sum(b for k, (c, b) in r["collectives"].items() if k.startswith("ghost"))
        assert (moved > 0) == r["gate"]
    assert_tier(fused, pods)


def test_ragged_cohort_and_one_round_tables(pool, fed):
    """m = 3 over 4 ranks pads one dummy (id Kp: no owner pod, it fetches
    zeros and writes nothing back). After one round the K-row tables are
    the fused run's bits; after two, the client-sharded run's."""
    one = [[0, 1]]
    fused = run(pool, dict(spec(m=3, mesh=None), chunks=one))
    pods = run(pool, dict(spec(m=3, merge_reduce="pairwise"), chunks=one))
    assert pods["executor"] == "pod_sharded"
    for a, b in zip(pods["tables"], fused["tables"]):
        assert a.shape == b.shape and np.array_equal(a, b)
    two = [[0, 2]]
    clients = run(pool, dict(spec(m=3, mesh="clients", merge_reduce="pairwise"), chunks=two))
    pods = run(pool, dict(spec(m=3, merge_reduce="pairwise"), chunks=two))
    for a, b in zip(pods["tables"], clients["tables"]):
        assert np.array_equal(a, b)
    assert_ledger(pods, fed, 2, 4)


def test_empty_pods(pool):
    """3 clients over 4 pods: one pod owns only a padding row. Its shard
    sends and receives nothing and the run keeps the fused run's history."""
    data = dict(DATA, partition={"n_clients": 3, "alpha": 0.5, "seed": 1})
    fused = run(pool, spec(m=2, rounds=3, mesh=None, data=data))
    pods = run(pool, spec(m=2, rounds=3, mesh=(4, 1), data=data))
    assert pods["executor"] == "pod_sharded"
    assert_tier(fused, pods)
    assert [t.shape[0] for t in pods["tables"]] == [3, 3, 3, 3]


def _reference(method: str, m: int, **attrs):
    """The reference's own eligibility method on the port engine's
    configuration: a (2, 2) pod mesh, FedAvg, no faults."""
    fake = SimpleNamespace(mesh=SimpleNamespace(shape={"pods": 2, "clients": 2},
                                                devices=np.empty((2, 2))),
                           client_axis="clients", pod_axes=("pods", "clients"),
                           client_sharding="auto", table_sharding="auto",
                           aggregator=JFedAvg(), _faults_active=False, faults=None)
    for k, v in attrs.items():
        setattr(fake, k, v)
    fake._allreduce_unsafe_reason = lambda: JEngine._allreduce_unsafe_reason(fake)
    fake._sharded_faults_unsafe_reason = lambda: JEngine._sharded_faults_unsafe_reason(fake)
    return getattr(JEngine, method)(fake, m)


@pytest.mark.parametrize("m,kw,executor", [
    (4, {}, "pod_sharded"),
    (4, {"table_sharding": "replicated"}, "sharded_fused"),
    (4, {"client_sharding": "off"}, "fused"),
    (3, {"client_sharding": "divisible"}, "fused"),
    (2, {"client_sharding": "divisible"}, "sharded_fused"),
])
def test_eligibility_chain_matches_the_reference(pool, m, kw, executor):
    out = run(pool, spec(m=m, rounds=1, **kw))
    assert out["executor"] == executor
    for name in ("pod_sharded", "sharded"):
        method = f"{name}_eligibility"
        assert out["eligibility"][name] == _reference(method, m, **kw), name
