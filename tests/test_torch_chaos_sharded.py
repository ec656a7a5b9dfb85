"""``fed_chaos``'s sharded branch (``repro/launch/fed_chaos.py:276-300``) on
two gloo ranks.

``run_sharded_rows`` runs on every rank of a CPU world
(``sharding.ranks.RankPool``): the quick matrix's federation through
``FedEngine(mesh=...)`` on a ``("clients",)`` mesh over both ranks, a
fault-free baseline and the reference's dropout + straggler scenario. Each
row shows no crash, the ``sharded_fused`` executor, finite params, drops
counted and an accuracy delta within the harness's 0.30 bound; both ranks
report the same rows. On one rank ``run_matrix`` prints one line that it
skips the branch.
"""
import pytest

from repro_torch.launch import fed_chaos
from repro_torch.sharding.ranks import RankPool


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    args = fed_chaos.build_args(["--quick", "--device", "cpu"])
    g, fed = fed_chaos._dataset(args)
    with RankPool(2, device="cpu", store_dir=str(tmp_path_factory.mktemp("ranks"))) as pool:
        return args, pool.run(fed_chaos.run_sharded_rows, g, fed, args)


def test_sharded_rows(rows):
    args, out = rows
    (got, crashes), (other, other_crashes) = out
    assert crashes == other_crashes == 0
    assert [r["scenario"] for r in got] == ["baseline", "drop0.3+strag0.25x4"]
    for r in got:
        assert r["scheduler"] == "sync_sharded" and r["executor"] == "sharded_fused"
        assert not r["crashed"] and r["params_finite"]
        assert r["rounds_completed"] == args.rounds
        assert abs(r["acc_delta"]) <= args.acc_bound
    base, drop = got
    assert base["faults"]["n_dropped"] == 0 and drop["faults"]["n_dropped"] > 0
    assert drop["baseline_acc"] == base["final_acc"]
    for a, b in zip(got, other):
        assert {k: v for k, v in a.items() if k != "error"} == \
            {k: v for k, v in b.items() if k != "error"}


def test_one_rank_skips_the_branch(monkeypatch, capsys):
    args = fed_chaos.build_args(["--quick", "--device", "cpu", "--scale", "64",
                                 "--clients", "2"])
    monkeypatch.setattr(fed_chaos, "_schedulers", lambda a: {})
    assert fed_chaos.run_matrix(args) == ([], 0)
    out = capsys.readouterr().out.strip().splitlines()
    assert out == ["# sync_sharded: not run, one rank (the client-sharded executor needs "
                   "two or more: torchrun --nproc-per-node N)"]
