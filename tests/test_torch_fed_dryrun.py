"""The port's fed dry run (``repro_torch.launch.fed_dryrun``) on the CPU.

Held against the reference's ``repro/launch/fed_dryrun.py``:

* its validators (``validate_fed_dryrun``, ``assert_k_flat``,
  ``assert_quant_bytes``) return the reference's problems on the same rows,
  a valid one and one broken per rule;
* ``synthetic_ghost_buckets`` draws the reference's buckets;
* pod rounds walked on meta tensors in a fake 8-rank world at the
  reference's CI widths (n_max 64, g_max 8, F 32; a cohort of 16, for the
  time limit): the rows pass both packages' validators and ``assert_k_flat``
  (K 4,096 against 1,024), their ledgers equal the reference's
  ``pod_placement_ledger`` at the same arguments, each round's counted
  collectives equal ``sharding.ledger.round_collectives`` (the gate-off
  round: no ghost byte), the rank's resident tensors equal the ledger's
  (the round inputs: ``port_round_input_bytes``), and int8 at least halves
  each embedding wire with the residents byte for byte the same;
* the client-sharded round's counts equal ``sharded_round_collectives``;
  a meta walk and a walk on real CPU tensors count the same; the CLI
  writes the reference's file name, exits with the reference's argparse
  errors, and without CUDA needs ``--device cpu``;
* ``sharding.comm`` records each tag's collective kind and sums by kind.

Each test that starts a world (fake, or one gloo rank) stops it in a
``finally``.
"""
import copy

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.launch import fed_dryrun as jfd
from repro_torch.launch import fed_dryrun as fd
from repro_torch.launch.mesh import start_fake_world, stop_world
from repro_torch.sharding import comm, ledger

# the reference's CI widths (its dryrun-smoke commands), a cohort cut to 16
CI = ["--n-max", "64", "--g-max", "8", "--features", "32", "--cohort", "16"]
TINY = ["--n-max", "16", "--g-max", "4", "--features", "8", "--cohort", "8"]
WIRES = ("ghost_all_to_all", "wb_stage1_all_gather", "wb_stage2_all_to_all")


def _args(*argv):
    return fd.build_parser().parse_args(["--mesh", "host", *argv])


def _tuples(counts: dict) -> dict:
    return {k: tuple(v) for k, v in counts.items()}


@pytest.fixture(scope="module")
def walks():
    """Pod rounds on a fake 8-rank world (8 pods) at the CI widths: fp32 at
    K 4,096 and 1,024, int8 at K 1,024."""
    out = {}
    start_fake_world(8)
    try:
        for K, dtype in ((4096, "fp32"), (1024, "fp32"), (1024, "int8")):
            args = _args("--pods", "8", "--clients", str(K), "--sync-dtype", dtype, *CI)
            out[K, dtype] = fd.dryrun_mesh("host", args)
    finally:
        stop_world()
    return out


# -- the validators, on rows built without a walk ----------------------------

def _row(K: int, dtype: str = "fp32") -> dict:
    """A valid pods row at K clients: the port's ledger over the synthetic
    buckets, the reference's top keys."""
    P, m, n_max, g_max, F = 4, 8, 16, 4, 8
    b = fd.synthetic_ghost_buckets(K, n_max, g_max, P, fill=0.5)
    pods = ledger.pod_placement_ledger(b, n_pods=P, cohort_pad=m, wb_cap=2, n_max=n_max,
                                       g_max=g_max, n_feat=F, n_classes=3, tau=8,
                                       local_epochs=4, sync_dtype=dtype)
    wire = pods["quant"]["wire_collective_bytes"]
    pods["all_to_all_bytes"] = wire["ghost_all_to_all"] + wire["wb_stage2_all_to_all"]
    pods["all_gather_bytes"] = wire["wb_stage1_all_gather"]
    return {"status": "ok", "arch": "fedgcn-graphsage", "mesh": "host", "chips": P,
            "clients": K, "cohort": m, "roofline": {},
            "collectives": {"all-to-all": pods["all_to_all_bytes"],
                            "all-gather": pods["all_gather_bytes"], "all-reduce": 1000},
            "pods": pods}


def _broken(case: str):
    """(validator name, its arguments) for one rule."""
    a = _row(64)
    if case == "valid":
        return "validate_fed_dryrun", (a,)
    if case == "missing_key":
        del a["roofline"]
        return "validate_fed_dryrun", (a,)
    if case == "negative_resident":
        a["pods"]["per_device_resident_bytes"]["k_sharded"]["hist1"] = -1
        return "validate_fed_dryrun", (a,)
    if case == "sync_fraction":
        a["pods"]["sync"]["sync_fraction"] = 1.5
        return "validate_fed_dryrun", (a,)
    if case == "non_sync_ghost_bytes":
        a["pods"]["sync"]["non_sync_round_ghost_bytes"] = 12
        return "validate_fed_dryrun", (a,)
    if case == "fp32_wire_off_nominal":
        a["pods"]["quant"]["wire_collective_bytes"]["ghost_all_to_all"] -= 4
        return "validate_fed_dryrun", (a,)
    if case == "k_scaling_replicated":
        b = _row(128)
        b["pods"]["per_device_resident_bytes"]["replicated"]["params"] += 4
        b["collectives"]["all-reduce"] += 8
        return "assert_k_flat", (a, b)
    if case == "int8_above_half":
        b = _row(64, "int8")
        b["pods"]["quant"]["wire_collective_bytes"]["wb_stage1_all_gather"] = \
            a["pods"]["quant"]["wire_collective_bytes"]["wb_stage1_all_gather"]
        b["collectives"]["all-gather"] = a["collectives"]["all-gather"]
        return "assert_quant_bytes", (a, b)
    raise KeyError(case)


CASES = ("valid", "missing_key", "negative_resident", "sync_fraction",
         "non_sync_ghost_bytes", "fp32_wire_off_nominal", "k_scaling_replicated",
         "int8_above_half")


@pytest.mark.parametrize("case", CASES)
def test_validators_return_the_reference_problems(case):
    name, rows = _broken(case)
    got = getattr(fd, name)(*copy.deepcopy(rows))
    want = getattr(jfd, name)(*copy.deepcopy(rows))
    assert got == want
    assert bool(got) == (case != "valid")


@pytest.mark.parametrize("K,g_max,P,fill,seed",
                         [(64, 4, 4, 0.5, 0), (100, 8, 8, 1.0, 3), (37, 5, 3, 0.25, 7),
                          (256, 16, 16, 0.5, 1)])
def test_synthetic_buckets_are_the_reference_draws(K, g_max, P, fill, seed):
    got = fd.synthetic_ghost_buckets(K, 32, g_max, P, fill=fill, seed=seed)
    want = jfd.synthetic_ghost_buckets(K, 32, g_max, P, fill=fill, seed=seed)
    for k in ("n_pods", "rows_per_pod", "bucket_size", "n_entries"):
        assert getattr(got, k) == getattr(want, k)
    for k in ("send_client", "send_row", "send_mask", "recv_src", "recv_pos", "recv_mask"):
        np.testing.assert_array_equal(getattr(got, k), np.asarray(getattr(want, k)))


# -- the walks -----------------------------------------------------------------

def test_walk_rows_pass_both_validators_and_are_k_flat(walks):
    for row in walks.values():
        assert row["checks"] == []
        assert fd.validate_fed_dryrun(row) == []
        assert jfd.validate_fed_dryrun(row) == []
        assert row["collective_source"] == "counted" and "walk_s" in row
    a, b = walks[4096, "fp32"], walks[1024, "fp32"]
    assert fd.assert_k_flat(a, b) == []
    assert jfd.assert_k_flat(a, b) == []


@pytest.mark.parametrize("K,dtype", [(4096, "fp32"), (1024, "fp32"), (1024, "int8")])
def test_walk_ledger_is_the_reference_ledger(walks, K, dtype):
    row = walks[K, dtype]
    jb = jfd.synthetic_ghost_buckets(K, 64, 8, 8, fill=0.5)
    want = jfd.pod_placement_ledger(jb, n_pods=8, cohort_pad=16, wb_cap=row["pods"]["wb_cap"],
                                    n_max=64, g_max=8, n_feat=32, n_classes=41, tau=8,
                                    local_epochs=4, sync_dtype=dtype)
    got = {k: v for k, v in row["pods"].items()
           if k not in ("all_to_all_bytes", "all_gather_bytes")}
    assert got == want
    # the reference's dry run reads wb_cap off its worst-case routing
    assert row["pods"]["wb_cap"] == 2


def test_walk_counts_equal_round_collectives(walks):
    for row in walks.values():
        on, off = (_tuples(row["rounds"][g]["counts"]) for g in ("gate_on", "gate_off"))
        assert on == ledger.round_collectives(row["pods"], gate=True)
        assert off == ledger.round_collectives(row["pods"], gate=False)
        assert "ghost_all_to_all" not in off and "ghost_fetch_psum" not in off
        kinds = comm.collective_stats(on).bytes_by_kind
        assert row["collectives"] == kinds
        assert row["pods"]["all_to_all_bytes"] == kinds["all-to-all"]


def test_walk_residents_equal_the_ledger(walks):
    """Every resident entry the ledger's, but the round inputs: the ledger
    prices the reference's replicated (S, m) stacks and whole (P, P, cap)
    receive table, the port's rank holds its pod's slice (ROADMAP C)."""
    for row in walks.values():
        held, want = row["residents"]["held"], row["pods"]["per_device_resident_bytes"]
        assert held["k_sharded"] == want["k_sharded"]
        assert held["ghost_cut_scaled"] == want["ghost_cut_scaled"]
        assert held["replicated"]["params"] == want["replicated"]["params"]
        port = ledger.port_round_input_bytes(cohort_pad=16, n_pods=8, n_client_shards=1,
                                             wb_cap=row["pods"]["wb_cap"])
        assert row["residents"]["port_round_inputs"] == port
        for name in ("cohort_stacks", "wb_routing"):
            assert held["replicated"][name] == port[name] < want["replicated"][name]


def test_int8_halves_every_wire_and_keeps_the_residents(walks):
    f32, i8 = walks[1024, "fp32"], walks[1024, "int8"]
    assert fd.assert_quant_bytes(f32, i8) == []
    assert jfd.assert_quant_bytes(f32, i8) == []
    on32, on8 = (_tuples(r["rounds"]["gate_on"]["counts"]) for r in (f32, i8))
    for tag in WIRES:
        assert 2 * on8[tag][1] <= on32[tag][1]
    assert f32["residents"]["held"] == i8["residents"]["held"]


def test_client_sharded_round_counts_equal_the_ledger():
    start_fake_world(8)
    try:
        row = fd.dryrun_mesh("host", _args("--clients", "64", *CI))
    finally:
        stop_world()
    want = ledger.sharded_round_collectives(cohort_pad=16, n_shards=8, n_max=64, g_max=8,
                                            n_feat=32, n_classes=41)
    assert row["checks"] == [] and fd.validate_fed_dryrun(row) == []
    for r in row["rounds"].values():
        assert _tuples(r["counts"]) == want


@pytest.mark.parametrize("pods", ["8", "0"])
def test_meta_and_real_walks_count_the_same(pods):
    args = _args("--pods", pods, "--clients", "64", *TINY)
    start_fake_world(8)
    try:
        meta = fd.dryrun_mesh("host", args)
        real = fd.dryrun_mesh("host", args, device="cpu")
    finally:
        stop_world()
    assert meta["checks"] == [] and real["checks"] == []
    assert meta["device"] == "meta" and real["device"] == "cpu"
    for g in ("gate_on", "gate_off"):
        assert real["rounds"][g]["counts"] == meta["rounds"][g]["counts"]
        assert real["timed"][g]["counts"] == meta["rounds"][g]["counts"]
    if pods != "0":
        assert real["residents"] == meta["residents"]


# -- the CLI -----------------------------------------------------------------------

def test_cli_writes_the_reference_file(tmp_path):
    import json

    assert not dist.is_initialized()
    rc = fd.main(["--mesh", "host", "--force-devices", "8", "--pods", "8", "--clients", "256",
                  "--assert-quant-bytes", *TINY, "--out", str(tmp_path)])
    assert rc == 0 and not dist.is_initialized()
    row = json.loads((tmp_path / "fedgcn_host_pods8.json").read_text())
    assert jfd.validate_fed_dryrun(row) == [] and row["chips"] == 8


@pytest.mark.parametrize("argv", [["--assert-k-flat", "10", "--clients", "100"],
                                  ["--assert-quant-bytes"]])
def test_cli_errors_are_the_reference_errors(argv, capsys):
    errors = []
    for mod in (fd, jfd):
        with pytest.raises(SystemExit) as e:
            mod.main(["--mesh", "host", *argv])
        assert e.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errors[0] == errors[1]
    assert not dist.is_initialized()


def test_host_mode_needs_the_card_or_the_cpu(monkeypatch, tmp_path):
    argv = ["--mesh", "host", "--pods", "1", "--clients", "32", *TINY, "--out", str(tmp_path)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fd.main(argv)
    assert not dist.is_initialized()
    assert fd.main([*argv, "--device", "cpu"]) == 0      # one gloo rank, real tensors
    assert not dist.is_initialized()
    assert (tmp_path / "fedgcn_host_pods1.json").exists()


# -- the counters ------------------------------------------------------------------

def test_comm_records_kinds_and_sums_by_kind():
    start_fake_world(4)
    try:
        world = dist.group.WORLD
        before = comm.snapshot()
        comm.all_reduce_sum(torch.zeros(3, 5), world, "t_reduce")
        comm.all_gather(torch.zeros(2, 4, dtype=torch.int32), world, "t_gather")
        comm.all_to_all(torch.zeros(4, 6, dtype=torch.uint8), world, "t_a2a")
        comm.all_to_all(torch.zeros(4, 2, dtype=torch.uint8), world, "t_a2a")
        with pytest.raises(ValueError, match="moved by all-to-all"):
            comm.all_reduce_sum(torch.zeros(4, 2), world, "t_a2a")
        delta = comm.diff(comm.snapshot(), before)
    finally:
        stop_world()
    assert comm.COUNTS["t_a2a"] == [2, 32]            # COUNTS keeps [calls, bytes]
    assert delta == {"t_reduce": (1, 60), "t_gather": (1, 128), "t_a2a": (2, 32)}
    stats = comm.collective_stats(delta)
    assert stats.bytes_by_kind == {"all-reduce": 60, "all-gather": 128, "all-to-all": 32}
    assert stats.count_by_kind == {"all-reduce": 1, "all-gather": 1, "all-to-all": 2}
    assert stats.total_bytes == 220 and stats.total_count == 4
    assert stats.summary() == ("all-gather: n=1 bytes=128; all-reduce: n=1 bytes=60; "
                               "all-to-all: n=2 bytes=32")
    assert comm.CollectiveStats().summary() == "(no collectives)"
