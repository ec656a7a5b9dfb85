"""The yardstick's operation and byte counts against a hand count on a
toy partition."""
from __future__ import annotations

import benchutil  # noqa: F401  (puts the harness on the path)
import pytest
import torch

from fedbench import work


def test_aggregation_counts_by_hand():
    # 3 rows over a table of 5 rows: row 0 reaches 1 and 2, row 1 reaches
    # 2 (a padding slot pointing at 4 is dead), row 2 reaches nothing
    idx = torch.tensor([[1, 2], [2, 4], [0, 0]])
    mask = torch.tensor([[1.0, 1.0], [1.0, 0.0], [0.0, 0.0]])
    w = work.Work()
    w.aggregation(idx, mask, m_cols=5, d=8, backward=True)
    fwd, bwd = w.launches
    assert (fwd["nnz"], fwd["x_rows"], fwd["n"], fwd["m"]) == (3, 2, 3, 5)
    assert fwd["flops"] == 2 * 8 * 3
    assert fwd["bytes"] == 8 * 3 + 4 * 8 * 2 + 4 * 8 * 3
    # the transposed launch writes all 5 rows of dX from the 2 live rows of dY
    assert (bwd["nnz"], bwd["x_rows"], bwd["n"], bwd["m"]) == (3, 2, 5, 3)
    assert bwd["bytes"] == 8 * 3 + 4 * 8 * 2 + 4 * 8 * 5
    assert fwd["bound_s"] == max(fwd["flops"] / 67e12, fwd["bytes"] / 3.35e12)


def test_dense_flops_by_hand():
    F, C, h0, h1 = 10, 3, 256, 128
    fwd = 2 * (2 * 4 * F * h0) + 2 * (2 * 4 * h0 * h1) + 2 * 4 * h1 * C
    assert work.dense_flops(4, F, C, train=False) == fwd
    # backward: layer 0's weights only (its inputs are features); layer 1
    # and the classifier their weights and their inputs
    bwd = 2 * (2 * 4 * F * h0) + 2 * (2 * (2 * 4 * h0 * h1) + 2 * 4 * h1 * C)
    assert work.dense_flops(4, F, C, train=True) == fwd + bwd
    assert work.round_dense_flops(2, 7, 4, 3, F, C) == 2 * (
        work.dense_flops(7, F, C, train=False) + 3 * work.dense_flops(4, F, C, train=True))


@pytest.mark.parametrize("seed", [0, 5])
def test_replayed_round_counts_match_its_launches(seed):
    """A reference round on a toy partition records one launch per SpMM
    the program launches: 2 + 3J a member, with every kernel's nonzeros
    those of its live slots."""
    from fedbench import cell, graphgen, reference

    cfg = {"dataset": "pubmed", "max_features": 12,
           "graph": {"n_nodes": 300, "n_edges": 1200, "n_features": 12, "n_classes": 3,
                     "splits": [0.8, 0.1, 0.1], "scale": 1, "homophily": 0.75,
                     "feature_noise": 0.05, "mean_scale": 0.005, "seed": seed},
           "method": {"sample_ratio": 0.7, "batch_cap": 256, "neighbor_fanout": 10,
                      "local_epochs": 4, "lr": 0.01, "tau0": 4}}
    traffic = {"partition": {"n_clients": 3, "alpha": 0.5, "max_deg": 32, "edge_keep": 0.5,
                             "seed": seed}}
    graph, part = cell.make_inputs(cfg, traffic)
    nbrs = graphgen.padded_neighbors(graphgen.adjacency_lists(graph["edges"], 300), 32, seed)
    inp = reference.device_inputs(part, graph, nbrs, "cpu")
    params = reference.init_params(torch.Generator().manual_seed(seed), 12, 3, "cpu")
    run = reference.RefRun(inp, cell.method_of(cfg), params, seed, "cpu")
    w = work.Work()
    run.round(0, [0, 2], 4, work=w)
    assert len(w.launches) == 2 * (2 + 3 * 4)
    lp0 = w.launches[0]
    assert lp0["nnz"] == int(part["nbr_mask"][0].sum())
    assert lp0["n"] == part["n_max"] and lp0["m"] == part["n_max"] + part["g_max"]
    assert [x["kind"] for x in w.launches[2:5]] == ["forward", "forward", "backward"]


@pytest.mark.parametrize("t0", [11, 17, 1000])
def test_warm_rounds_meet_every_graph_key(t0):
    """The warm-up rounds, from any round on, run every pattern of sync
    gates that a round can have under any tau Eq. 11 gives (1 to 64)."""
    from fedbench import cell

    J = 4

    def gates(t, tau):
        return tuple((J * t + j) % tau == 0 for j in range(J))

    seen = {gates(t0 + i, tau) for i, tau in enumerate(cell.warm_taus(J))}
    wanted = {gates(t, tau) for tau in range(1, 65) for t in range(J * tau)}
    assert wanted <= seen


def test_profiler_bookkeeping_leaves_the_window():
    """Device idle time under the profiler's own buffer handling on the host
    is left out of the traced window; other idle time stays in it."""
    from fedbench import trace

    ms = 1_000_000
    tr = {"window": (0, 100 * ms),
          "device": [(0, 40 * ms, "k1"), (60 * ms, 100 * ms, "k2")],
          "host": [(45 * ms, 50 * ms, "Buffer Flush", False),
                   (50 * ms, 55 * ms, "cudaGraphLaunch", False)]}
    s = trace.summarize(tr)
    assert s["busy_s"] == pytest.approx(0.080)
    assert s["profiler_s"] == pytest.approx(0.005)
    assert s["window_s"] == pytest.approx(0.095)
    names = dict(s["breakdown"]["idle_gaps"])
    assert sum(names.values()) == pytest.approx(0.015)
