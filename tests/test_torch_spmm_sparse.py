"""The SpMM's sparse route (``repro_torch.kernels.spmm.ops.sparse_spmm``) on
the CPU.

Off CUDA the route runs its plain versions (``ref.ell_spmm_ref``,
``ref.ell_spmm_t_ref``); ``chip_smoke.py`` (phase 21) holds the kernels on
the card to them bit for bit. Here the route is held to the block route
(the dense adjacency through ``block_spmm``) and to the plain gathered
mean, forward and transposed, at widths 1 to 70 (most not multiples of
4), with rows that have no live slot, duplicate slots, and max_deg 32; its
column-sorted operand is held to the dense Aᵀ; the route rule keeps
Pubmed's and Coauthor's graphs dense and sends Reddit's sparse; a small
FedAIS run on the sparse route (forced by patching the rule's constant)
follows the dense route's history, fused and stepwise, with the same
aggregation count; and three rounds at Reddit's widths are held to the
benchmark's plain reference (``bench/fedbench/reference.py``, loaded by
path) under the Reddit cell's limits.
"""
import importlib.util
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.api import FedEngine, SyncScheduler, method_config
from repro_torch.api.callbacks import EvalCallback, HistoryCallback
from repro_torch.federated.partition import FederatedGraph, partition_graph
from repro_torch.federated.server import build_eval_graph
from repro_torch.graph.data import GraphData, make_dataset
from repro_torch.kernels.spmm import ops, ref
from test_torch_async import one_torch_thread  # noqa: F401  (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
WIDTHS = (1, 2, 3, 4, 5, 7, 8, 31, 33, 64, 70)
# Both routes sum at most 32 fp32 terms of unit-normal rows scaled by 1/deg
# (in another order, and one divides the sum where the other multiplies
# each term): they part by a few ulps of values under ~4, under 2e-6. A
# slot dropped moves a row by about |x| / deg (~0.03 at 32 slots), and TF32
# operands (10 mantissa bits) by ~1e-3 of the values: both far above.
ATOL = 2e-5


def _case(n: int, m: int, k: int, d: int, seed: int, live: float = 0.6):
    """A neighbour list (n, k) into a table (m, d): slots live with
    probability ``live``, every seventh row with no live slot, one row
    naming the same column in every slot."""
    gen = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, m, (n, k), generator=gen, dtype=torch.int32)
    mask = (torch.rand((n, k), generator=gen) < live).to(torch.float32)
    mask[::7] = 0.0
    idx[1] = 3
    mask[1] = 1.0
    x = torch.randn((m, d), generator=gen)
    return idx, mask, x


@pytest.mark.parametrize("k", [5, 32])
@pytest.mark.parametrize("d", WIDTHS)
def test_forward_against_block_route_and_gathered_mean(d, k):
    idx, mask, x = _case(45, 39, k, d, seed=d * 100 + k)
    got = ops.sparse_spmm(x, idx, mask)
    block = ops.block_spmm(ops.adjacency_from_neighbors(idx, mask, 39), x)
    gathered = ref.neighbor_mean_ref(x, idx, mask)
    assert got.shape == (45, d) and got.dtype == torch.float32
    assert float((got - block).abs().max()) <= ATOL
    assert float((got - gathered).abs().max()) <= ATOL
    empty = mask.sum(1) == 0
    assert bool(empty.any()) and bool((got[empty] == 0).all())


@pytest.mark.parametrize("d", WIDTHS)
def test_transposed_against_block_route_and_autograd(d):
    idx, mask, x = _case(45, 39, 32, d, seed=d)
    dy = torch.randn((45, d), generator=torch.Generator().manual_seed(d + 1))
    grads = []
    for fn in (lambda t: ops.sparse_spmm(t, idx, mask),
               lambda t: ops.block_spmm(ops.adjacency_from_neighbors(idx, mask, 39), t),
               lambda t: ref.neighbor_mean_ref(t, idx, mask)):
        leaf = x.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(fn(leaf), leaf, dy)[0])
    got, block, gathered = grads
    assert got.shape == (39, d)
    assert float((got - block).abs().max()) <= ATOL
    assert float((got - gathered).abs().max()) <= ATOL
    unnamed = torch.ones(39, dtype=torch.bool)
    unnamed[idx[mask > 0].long()] = False
    assert bool((got[unnamed] == 0).all())


def test_the_tolerance_catches_a_dropped_slot_and_tf32():
    idx, mask, x = _case(45, 39, 32, 33, seed=5)
    want = ref.neighbor_mean_ref(x, idx, mask)
    dropped = mask.clone()
    dropped[2, int(torch.nonzero(mask[2])[0])] = 0.0
    assert float((ops.sparse_spmm(x, idx, dropped) - want).abs().max()) > 10 * ATOL
    bits = x.view(torch.int32)
    tf32 = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    assert float((ops.sparse_spmm(tf32, idx, mask) - want).abs().max()) > 10 * ATOL


def test_plain_forward_is_the_kernels_order():
    """Slot by slot, one rounding an operation, dead slots never read: a
    NaN row of the table reaches exactly the rows naming it live."""
    idx, mask, x = _case(30, 20, 32, 6, seed=11)
    acc = torch.zeros((30, 6))
    deg = torch.zeros(30)
    for s in range(32):
        for i in range(30):
            if mask[i, s] != 0:
                acc[i] = acc[i] + mask[i, s] * x[idx[i, s]]
            deg[i] = deg[i] + mask[i, s]
    want = acc / torch.clamp(deg, min=1.0)[:, None]
    got = ops.sparse_spmm(x, idx, mask)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    x[7] = float("nan")
    hit = ((idx == 7) & (mask > 0)).any(1)
    nan_rows = torch.isnan(ops.sparse_spmm(x, idx, mask)).any(1)
    assert torch.equal(nan_rows, hit)


def test_column_sorted_operand():
    n, k, m = 40, 32, 37
    idx, mask, _ = _case(n, m, k, 1, seed=3)
    op = ops.column_sorted(idx, mask, m)
    live = int((mask > 0).sum())
    # fixed shapes: every slot an entry, the dead ones after ptr[m]
    assert op["rows"].shape == (n * k,) and op["w"].shape == (n * k,)
    assert op["ptr"].shape == (m + 1,) and op["ptr"].dtype == torch.int32
    assert int(op["ptr"][0]) == 0 and int(op["ptr"][-1]) == live
    ptr = op["ptr"].long()
    rows, w = op["rows"].long(), op["w"]
    dense = torch.zeros((m, n))
    deg = torch.clamp(mask.sum(1), min=1.0)
    for j in range(m):
        seg = range(int(ptr[j]), int(ptr[j + 1]))
        # stable: (row, slot) order within a column
        slots = [(int(rows[p]), p) for p in seg]
        assert slots == sorted(slots)
        for p in seg:
            i = int(rows[p])
            assert mask[i].gt(0).logical_and(idx[i] == j).any()
            assert float(w[p]) == float(mask[i][(idx[i] == j) & (mask[i] > 0)][0] / deg[i])
            dense[j, i] += w[p]
    # the dense Aᵀ's nonzeros, duplicates added as its build adds them
    a_t = ops.adjacency_from_neighbors(idx, mask, m).t()
    assert torch.equal(dense, a_t)


def test_route_rule(monkeypatch):
    assert ops.spmm_route(19_717) == "dense"        # Pubmed, 1.55 GB
    assert ops.spmm_route(18_333) == "dense"        # Coauthor, 1.34 GB
    assert ops.spmm_route(232_965) == "sparse"      # Reddit, 217 GB
    assert ops.spmm_route(32_768) == "dense" and ops.spmm_route(32_769) == "sparse"
    g = make_dataset("pubmed", scale=64, seed=0)
    fed = partition_graph(g, 4, alpha=0.5, seed=0)
    kw = dict(rounds=1, clients_per_round=2, device="cpu", train_backend="spmm",
              eval_backend="spmm")
    eng = FedEngine(g, fed, "fedais", **kw)
    assert eng.spmm_route == "dense" and eng.eval_graph["adj"] is not None
    monkeypatch.setattr(ops, "DENSE_OPERAND_BYTES", 0)
    eng = FedEngine(g, fed, "fedais", **kw)
    assert eng.spmm_route == "sparse"
    assert eng.eval_graph["adj"] is None and eng.eval_graph["spmm_route"] == "sparse"
    eg = build_eval_graph(g, backend="gather", device="cpu")
    assert eg["adj"] is None and eg["csr"] is None


def _counted(monkeypatch):
    """Count the plain versions' calls: on the CPU one a kernel launch."""
    calls = {"dense": 0, "sparse": 0}

    def wrap(fn, kind):
        def counted(*a, **k):
            calls[kind] += 1
            return fn(*a, **k)
        return counted

    monkeypatch.setattr(ops, "spmm_nonzeros_ref", wrap(ops.spmm_nonzeros_ref, "dense"))
    monkeypatch.setattr(ops, "ell_spmm_ref", wrap(ops.ell_spmm_ref, "sparse"))
    monkeypatch.setattr(ops, "ell_spmm_t_ref", wrap(ops.ell_spmm_t_ref, "sparse"))
    return calls


R, M, J = 3, 3, 4


def _run(monkeypatch, limit: int, fused):
    monkeypatch.setattr(ops, "DENSE_OPERAND_BYTES", limit)
    calls = _counted(monkeypatch)
    g = make_dataset("pubmed", scale=32, seed=0)
    fed = partition_graph(g, 6, alpha=0.5, seed=0)
    eng = FedEngine(g, fed, "fedais", rounds=R, clients_per_round=M, seed=2, device="cpu",
                    train_backend="spmm", eval_backend="spmm",
                    scheduler=SyncScheduler(fused=fused))
    state = eng.init_state()
    res = eng.run(state)
    monkeypatch.undo()
    return eng, state, res.history, calls


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "stepwise"])
def test_fedais_on_the_sparse_route_follows_the_dense_route(monkeypatch, fused):
    eng_d, st_d, hist_d, calls_d = _run(monkeypatch, 4 << 30, fused)
    eng_s, st_s, hist_s, calls_s = _run(monkeypatch, 0, fused)
    assert (eng_d.spmm_route, eng_s.spmm_route) == ("dense", "sparse")
    assert eng_s.last_executor == ("fused" if fused else "stepwise")
    # every aggregation one launch: the loss pass 2, a step 2 + 1 transposed,
    # the eval 2 (an eval every round)
    want = R * M * (2 + 3 * J) + R * 2
    assert calls_d == {"dense": want, "sparse": 0}
    assert calls_s == {"dense": 0, "sparse": want}
    assert hist_s["round"] == hist_d["round"] and hist_s["tau"] == hist_d["tau"]
    # fp32 sums in another order; AdamW's first steps amplify rounding, so
    # the losses part by up to ~1e-5 relative after three rounds here
    np.testing.assert_allclose(hist_s["test_loss"], hist_d["test_loss"], rtol=1e-4)
    np.testing.assert_allclose(hist_s["test_acc"], hist_d["test_acc"], atol=0.02)


def test_sparse_route_fused_equals_stepwise(monkeypatch):
    _, st_f, hist_f, _ = _run(monkeypatch, 0, True)
    _, st_s, hist_s, _ = _run(monkeypatch, 0, False)
    assert hist_f["test_loss"] == hist_s["test_loss"] and hist_f["tau"] == hist_s["tau"]
    for k in st_f.params:
        assert torch.equal(st_f.params[k], st_s.params[k])
    assert torch.equal(st_f.hist.hist1, st_s.hist.hist1)


# -- three rounds at Reddit's widths against the benchmark's reference --------

def _load(name: str):
    path = REPO / "bench" / "fedbench" / f"{name}.py"
    full = f"bench_{name}_for_spmm_sparse"
    spec = importlib.util.spec_from_file_location(full, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[full] = mod      # its dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def test_three_rounds_at_reddit_widths_against_the_reference(monkeypatch):
    reference, graphgen = _load("reference"), _load("graphgen")
    cfg = json.loads((REPO / "bench/configs/fedais-reddit.json").read_text())
    limits = json.loads((REPO / "bench/limits/fedais-reddit.k16-m5.json").read_text())
    g = cfg["graph"]
    assert (g["n_features"], g["n_classes"]) == (602, 41)
    graph = graphgen.make_graph(
        "reddit", n_nodes=700, n_edges=5_600, n_features=602, n_classes=41,
        splits=tuple(g["splits"]), max_features=602, homophily=g["homophily"],
        feature_noise=g["feature_noise"], mean_scale=g["mean_scale"], seed=0)
    part = graphgen.partition(graph, 4, alpha=0.5, max_deg=32, edge_keep=0.5, seed=0)
    seed, m, tau0 = 3_000_000_019, 2, cfg["method"]["tau0"]
    mc = cfg["method"]
    method = reference.Method(sample_ratio=mc["sample_ratio"], batch_cap=mc["batch_cap"],
                              fanout=mc["neighbor_fanout"], local_epochs=mc["local_epochs"],
                              lr=mc["lr"], tau0=tau0)
    gen = torch.Generator().manual_seed(seed)
    params0 = reference.init_params(gen, 602, 41, "cpu")

    # the program, on the sparse route, three rounds as chunks of one
    monkeypatch.setattr(ops, "DENSE_OPERAND_BYTES", 0)
    calls = _counted(monkeypatch)
    gd = GraphData(name="reddit", features=graph["features"], labels=graph["labels"],
                   edges=graph["edges"], n_classes=41, train_mask=graph["train_mask"],
                   val_mask=graph["val_mask"], test_mask=graph["test_mask"], spec=None)
    fed = FederatedGraph(name="reddit", **{k: part[k] for k in (
        "n_clients", "n_max", "g_max", "max_deg", "features", "labels", "node_mask",
        "train_mask", "val_mask", "nbr_idx", "nbr_mask", "ghost_owner", "ghost_row",
        "ghost_mask", "global_ids", "n_classes", "n_cross_edges")})
    mcfg = method_config("fedais", tau0=tau0, sample_ratio=mc["sample_ratio"],
                         batch_cap=mc["batch_cap"], neighbor_fanout=mc["neighbor_fanout"],
                         local_epochs=mc["local_epochs"], lr=mc["lr"])
    eng = FedEngine(gd, fed, mcfg, rounds=1 << 40, clients_per_round=m, seed=seed,
                    callbacks=[EvalCallback(10), HistoryCallback()], train_backend="spmm",
                    eval_backend="spmm", device="cpu")
    assert eng.spmm_route == "sparse"
    state = eng.init_state(params={k: v.clone() for k, v in params0.items()})
    for cb in eng.callbacks:
        cb.on_run_start(eng, state)
    prev0 = state.prev_loss.clone()
    cohorts = graphgen.select_cohorts(seed, part["n_clients"], m, 3)
    snaps = []
    for r in range(3):
        assert not eng._run_chunk(state, r, 1)
        rows = torch.as_tensor(np.asarray(cohorts[r]), dtype=torch.long)
        snaps.append({"params": {k: v.detach().clone() for k, v in state.params.items()},
                      "hist1": state.hist.hist1[rows].clone(),
                      "prev_loss": state.prev_loss.clone()})
    assert calls["sparse"] == 3 * m * (2 + 3 * method.local_epochs) + 2 and not calls["dense"]
    monkeypatch.undo()

    # the reference, each member's batches drawn from the program's loss pass
    eval_nbrs = graphgen.padded_neighbors(graphgen.adjacency_lists(graph["edges"], 700), 32,
                                          seed)
    inp = reference.device_inputs(part, graph, eval_nbrs, "cpu")
    refrun = reference.RefRun(inp, method, params0, seed, "cpu")
    scale = math.log(41)
    prev, gaps, ref_params = prev0, {}, [params0]
    hist1_gap, first = 0.0, None
    for r, cohort in enumerate(cohorts):
        loss_prog = snaps[r]["prev_loss"]
        ro = refrun.round(r, cohort, tau0,
                          follow=[(loss_prog[int(k)], prev[int(k)]) for k in cohort])
        first = first or ro.first_grad_norms
        for i, (k, mo) in enumerate(zip(cohort, ro.members)):
            real = inp["node_mask"][int(k)] > 0
            mp = float(loss_prog[int(k)][real].double().mean())
            mr = float(mo.loss_all[real].double().mean())
            gaps.setdefault(r, []).append(abs(mp - mr) / max(abs(mr), scale))
            if r == 0:
                hp, hr = _norm(snaps[0]["hist1"][i]), _norm(mo.hist1)
                hist1_gap = max(hist1_gap, abs(hp - hr) / hr)
        prev = loss_prog
        ref_params.append({k: v.clone() for k, v in refrun.params.items()})
    med_g = float(np.median(list(first.values())))
    kept = [k for k, v in first.items() if v >= 1e-3 * med_g]
    dref = {k: _norm(ref_params[1][k] - params0[k]) for k in kept}
    dprog = {k: _norm(snaps[0]["params"][k] - params0[k]) for k in kept}
    med = float(np.median(list(dref.values())))
    update = max(abs(dprog[k] - dref[k]) / max(dref[k], med) for k in kept)
    dref3 = {k: _norm(ref_params[3][k] - params0[k]) for k in kept}
    dprog3 = {k: _norm(snaps[2]["params"][k] - params0[k]) for k in kept}
    med3 = float(np.median(list(dref3.values())))
    update3 = float(np.median([abs(dprog3[k] - dref3[k]) / max(dref3[k], med3) for k in kept]))
    # rounds 1-2's loss passes (loss_pass12) start from params that AdamW's
    # first steps have parted by rounding: the judge's own limit for them
    # comes from the card's runs, so they are not held here
    assert len(gaps[1]) == len(gaps[2]) == m
    got = {"loss_pass": max(gaps[0]), "update": update, "update3": update3, "hist1": hist1_gap}
    for name, value in got.items():
        assert value <= limits[name], (name, value, limits[name])
