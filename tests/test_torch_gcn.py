"""The port's GCN forward and eval path against the reference's.

Both sides start from the reference's ``gcn_init`` params, carried across
with ``np.asarray`` + ``convert.params_from_numpy``. Aggregation is held at
1e-5; logits and losses at 1e-4 (they pass through dense products that XLA
and torch sum in different orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.federated import server as jserver
from repro.graph.csr import csr_from_padded as jcsr_from_padded
from repro.graph.data import make_dataset
from repro.models import gcn as jgcn
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.federated import server as tserver
from repro_torch.graph.csr import build_padded_neighbors
from repro_torch.models import gcn as tgcn


@pytest.fixture(scope="module")
def setup():
    g = make_dataset("pubmed", scale=64, seed=0)
    idx, mask = build_padded_neighbors(g.adjacency_lists(), 16, seed=0)
    jp = jgcn.gcn_init(jax.random.PRNGKey(0), g.n_features, g.n_classes)
    np_params = {k: np.asarray(v) for k, v in jp.items()}
    return g, idx, mask, np_params


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("backend", tgcn.AGG_BACKENDS)
def test_neighbor_aggregate_matches(setup, backend):
    g, idx, mask, _ = setup
    rng = np.random.default_rng(0)
    rows = rng.choice(g.n_nodes, 40, replace=False)
    rows[0] = int(np.flatnonzero(mask.sum(1) == 0)[0]) if (mask.sum(1) == 0).any() else rows[0]
    b_idx, b_mask = idx[rows], mask[rows]
    table = rng.standard_normal((g.n_nodes, 24)).astype(np.float32)
    got = tgcn.neighbor_aggregate(_t(table), _t(b_idx), _t(b_mask), backend=backend)
    kw = {"interpret": True} if backend == "spmm" else {}
    want = jgcn.neighbor_aggregate(jnp.asarray(table), jnp.asarray(b_idx),
                                   jnp.asarray(b_mask), backend=backend, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    # XLA and torch reduce the K slots in different orders, so the two
    # frameworks agree to rounding only; within the port a batch of rows
    # is bit-identical to the same rows of the full-graph aggregation,
    # which is what the serve-vs-eval parity (test_torch_serve) rests on
    if backend != "spmm":
        full = tgcn.neighbor_aggregate(_t(table), _t(idx), _t(mask), backend=backend)
        assert torch.equal(got, full[torch.from_numpy(rows)])


def test_segment_is_a_fixed_order_sum(setup):
    """The port's segment backend sums each row's K slots as a (b, K, d)
    reduction; a precomputed bucketed CSR gives the same bits."""
    from repro_torch.graph.csr import bucketed_csr_from_padded

    g, idx, mask, _ = setup
    table = _t(np.random.default_rng(1).standard_normal((g.n_nodes, 8)).astype(np.float32))
    ti, tm = _t(idx), _t(mask)
    table[0] = float("nan")                       # padding slots point at row 0
    a = tgcn.neighbor_aggregate(table, ti, tm, backend="segment")
    b = tgcn.neighbor_aggregate(table, ti, tm, backend="segment",
                                csr=bucketed_csr_from_padded(ti, tm))
    assert torch.equal(a, b) or np.array_equal(a.numpy(), b.numpy(), equal_nan=True)
    nbr_of_0 = (ti == 0) & (tm > 0)
    clean = ~nbr_of_0.any(1)
    assert torch.isfinite(a[clean]).all()


@pytest.mark.parametrize("backend", tgcn.AGG_BACKENDS)
def test_full_forward_and_loss_match(setup, backend):
    g, idx, mask, np_params = setup
    tp = params_from_numpy(np_params, "cpu")
    feats = g.features
    kw, jkw = {}, {}
    if backend == "segment":
        jkw["csr"] = {k: jnp.asarray(v) for k, v in jcsr_from_padded(idx, mask).items()}
    if backend == "spmm":
        jkw["interpret"] = True
    got = tgcn.gcn_full_forward(tp, _t(feats), _t(idx), _t(mask), backend=backend, **kw)
    want = jgcn.gcn_full_forward({k: jnp.asarray(v) for k, v in np_params.items()},
                                 jnp.asarray(feats), jnp.asarray(idx),
                                 jnp.asarray(mask), backend=backend, **jkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    labels = g.labels
    np.testing.assert_allclose(
        tgcn.per_node_loss(got, _t(labels)).numpy(),
        np.asarray(jgcn.per_node_loss(want, jnp.asarray(labels))), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("backend", tgcn.AGG_BACKENDS)
def test_eval_path_matches(setup, backend):
    g, _, _, np_params = setup
    tp = params_from_numpy(np_params, "cpu")
    jp = {k: jnp.asarray(v) for k, v in np_params.items()}
    teg = tserver.build_eval_graph(g, max_deg=16, seed=0, backend=backend, device="cpu")
    jeg = jserver.build_eval_graph(g, max_deg=16, seed=0, backend=backend)
    got = tserver.eval_logits(tp, teg).numpy()
    want = np.asarray(jserver._eval_logits(
        jp, jeg["features"], jeg["nbr_idx"], jeg["nbr_mask"], csr=jeg["csr"],
        adj=jeg["adj"], backend=backend))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    tm, jm = tserver.evaluate_global(tp, teg), jserver.evaluate_global(jp, jeg)
    for k in ("acc", "f1", "auc", "loss"):
        assert abs(tm[k] - jm[k]) < 1e-4, (k, tm[k], jm[k])


def test_metrics_and_counts_equal():
    rng = np.random.default_rng(5)
    labels = rng.integers(0, 4, 300)
    logits = rng.standard_normal((300, 4)).astype(np.float32)
    pred = logits.argmax(-1)
    assert tserver.macro_f1(labels, pred, 4) == jserver.macro_f1(labels, pred, 4)
    assert tserver.macro_ovr_auc(labels, logits) == jserver.macro_ovr_auc(labels, logits)
    assert tgcn.gcn_param_count(500, 3) == jgcn.gcn_param_count(500, 3)
    assert tgcn.gcn_flops_per_node(500, 3, 9.0) == jgcn.gcn_flops_per_node(500, 3, 9.0)


def test_init_shapes_scale_and_conversion():
    jp = jgcn.gcn_init(jax.random.PRNGKey(0), 128, 3)
    tp = tgcn.gcn_init(torch.Generator().manual_seed(0), 128, 3, device="cpu")
    assert tp.keys() == jp.keys()
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape and tp[k].dtype == torch.float32
    assert abs(float(tp["w_self0"].std()) - (2 / (128 + 256)) ** 0.5) < 0.01
    again = tgcn.gcn_init(torch.Generator().manual_seed(0), 128, 3, device="cpu")
    assert all(torch.equal(tp[k], again[k]) for k in tp)
    back = params_to_numpy(params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                             "cpu"))
    assert all(np.array_equal(back[k], np.asarray(jp[k])) for k in jp)
