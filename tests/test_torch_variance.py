"""The rest of FedAIS's own reference on the port, on the CPU: the
variance diagnostics (paper Eq. 3-5, Theorem 1) at 1e-5 on the same numpy
inputs, the centralised samplers bit-equal from the same
``np.random.Generator`` seed, ``sgd_update`` and the tree helpers
(``global_norm_clip`` at 1e-6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import variance as jvar
from repro.graph import sampling as jsampling
from repro.optim import sgd_update as j_sgd_update
from repro.utils import tree as jtree
from repro_torch.core import variance as tvar
from repro_torch.graph import sampling as tsampling
from repro_torch.graph.csr import build_padded_neighbors
from repro_torch.graph.data import make_dataset
from repro_torch.optim import sgd_update
from repro_torch.utils import tree as ttree

TOL = 1e-5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# variance diagnostics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [(1.0, 0.3, 5.2, 2), (0.7, 1.1, 16.0, 4), (2.0, 0.5, 3.0, 1)])
def test_bounds_match_reference(args):
    assert tvar.theorem1_bound(*args) == jvar.theorem1_bound(*args)
    assert tvar.gradient_error_bound(args[0], args[2]) == \
        jvar.gradient_error_bound(args[0], args[2])


def test_empirical_estimates_match_reference():
    rng = np.random.default_rng(0)
    h_t = rng.standard_normal((50, 16)).astype(np.float32)
    h_e = rng.standard_normal((50, 16)).astype(np.float32)
    mask = (rng.random(50) < 0.7).astype(np.float32)
    g = np.abs(rng.standard_normal(50)).astype(np.float32) * 10
    p = rng.random(50).astype(np.float32)
    p[3] = 0.0                                   # the 1e-30 floor
    p /= p.sum()
    samples = rng.standard_normal((8, 30, 5)).astype(np.float32)
    t = lambda a: torch.from_numpy(a)
    _close(tvar.embedding_error(t(h_t), t(h_e), t(mask)),
           jvar.embedding_error(jnp.asarray(h_t), jnp.asarray(h_e), jnp.asarray(mask)))
    _close(tvar.embedding_error(t(h_t), t(h_e), t(np.zeros(50, np.float32))),
           jvar.embedding_error(jnp.asarray(h_t), jnp.asarray(h_e), jnp.zeros(50)))
    mask[3] = 0.0
    _close(tvar.minibatch_variance(t(g), t(p), t(mask)),
           jvar.minibatch_variance(jnp.asarray(g), jnp.asarray(p), jnp.asarray(mask)))
    _close(tvar.estimator_variance(t(samples)), jvar.estimator_variance(jnp.asarray(samples)))


def test_importance_beats_uniform_on_skewed_data():
    """Eq. 7: with p ∝ the per-node gradient proxy the objective is at most
    uniform's (Cauchy-Schwarz), on both sides."""
    g = np.abs(np.random.default_rng(1).standard_normal(200)).astype(np.float32) ** 3
    ones = np.ones(200, np.float32)
    p_imp, p_uni = g / g.sum(), ones / 200
    t = torch.from_numpy
    v_imp = float(tvar.minibatch_variance(t(g), t(p_imp), t(ones)))
    v_uni = float(tvar.minibatch_variance(t(g), t(p_uni), t(ones)))
    assert v_imp < v_uni
    _close(v_imp, jvar.minibatch_variance(g, p_imp, ones))


# ---------------------------------------------------------------------------
# centralised samplers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def neighbors():
    g = make_dataset("pubmed", scale=64, seed=0)
    idx, mask = build_padded_neighbors(g.adjacency_lists(), 12)
    return g, idx, mask


@pytest.mark.parametrize("fanout", [3, 12, 20])
def test_node_wise_sample_is_bit_equal(neighbors, fanout):
    _, idx, mask = neighbors
    got = tsampling.node_wise_sample(idx, mask, fanout, np.random.default_rng(7))
    want = jsampling.node_wise_sample(idx, mask, fanout, np.random.default_rng(7))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("budget", [10, 100, 10_000])
def test_layer_wise_sample_is_bit_equal(neighbors, budget):
    g, idx, mask = neighbors
    got = tsampling.layer_wise_sample(idx, mask, g.n_nodes, budget, np.random.default_rng(8))
    want = jsampling.layer_wise_sample(idx, mask, g.n_nodes, budget, np.random.default_rng(8))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_subgraph_sample_is_bit_equal(neighbors):
    g, _, _ = neighbors
    got = tsampling.subgraph_sample(g.edges, g.n_nodes, 5, np.random.default_rng(9))
    want = jsampling.subgraph_sample(g.edges, g.n_nodes, 5, np.random.default_rng(9))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# sgd_update and the tree helpers
# ---------------------------------------------------------------------------

def _trees(seed=0):
    rng = np.random.default_rng(seed)
    a = {"w": rng.standard_normal((5, 3)).astype(np.float32),
         "blk": {"b": rng.standard_normal(3).astype(np.float32),
                 "a": rng.standard_normal((2, 2)).astype(np.float32)},
         "steps": np.arange(4, dtype=np.int32)}
    b = jax.tree_util.tree_map(lambda x: (x * 0.5 + 1).astype(x.dtype), a)
    return a, b


def _torch(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def _assert_tree(got, want, tol=TOL):
    got = jax.tree_util.tree_map(lambda t: t.numpy() if torch.is_tensor(t) else t, got)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        _close(g, w, tol)


def test_sgd_update_matches_reference():
    a, b = _trees()
    a.pop("steps"), b.pop("steps")
    bf = {"w": torch.from_numpy(a["w"]).to(torch.bfloat16)}
    _assert_tree(sgd_update(_torch(b), _torch(a), 0.1), j_sgd_update(b, a, 0.1))
    got = sgd_update({"w": torch.from_numpy(b["w"])}, bf, 0.1)["w"]
    want = j_sgd_update({"w": b["w"]}, {"w": jnp.asarray(a["w"], jnp.bfloat16)}, 0.1)["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_tree_helpers_match_reference():
    a, b = _trees()
    fa, fb = ({k: v for k, v in t.items() if k != "steps"} for t in (a, b))
    ta, tb, tfa, tfb = _torch(a), _torch(b), _torch(fa), _torch(fb)
    _assert_tree(ttree.tree_map(lambda x: x * 2, ta), jtree.tree_map(lambda x: x * 2, a))
    _assert_tree(ttree.tree_zeros_like(ta), jtree.tree_zeros_like(a))
    _assert_tree(ttree.tree_add(ta, tb), jtree.tree_add(a, b))
    _assert_tree(ttree.tree_sub(ta, tb), jtree.tree_sub(a, b))
    _assert_tree(ttree.tree_scale(tfa, 0.3), jtree.tree_scale(fa, 0.3))
    _assert_tree(ttree.tree_axpy(0.7, tfa, tfb), jtree.tree_axpy(0.7, fa, fb))
    _close(ttree.tree_dot(tfa, tfb), jtree.tree_dot(fa, fb))
    _close(ttree.tree_l2_norm(tfa), jtree.tree_l2_norm(fa))
    assert ttree.tree_count_params(ta) == jtree.tree_count_params(a)
    assert ttree.tree_bytes(ta) == jtree.tree_bytes(a)
    cast = ttree.tree_cast(ta, torch.bfloat16)
    assert cast["w"].dtype == torch.bfloat16 and cast["steps"].dtype == torch.int32
    jcast = jtree.tree_cast(a, jnp.bfloat16)
    np.testing.assert_array_equal(cast["w"].float().numpy(), np.asarray(jcast["w"], np.float32))
    assert ttree.tree_shapes(ta) == jtree.tree_shapes(a)
    assert bool(ttree.tree_isfinite(ta)) == bool(jtree.tree_isfinite(a)) is True
    bad = dict(fa, w=np.where(np.eye(5, 3) > 0, np.nan, fa["w"]).astype(np.float32))
    assert bool(ttree.tree_isfinite(_torch(bad))) == bool(jtree.tree_isfinite(bad)) is False
    assert bool(ttree.tree_isfinite({"i": torch.arange(3)})) is True
    for n in (0, 999, 1023.9, 1024, 5e9, 3e18):
        assert ttree.format_bytes(n) == jtree.format_bytes(n)
        assert ttree.format_count(n) == jtree.format_count(n)
    assert ttree.stable_hash("fedais") == jtree.stable_hash("fedais")
    x = np.array([[0, 2], [1, 1]])
    np.testing.assert_array_equal(ttree.np_one_hot(x, 3), jtree.np_one_hot(x, 3))


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_clip_matches_reference(max_norm):
    a, _ = _trees(3)
    a.pop("steps")
    got, norm = ttree.global_norm_clip(_torch(a), max_norm)
    want, jnorm = jtree.global_norm_clip(a, max_norm)
    _close(norm, jnorm, 1e-6)
    _assert_tree(got, want, 1e-6)


def test_tree_random_like_keeps_shapes_and_dtypes():
    spec = {"w": torch.empty((4, 3), device="meta"),
            "i": torch.empty((2,), dtype=torch.int32, device="meta"),
            "h": torch.empty((5,), dtype=torch.bfloat16, device="meta")}
    out = ttree.tree_random_like(torch.Generator().manual_seed(0), spec, scale=0.5)
    assert {k: (tuple(v.shape), v.dtype, v.device.type) for k, v in out.items()} == \
        {k: (tuple(v.shape), v.dtype, "cpu") for k, v in spec.items()}
    assert (out["i"] == 0).all() and 0 < float(out["w"].std()) < 2
    again = ttree.tree_random_like(torch.Generator().manual_seed(0), spec, scale=0.5)
    assert torch.equal(out["w"], again["w"])
