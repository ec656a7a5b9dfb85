"""FedSage+'s generator and FedGraph's fanout bandit against the reference's
(``repro/federated/baselines.py``), on ``small_fed``.

* ``ghost_reverse_map`` and ``generator_param_count``: bit-equal.
* the generator's apply, train step (loss, grads, new params) and impute,
  from the reference's ``generator_init`` params carried across, on the
  inputs the engine's FedSage+ strategy gives them: rtol 1e-5, atol 1e-6
  (fp32 products and sums in another order).
* ROADMAP C4: the reference's training context indexes the flattened
  (K·n_max, F) features with each client's *local* neighbour ids, so every
  client's context comes from client 0's rows. The port reproduces it (its
  strategy's context equals the reference's), and the loss differs from the
  one of a per-client gather.
* ``FanoutBandit``: the same choices, ``q`` and ``n`` for a scripted reward
  sequence (host numpy, exact).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.federated import baselines as JB
from repro_torch.api import FedEngine
from repro_torch.convert import params_from_numpy
from repro_torch.federated import baselines as TB
from repro_torch.federated.partition import partition_graph
from repro_torch.graph.data import make_dataset
from test_torch_async import one_torch_thread  # noqa: F401  (autouse fixture)

TOL = {"rtol": 1e-5, "atol": 1e-6}


@pytest.fixture(scope="module")
def port_fed():
    g = make_dataset("pubmed", scale=32, seed=0)
    return g, partition_graph(g, 8, alpha=0.5, seed=0)


@pytest.fixture(scope="module")
def gen_inputs(small_fed):
    """The reference strategy's generator inputs (``repro/api/strategies.py:
    76-81``) as numpy, and the reference's initial generator params."""
    _, fed = small_fed
    K, n_max, F = fed.n_clients, fed.n_max, fed.n_features
    idx = fed.nbr_idx.reshape(K * n_max, -1)
    inputs = {
        "feats": fed.features.reshape(K * n_max, F).astype(np.float32),
        "nbr_idx": np.minimum(idx, n_max * K - 1).astype(np.int32),
        "nbr_mask": (fed.nbr_mask.reshape(K * n_max, -1) * (idx < n_max)).astype(np.float32),
        "node_mask": fed.node_mask.reshape(K * n_max).astype(np.float32),
    }
    gp = JB.generator_init(jax.random.PRNGKey(2), F)
    return inputs, {k: np.asarray(v) for k, v in gp.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def test_ghost_reverse_map_is_bit_equal(small_fed, port_fed):
    rev, rev_mask = JB.ghost_reverse_map(small_fed[1])
    trev, trev_mask = TB.ghost_reverse_map(port_fed[1])
    assert trev.dtype == rev.dtype and trev_mask.dtype == rev_mask.dtype
    np.testing.assert_array_equal(trev, rev)
    np.testing.assert_array_equal(trev_mask, rev_mask)
    assert rev_mask.sum() > 0


def test_generator_param_count():
    for f, h in ((500, 64), (7, 3)):
        assert TB.generator_param_count(f, h) == JB.generator_param_count(f, h)
    gp = TB.generator_init(torch.Generator().manual_seed(0), 500, device="cpu")
    assert sum(v.numel() for v in gp.values()) == JB.generator_param_count(500)


def test_generator_apply_matches(gen_inputs):
    inputs, gp = gen_inputs
    ctx = np.random.default_rng(0).standard_normal((64, gp["w1"].shape[0])).astype(np.float32)
    want = np.asarray(JB.generator_apply(gp, jnp.asarray(ctx)))
    got = TB.generator_apply(_t(gp), torch.from_numpy(ctx)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_generator_train_step_matches(gen_inputs):
    inputs, gp = gen_inputs
    j_in = {k: jnp.asarray(v) for k, v in inputs.items()}
    args = (j_in["feats"], j_in["nbr_idx"], j_in["nbr_mask"], j_in["node_mask"])
    new_j, loss_j = JB.generator_train_step(gp, *args)
    # the returned loss is the one at the input params, so its grad is the
    # step's
    grads_j = jax.grad(lambda p: JB.generator_train_step(p, *args)[1])(
        {k: jnp.asarray(v) for k, v in gp.items()})
    t_in = _t(inputs)
    ctx = TB.generator_context(t_in["feats"], t_in["nbr_idx"], t_in["nbr_mask"])
    p = {k: v.requires_grad_(True) for k, v in _t(gp).items()}
    loss_t = TB.generator_loss(p, ctx, t_in["feats"], t_in["node_mask"])
    grads_t = dict(zip(p, torch.autograd.grad(loss_t, list(p.values()))))
    loss_t = loss_t.detach()
    new_t, loss_step = TB.generator_train_step(_t(gp), t_in["feats"], t_in["nbr_idx"],
                                               t_in["nbr_mask"], t_in["node_mask"])
    np.testing.assert_allclose(float(loss_t), float(loss_j), **TOL)
    assert float(loss_step) == float(loss_t)
    for k in TB.GEN_PARAM_KEYS:
        np.testing.assert_allclose(grads_t[k].numpy(), np.asarray(grads_j[k]), **TOL,
                                   err_msg=k)
        np.testing.assert_allclose(new_t[k].numpy(), np.asarray(new_j[k]), **TOL, err_msg=k)
        assert not new_t[k].requires_grad


def test_generator_impute_matches(small_fed, gen_inputs):
    _, fed = small_fed
    _, gp = gen_inputs
    rev, rev_mask = JB.ghost_reverse_map(fed)
    want = np.asarray(jax.vmap(JB.generator_impute, in_axes=(None, 0, 0, 0, 0))(
        gp, jnp.asarray(fed.features), jnp.asarray(rev), jnp.asarray(rev_mask),
        jnp.asarray(fed.ghost_mask)))
    args = [torch.from_numpy(np.asarray(a)) for a in
            (fed.features, rev, rev_mask, fed.ghost_mask)]
    got = TB.generator_impute(_t(gp), *args).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # one client at a time gives the same rows
    one = TB.generator_impute(_t(gp), *(a[3] for a in args)).numpy()
    np.testing.assert_allclose(one, got[3], **TOL)


def test_fedsage_context_quirk_is_reproduced(port_fed, gen_inputs):
    """ROADMAP C4: the port's FedSage+ strategy trains on the reference's
    context (client 0's rows at each client's local ids), not on a
    per-client gather, and the two give different losses."""
    g, fed = port_fed
    inputs, gp = gen_inputs
    eng = FedEngine(g, fed, "fedsage+", rounds=1, clients_per_round=2, device="cpu")
    state = eng.init_state()
    eng.strategy.gen_params = params_from_numpy(gp, "cpu")
    eng.strategy.pre_round(eng, state, np.arange(2))
    t_in = _t(inputs)
    quirk = TB.generator_context(t_in["feats"], t_in["nbr_idx"], t_in["nbr_mask"])
    torch.testing.assert_close(eng.strategy._ctx, quirk, rtol=0, atol=0)
    # a per-client gather: client k's local ids index client k's rows
    K, n_max = fed.n_clients, fed.n_max
    offset = torch.arange(K).repeat_interleave(n_max)[:, None] * n_max
    per_client = TB.generator_context(t_in["feats"], t_in["nbr_idx"] % n_max + offset,
                                      t_in["nbr_mask"])
    assert not torch.allclose(per_client, quirk, **TOL)
    torch.testing.assert_close(per_client[:n_max], quirk[:n_max], rtol=0, atol=0)
    loss_quirk = TB.generator_loss(_t(gp), quirk, t_in["feats"], t_in["node_mask"])
    loss_client = TB.generator_loss(_t(gp), per_client, t_in["feats"], t_in["node_mask"])
    assert abs(float(loss_quirk) - float(loss_client)) > 1e-3 * abs(float(loss_client))
    # and the reference's own train step reports the quirk's loss
    _, loss_j = JB.generator_train_step(gp, *(jnp.asarray(inputs[k]) for k in
                                              ("feats", "nbr_idx", "nbr_mask", "node_mask")))
    np.testing.assert_allclose(float(loss_quirk), float(loss_j), **TOL)


@pytest.mark.parametrize("eps", [0.2, 1.0])
def test_fanout_bandit_matches(eps):
    n_clients = 5
    jb, tb = JB.FanoutBandit(n_clients, seed=3, eps=eps), TB.FanoutBandit(n_clients, seed=3,
                                                                          eps=eps)
    script = np.random.default_rng(7)
    for _ in range(60):
        k = int(script.integers(n_clients))
        assert tb.choose(k) == jb.choose(k)
        reward = float(script.normal())
        tb.update(k, reward)
        jb.update(k, reward)
    np.testing.assert_array_equal(tb.q, jb.q)
    np.testing.assert_array_equal(tb.n, jb.n)
    np.testing.assert_array_equal(tb.last_action, jb.last_action)
    assert TB.FANOUT_ACTIONS == JB.FANOUT_ACTIONS and TB.ALL_BASELINES == JB.ALL_BASELINES


def test_method_config_shim():
    for name in TB.ALL_BASELINES:
        assert vars(TB.method_config(name)) == vars(JB.method_config(name))
