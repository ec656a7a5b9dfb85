"""One FedAIS training round against the reference, client by client.

Both sides start from the reference's ``gcn_init(PRNGKey(seed + 1))`` and
draw their uniforms from the reference's key chain: the port's engine takes
a draw provider (``JaxDraws`` below) that replays ``split(key, m + 1)`` per
round (``repro/api/engine.py:411``), ``split(key, 3)`` per epoch
(``repro/core/fedais.py:167``), the fanout uniforms (``:178``) and the
Gumbel uniforms (``repro/core/importance.py:87``, ``minval=1e-20``).
Cohorts come from the host numpy generator on both sides.

Tiers (ROADMAP, North star):

* one round of ``fedais``, ``fedall`` and ``fedrandom``, client by client:
  the sampled batches, validity, fanout ranks, ghost ``need`` masks,
  ``n_sync`` and ``n_ghost_pulled`` exact; ``loss_all`` at atol 1e-5 / rtol
  1e-4 and the first step's grads at the reference's grad tolerance (atol
  1e-5, rtol 1e-4). After J AdamW steps params and tables are not held to
  allclose: at step 1 AdamW moves a parameter by about ``lr·sign(g)``, so
  a grad near 0 whose sign depends on the summation order moves it by up
  to ``2·lr``. They are held to that: no parameter more than ``2·lr·J``
  apart, and 99% of the parameters, and of the table's entries, within
  ``0.1·lr``; ``age`` and the pulled ghost features exact.

The whole run is in tests/test_torch_engine.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.fedais as jfedais
import repro_torch.core.fedais as tfedais
from repro.api import FedEngine as JEngine
from repro.models.gcn import gcn_init as jgcn_init
from repro_torch.api import FedEngine
from repro_torch.convert import params_from_numpy
from repro_torch.federated.partition import partition_graph
from repro_torch.graph.data import make_dataset

M = 4
TOL = {"atol": 1e-5, "rtol": 1e-4}
# after J AdamW steps (module docstring): every parameter within 2·lr·J,
# and 99% of all parameters (and of hist1's entries) within 0.1·lr
CAVEAT_MAX, CAVEAT_ATOL, CAVEAT_SHARE = 2.0, 1e-3, 0.99


class JaxDraws:
    """Replays the reference's PRNG key chain as the port's draw provider."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def clients(self, m):
        self.key, *ks = jax.random.split(self.key, m + 1)
        return [_JaxStream(k) for k in ks]


class _JaxStream:
    def __init__(self, key):
        self.key = key

    def epoch(self):
        self.key, kb, kn = jax.random.split(self.key, 3)
        return _JaxEpoch(kb, kn)


class _JaxEpoch:
    def __init__(self, kb, kn):
        self.kb, self.kn = kb, kn

    def batch_uniform(self, shape):
        return torch.from_numpy(np.array(jax.random.uniform(self.kb, shape, minval=1e-20,
                                                            maxval=1.0)))

    def fanout_uniform(self, shape):
        return torch.from_numpy(np.array(jax.random.uniform(self.kn, shape)))


@pytest.fixture(scope="module")
def port_fed():
    g = make_dataset("pubmed", scale=32, seed=0)
    return g, partition_graph(g, 8, alpha=0.5, seed=0)


def _init_params(fed, seed=0):
    p = jgcn_init(jax.random.PRNGKey(seed + 1), fed.n_features, fed.n_classes)
    return {k: np.asarray(v) for k, v in p.items()}


def _record(monkeypatch, module, names, log):
    """Wrap ``module``'s functions so each call appends (args, output)."""
    for name in names:
        def wrapped(*a, _real=getattr(module, name), _name=name, **k):
            out = _real(*a, **k)
            log.setdefault(_name, []).append((a, out))
            return out

        monkeypatch.setattr(module, name, wrapped)


def _record_traced(monkeypatch, module, names, log):
    """The same for the reference's jitted LocalUpdate: each call hands
    (args, output) to the host by an ordered debug callback, as numpy."""
    for name in names:
        def wrapped(*a, _real=getattr(module, name), _name=name, **k):
            out = _real(*a, **k)
            jax.debug.callback(lambda *x, _n=_name: log.setdefault(_n, []).append(
                jax.tree_util.tree_map(np.asarray, x)), a, out, ordered=True)
            return out

        monkeypatch.setattr(module, name, wrapped)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("method", ["fedais", "fedall", "fedrandom"])
def test_one_round_matches(small_fed, port_fed, method, monkeypatch):
    jg, jfed = small_fed
    g, fed = port_fed
    p0 = _init_params(fed)
    # the reference: round 0 of its engine, each client's LocalUpdate jitted
    # on its own (not vmapped), its decisions recorded
    jeng = JEngine(jg, jfed, method, rounds=1, clients_per_round=M, seed=0)
    jst = jeng.init_state()
    sel = jeng.selector.select(jeng, jst)
    _, *keys = jax.random.split(jst.key, len(sel) + 1)
    jlog: dict = {}
    ref = []
    with monkeypatch.context() as mp:
        _record_traced(mp, jfedais, ("sample_batch", "stable_rank", "adamw_update"), jlog)
        one = jax.jit(jfedais.make_local_update(jeng.mcfg, jfed.n_max, jfed.g_max, jeng.H1))
        for i, k in enumerate(sel):
            jlog.clear()
            client = {n: v[k] for n, v in jst.arrays.items()}
            out = one(jst.params, client, jst.arrays["features"], jst.hist.hist1,
                      jst.hist.hist1[k], jst.hist.age[k], jst.ghost_feat[k],
                      jst.prev_loss[k], jnp.asarray(jst.tau, jnp.int32),
                      jnp.asarray(jeng.mcfg.neighbor_fanout, jnp.int32),
                      jnp.asarray(0, jnp.int32), keys[i])
            jax.effects_barrier()
            ref.append((out, {n: list(v) for n, v in jlog.items()}))

    # the port: its engine's dispatch of the same cohort
    eng = FedEngine(g, fed, method, rounds=1, clients_per_round=M, seed=0, device="cpu")
    st = eng.init_state(params=params_from_numpy(p0, "cpu"), draws=JaxDraws(0))
    assert np.array_equal(eng.selector.select(eng, st), sel)
    tlog: dict = {}
    _record(monkeypatch, tfedais, ("sample_batch", "stable_rank", "adamw_update",
                                   "ghost_need"), tlog)
    t_params, t_hist1, t_age, t_ghost, t_stats = eng.dispatch(st, sel, 0)

    mcfg, n_max, J = eng.mcfg, fed.n_max, eng.mcfg.local_epochs
    lr = mcfg.lr
    for i, k in enumerate(sel):
        (j_params, j_hist1, j_age, j_ghost, j_stats), jl = ref[i]
        # ---- the discrete tier ----
        t_batches = tlog.get("sample_batch", [])[i * J:(i + 1) * J]
        if mcfg.use_all_samples:
            assert not t_batches and "sample_batch" not in jl
            train = (jfed.train_mask[k] * jfed.node_mask[k]) > 0
            batches = [(np.arange(n_max), train)] * J
        else:
            batches = [(np.asarray(b), np.asarray(v)) for _, (b, v) in jl["sample_batch"]]
            assert len(t_batches) == len(batches) == J
            for (_, (tb, tv)), (jb, jv) in zip(t_batches, batches):
                assert np.array_equal(_np(tb), jb) and np.array_equal(_np(tv), jv)
        t_ranks = tlog["stable_rank"][i * J:(i + 1) * J]
        assert len(t_ranks) == len(jl["stable_rank"]) == J
        for (_, tr), (_, jr) in zip(t_ranks, jl["stable_rank"]):
            assert np.array_equal(_np(tr), np.asarray(jr))
        assert int(t_stats["n_sync"][i]) == int(j_stats["n_sync"])
        assert float(t_stats["n_ghost_pulled"][i]) == float(j_stats["n_ghost_pulled"])
        # need, from the reference's own decisions by its formula
        syncs = [j for j in range(J) if j % max(st.tau, 1) == 0]
        t_needs = tlog["ghost_need"][i * len(syncs):(i + 1) * len(syncs)]
        assert len(t_needs) == int(j_stats["n_sync"]) == len(syncs)
        for (_, tn), j in zip(t_needs, syncs):
            b, valid = batches[j]
            keep = (np.asarray(jl["stable_rank"][j][1]) < mcfg.neighbor_fanout)
            rows, nm = jfed.nbr_idx[k][b], jfed.nbr_mask[k][b]
            ref_need = np.zeros(jfed.g_max, np.float32)
            hit = (rows >= n_max) & (nm * keep > 0) & valid[:, None]
            ref_need[(rows - n_max)[hit]] = 1.0
            assert np.array_equal(_np(tn), ref_need * jfed.ghost_mask[k])
        # ---- the value tier ----
        np.testing.assert_allclose(_np(t_stats["loss_all"][i]),
                                   np.asarray(j_stats["loss_all"]), **TOL)
        t_grads = tlog["adamw_update"][i * J][0][0]      # the first step's grads
        j_grads = jl["adamw_update"][0][0][0]
        for name in p0:
            np.testing.assert_allclose(_np(t_grads[name]), np.asarray(j_grads[name]),
                                       **TOL, err_msg=name)
        # ---- the AdamW caveat on what J steps give ----
        d = np.concatenate([np.abs(_np(t_params[n][i]) - np.asarray(j_params[n])).ravel()
                            for n in p0])
        assert d.max() <= CAVEAT_MAX * lr * J and (d <= CAVEAT_ATOL).mean() >= CAVEAT_SHARE
        d = np.abs(_np(t_hist1[i]) - np.asarray(j_hist1))
        assert (d <= CAVEAT_ATOL).mean() >= CAVEAT_SHARE
        assert np.array_equal(_np(t_age[i]), np.asarray(j_age))
        assert np.array_equal(_np(t_ghost[i]), np.asarray(j_ghost))
