"""The LocalUpdate with ``ghost_source="prefetched"`` (the pod-sharded
executor's) against the reference's, and against the port's own
``"tables"`` source.

One client of ``small_fed`` from the reference's initial params, a seeded
layer-1 table that every ghost row is pulled from (tau 1: every epoch
syncs), and the ghost sources gathered beforehand as the pod exchange
delivers them. The port draws the reference's key chain
(``test_torch_fedais._JaxStream``). Tiers (ROADMAP, North star): the
sampled batches, fanout ranks, ``n_sync``, ``n_ghost_pulled``, ``age`` and
the pulled ghost features exact; ``loss_all`` at atol 1e-5 / rtol 1e-4, the
first step's grads at the reference's grad tolerance (atol 1e-5, rtol
1e-4). The port's two sources, given the same rows, give the same bits,
at every wire dtype (the prefetched rows arrive decoded from the wire).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.fedais as jfedais
import repro_torch.core.fedais as tfedais
from repro.api import method_config as jmethod_config
from repro_torch.api import method_config
from repro_torch.federated.quant import quant_roundtrip
from repro_torch.models.gcn import HIDDEN
from test_torch_async import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_fedais import port_fed  # noqa: F401  (fixture)
from test_torch_fedais import _init_params, _JaxStream, _np, _record, _record_traced

TOL = {"atol": 1e-5, "rtol": 1e-4}
CLIENT = 2


def _inputs(fed, k, seed=0):
    """Client ``k``'s arrays, a seeded (K, n_tot, H1) layer-1 table, and the
    ghost sources pre-gathered from it and from the features."""
    rng = np.random.default_rng(seed)
    hist1_all = rng.normal(size=(fed.n_clients, fed.n_max + fed.g_max, HIDDEN[0]))
    hist1_all = hist1_all.astype(np.float32)
    keys = ("features", "labels", "node_mask", "train_mask", "nbr_idx", "nbr_mask",
            "ghost_owner", "ghost_row", "ghost_mask")
    client = {n: np.asarray(getattr(fed, n)[k]) for n in keys}
    owner = np.maximum(client["ghost_owner"], 0)
    src_f = fed.features[owner, client["ghost_row"]]
    src_h = hist1_all[owner, client["ghost_row"]]
    return client, hist1_all, src_f, src_h


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("method", ["fedais", "fedall"])
def test_prefetched_matches_the_reference(small_fed, port_fed, method, monkeypatch):
    _, jfed = small_fed
    _, fed = port_fed
    p0 = _init_params(fed)
    client, hist1_all, src_f, src_h = _inputs(fed, CLIENT)
    key = jax.random.PRNGKey(3)
    n_max, g_max, F = fed.n_max, fed.g_max, fed.n_features
    tau, fanout = 1, 10

    jcfg = jmethod_config(method, tau0=tau)
    jlog: dict = {}
    with monkeypatch.context() as mp:
        _record_traced(mp, jfedais, ("sample_batch", "stable_rank", "adamw_update"), jlog)
        one = jax.jit(jfedais.make_local_update(jcfg, n_max, g_max, HIDDEN[0],
                                                ghost_source="prefetched"))
        jout = one({k: jnp.asarray(v) for k, v in p0.items()},
                   {k: jnp.asarray(v) for k, v in client.items()}, jnp.asarray(src_f),
                   jnp.asarray(src_h), jnp.asarray(hist1_all[CLIENT]),
                   jnp.zeros((n_max + g_max,), jnp.int32), jnp.zeros((g_max, F)),
                   jnp.full((n_max,), -1.0), jnp.asarray(tau, jnp.int32),
                   jnp.asarray(fanout, jnp.int32), jnp.asarray(0, jnp.int32), key)
        jax.effects_barrier()
    j_params, j_hist1, j_age, j_ghost, j_stats = jout

    cfg = method_config(method, tau0=tau)
    tlog: dict = {}
    _record(monkeypatch, tfedais, ("sample_batch", "stable_rank", "adamw_update"), tlog)
    one_t = tfedais.make_local_update(cfg, n_max, ghost_source="prefetched")
    t_params, t_hist1, t_age, t_ghost, t_stats = one_t(
        {k: _t(v) for k, v in p0.items()}, {k: _t(v) for k, v in client.items()}, _t(src_f),
        _t(src_h), _t(hist1_all[CLIENT]), torch.zeros(n_max + g_max, dtype=torch.int32),
        torch.zeros((g_max, F)), torch.full((n_max,), -1.0), tau, fanout, 0, _JaxStream(key))

    J = cfg.local_epochs
    if cfg.use_all_samples:
        assert "sample_batch" not in tlog and "sample_batch" not in jlog
    else:
        assert len(tlog["sample_batch"]) == len(jlog["sample_batch"]) == J
        for (_, (tb, tv)), (_, (jb, jv)) in zip(tlog["sample_batch"], jlog["sample_batch"]):
            assert np.array_equal(_np(tb), np.asarray(jb))
            assert np.array_equal(_np(tv), np.asarray(jv))
    assert len(tlog["stable_rank"]) == len(jlog["stable_rank"]) == J
    for (_, tr), (_, jr) in zip(tlog["stable_rank"], jlog["stable_rank"]):
        assert np.array_equal(_np(tr), np.asarray(jr))
    assert t_stats["n_sync"] == int(j_stats["n_sync"]) == J
    assert float(t_stats["n_ghost_pulled"]) == float(j_stats["n_ghost_pulled"]) > 0
    assert np.array_equal(_np(t_age), np.asarray(j_age))
    assert np.array_equal(_np(t_ghost), np.asarray(j_ghost))
    np.testing.assert_allclose(_np(t_stats["loss_all"]), np.asarray(j_stats["loss_all"]),
                               **TOL)
    t_grads, j_grads = tlog["adamw_update"][0][0][0], jlog["adamw_update"][0][0][0]
    for name in p0:
        np.testing.assert_allclose(_np(t_grads[name]), np.asarray(j_grads[name]), **TOL,
                                   err_msg=name)
    # the pulled layer-1 rows: the ghost rows the batches referenced carry
    # the sources' values on both sides
    pulled = np.asarray(j_ghost).any(axis=1)
    assert pulled.any()
    np.testing.assert_allclose(_np(t_hist1)[n_max:][pulled],
                               np.asarray(j_hist1)[n_max:][pulled], **TOL)


@pytest.mark.parametrize("sync_dtype", ["fp32", "bf16", "int8"])
def test_prefetched_equals_tables_in_the_port(port_fed, sync_dtype):
    """Given the rows the tables-mode pull gathers (round-tripped through
    the wire's codec, as the pod exchange decodes them), the prefetched
    source gives the tables source's outputs bit for bit."""
    _, fed = port_fed
    p0 = {k: _t(v) for k, v in _init_params(fed).items()}
    client, hist1_all, src_f, src_h = _inputs(fed, CLIENT, seed=1)
    cfg = method_config("fedais", tau0=2)
    n_max, g_max, F = fed.n_max, fed.g_max, fed.n_features
    args = (torch.zeros(n_max + g_max, dtype=torch.int32), torch.zeros((g_max, F)),
            torch.full((n_max,), -1.0), 2, 10, 0)
    clients = {k: _t(v) for k, v in client.items()}
    outs = []
    for source, feats, hist in (
            ("tables", _t(fed.features), _t(hist1_all)),
            ("prefetched", quant_roundtrip(_t(src_f), sync_dtype),
             quant_roundtrip(_t(src_h), sync_dtype))):
        one = tfedais.make_local_update(cfg, n_max, ghost_source=source,
                                        sync_dtype=sync_dtype)
        outs.append(one(p0, clients, feats, hist, _t(hist1_all[CLIENT]), *args,
                        tfedais.TorchDraws(5, torch.device("cpu"))))
    (pa, ha, aa, ga, sa), (pb, hb, ab, gb, sb) = outs
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    for a, b in ((ha, hb), (aa, ab), (ga, gb)):
        assert torch.equal(a, b)
    for k in ("loss_all", "epoch_losses", "n_ghost_pulled", "mean_importance_entropy"):
        assert torch.equal(torch.as_tensor(sa[k]), torch.as_tensor(sb[k])), k
    assert sa["n_sync"] == sb["n_sync"] > 0


def test_unknown_ghost_source_raises():
    with pytest.raises(ValueError, match="ghost_source"):
        tfedais.make_local_update(method_config("fedais"), 4, ghost_source="owners")
