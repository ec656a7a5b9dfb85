"""The port's two examples against the reference's own calls, on the CPU.

The reference's ``examples/*.py`` take no arguments, so the reference side
here runs the calls those examples make (``FedEngine`` and
``method_config``; ``gcn_batch_forward``, ``embedding_error`` and
``sampling_variance``) at the port example's settings: Pubmed at scale 64,
3 rounds.

quickstart: FedAIS and FedAll from the reference's initial params, the
port replaying the reference's key chain (``test_torch_fedais.JaxDraws``),
held at the whole-run tier (``test_torch_engine.assert_whole_run_tier``):
the same cohorts, tau and flops; the comm bytes equal in round 0 and
within 1% after (FedAIS's third round moves 1,536 bytes of 19.3 MB: a node
near a tie in the importance scores changes sides after AdamW amplifies a
rounding difference); accuracy within the tier's band.

variance_analysis: from the reference's ``gcn_init`` params, the staleness
noise the same numpy draw on both sides: the error rows and the Eq. 7
objectives at 1e-4, under the port's gather and spmm backends.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import FedEngine as JEngine
from repro.api import method_config as j_method_config
from repro.core.importance import importance_probs as j_importance_probs
from repro.core.importance import sampling_variance as j_sampling_variance
from repro.core.importance import uniform_probs as j_uniform_probs
from repro.core.variance import embedding_error as j_embedding_error
from repro.core.variance import theorem1_bound as j_theorem1_bound
from repro.federated.partition import partition_graph as j_partition_graph
from repro.graph.csr import build_padded_neighbors as j_build_padded_neighbors
from repro.graph.data import make_dataset as j_make_dataset
from repro.models import gcn as jgcn
from repro_torch.api import protocols as tprotocols
from repro_torch.convert import params_from_numpy
from repro_torch.examples import quickstart, variance_analysis
from test_torch_engine import JRecording, assert_whole_run_tier
from test_torch_fedais import JaxDraws, _init_params

SCALE, ROUNDS = 64, 3
TOL = 1e-4


@pytest.fixture(scope="module")
def quick_runs():
    """The port's quickstart (gather) and the reference's calls, each
    method's cohorts recorded."""
    args = quickstart.build_args(["--device", "cpu", "--scale", str(SCALE),
                                  "--rounds", str(ROUNDS)])
    g = j_make_dataset("pubmed", scale=SCALE, seed=quickstart.SEED)
    fed = j_partition_graph(g, n_clients=quickstart.CLIENTS, alpha=0.5, seed=quickstart.SEED)
    ref = {}
    for method in quickstart.METHODS:
        sel = JRecording()
        mcfg = j_method_config(method, tau0=4 if method == "fedais" else 1)
        res = JEngine(g, fed, mcfg, rounds=ROUNDS, clients_per_round=quickstart.COHORT,
                      seed=quickstart.SEED, verbose=False, selector=sel).run()
        ref[method] = (res, sel.cohorts)

    cohorts = []
    real_select = tprotocols.UniformSelector.select

    def recording(self, engine, state):
        sel = real_select(self, engine, state)
        cohorts.append(np.asarray(sel).tolist())
        return sel

    def init_state(eng):
        return eng.init_state(params=params_from_numpy(_init_params(eng.fed, quickstart.SEED),
                                                       "cpu"),
                              draws=JaxDraws(quickstart.SEED))

    tprotocols.UniformSelector.select = recording
    try:
        got = quickstart.run(args, init_state=init_state)
    finally:
        tprotocols.UniformSelector.select = real_select
    return ref, got, cohorts


@pytest.mark.parametrize("method", quickstart.METHODS)
def test_quickstart_matches_the_reference(quick_runs, method):
    ref, got, cohorts = quick_runs
    res, ref_cohorts = ref[method]
    mine = got[method]
    i = quickstart.METHODS.index(method)
    assert_whole_run_tier(mine, res, cohorts[i * ROUNDS:(i + 1) * ROUNDS], ref_cohorts)


def test_quickstart_fedais_saves_embedding_bytes(quick_runs):
    """What the example shows: FedAIS syncs far fewer embedding bytes."""
    _, got, _ = quick_runs
    assert got["fedais"].final["comm_embed_bytes"] < got["fedall"].final["comm_embed_bytes"]


def _reference_variance(params, z):
    """examples/variance_analysis.py's calls at ``SCALE``, with the noise
    draw ``z`` in place of ``jax.random.normal(key, shape)``."""
    g = j_make_dataset("pubmed", scale=SCALE, seed=0)
    idx, mask = j_build_padded_neighbors(g.adjacency_lists(), 16)
    feats, labels = jnp.asarray(g.features), jnp.asarray(g.labels)
    idx, mask = jnp.asarray(idx), jnp.asarray(mask)
    n = g.n_nodes
    h1_exact = jgcn._sage_layer(params, 0, feats, jgcn._aggregate(feats, idx, mask))
    batch = jnp.arange(n // 2)
    h2_exact_logits = jgcn.gcn_full_forward(params, feats, idx, mask)[: n // 2]
    rows = []
    for staleness in variance_analysis.STALENESS:
        noise = staleness * jnp.asarray(z) * h1_exact.std()
        hist1 = jnp.concatenate([h1_exact + noise, jnp.zeros((1, 256))])
        logits, _, _ = jgcn.gcn_batch_forward(params, feats, jnp.zeros((1, g.n_features)),
                                              hist1, idx, mask, batch)
        err = j_embedding_error(logits, h2_exact_logits, jnp.ones(n // 2))
        bound = j_theorem1_bound(1.0, float(jnp.abs(noise).max() + 1e-9),
                                 float(mask.sum(1).mean()), 2)
        rows.append((float(err), bound))
    logits = jgcn.gcn_full_forward(params, feats, idx, mask)
    losses = jgcn.per_node_loss(logits, labels)
    ones = jnp.ones(n)
    v_imp = float(j_sampling_variance(j_importance_probs(losses, ones), losses, ones))
    v_uni = float(j_sampling_variance(j_uniform_probs(ones), losses, ones))
    return rows, v_imp, v_uni, n


@pytest.mark.parametrize("backend", ["gather", "spmm"])
def test_variance_analysis_matches_the_reference(backend):
    g = j_make_dataset("pubmed", scale=SCALE, seed=0)
    jp = jgcn.gcn_init(jax.random.PRNGKey(0), g.n_features, g.n_classes)
    z = np.random.default_rng(1).standard_normal((g.n_nodes, 256)).astype(np.float32)
    rows, v_imp, v_uni, n = _reference_variance(jp, z)
    args = variance_analysis.build_args(["--device", "cpu", "--scale", str(SCALE),
                                         "--backend", backend])
    got = variance_analysis.run(args, params=params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()}, "cpu"), noise=torch.from_numpy(z))
    assert [r["staleness"] for r in got["staleness"]] == list(variance_analysis.STALENESS)
    for r, (err, bound) in zip(got["staleness"], rows):
        np.testing.assert_allclose(r["err"], err, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(r["bound"], bound, rtol=TOL)
        assert r["logit_variance"] == 0.0       # one draw
    np.testing.assert_allclose(got["v_imp"], v_imp, rtol=TOL)
    np.testing.assert_allclose(got["v_uni"], v_uni, rtol=TOL)
    assert got["v_imp"] < got["v_uni"]
    assert got["staleness"][0]["err"] < 1e-5 < got["staleness"][-1]["err"]


def test_examples_main_runs_on_the_cpu(capsys):
    """Both ``main(argv)`` run end to end with their own seeded draws;
    more noise draws give a logit variance that grows with staleness."""
    assert quickstart.main(["--device", "cpu", "--scale", str(SCALE), "--rounds", "1",
                            "--backend", "spmm"]) == 0
    out = capsys.readouterr().out
    assert "fedais" in out and "fedall" in out
    args = variance_analysis.build_args(["--device", "cpu", "--scale", str(SCALE),
                                         "--rounds", "3"])
    res = variance_analysis.run(args)
    lv = [r["logit_variance"] for r in res["staleness"]]
    assert lv[0] < 1e-10 < lv[1] < lv[2] < lv[3]
    assert res["v_imp"] < res["v_uni"]
