"""The training forward, importance sampling and the historical store
against the reference's, on CPU tensors.

``gcn_batch_forward`` is held per backend at the reference's own
tolerances (``tests/test_train_backend.py:183,207``): values at 1e-5,
parameter grads at atol 1e-5 / rtol 1e-4; the reference runs jitted, its
spmm backend through the Pallas kernel in interpret mode. The discrete
decisions (quantized keys, stable ranks, sampled batches) are exact given
the same uniforms, ties included; the store's pushes and pulls are exact.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import historical as jhist
from repro.core import importance as jimp
from repro.models import gcn as jgcn
from repro_torch.convert import params_from_numpy
from repro_torch.core import historical as thist
from repro_torch.core import importance as timp
from repro_torch.models import gcn as tgcn


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def batch_case():
    """The reference's awkward batch (tests/test_train_backend.py:150-165):
    isolated rows, duplicate slots, ghost reads, a ragged batch of 7."""
    rng = np.random.default_rng(11)
    n, g_, k, f = 21, 6, 5, 12
    params = {k_: np.asarray(v) for k_, v in
              jgcn.gcn_init(jax.random.PRNGKey(2), f, 3, hidden=(8, 4)).items()}
    feats = rng.standard_normal((n, f)).astype(np.float32)
    ghost = rng.standard_normal((g_, f)).astype(np.float32)
    hist1 = rng.standard_normal((n + g_, 8)).astype(np.float32)
    idx = rng.integers(0, n + g_, (n, k)).astype(np.int32)
    idx[3] = idx[3, 0]
    mask = (rng.random((n, k)) < 0.6).astype(np.float32)
    mask[[0, 7]] = 0.0
    batch = np.array([0, 3, 5, 7, 8, 13, 20], np.int32)
    keep = (rng.random((len(batch), k)) < 0.8).astype(np.float32)
    return params, feats, ghost, hist1, idx, mask, batch, keep


@pytest.mark.parametrize("backend", tgcn.AGG_BACKENDS)
@pytest.mark.parametrize("with_keep", [False, True])
def test_batch_forward_values_match(batch_case, backend, with_keep):
    params, feats, ghost, hist1, idx, mask, batch, keep = batch_case

    j = [jnp.asarray(a) for a in (feats, ghost, hist1, idx, mask, keep)]

    @partial(jax.jit, static_argnums=0)
    def fwd(be, b):
        return jgcn.gcn_batch_forward(params, *j[:5], b,
                                      nbr_keep=j[5] if with_keep else None,
                                      backend=be, interpret=True)

    want = fwd(backend, jnp.asarray(batch))
    got = tgcn.gcn_batch_forward(params_from_numpy(params, "cpu"), _t(feats), _t(ghost),
                                 _t(hist1), _t(idx), _t(mask), _t(batch),
                                 nbr_keep=_t(keep) if with_keep else None, backend=backend)
    for w, g_ in zip(want, got):
        np.testing.assert_allclose(g_.detach().numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("backend", tgcn.AGG_BACKENDS)
def test_batch_forward_grads_match(batch_case, backend):
    """Parameter grads through each backend (spmm: its transposed product
    on the port's side, the custom VJP on the reference's)."""
    params, feats, ghost, hist1, idx, mask, batch, keep = batch_case
    labels = np.arange(len(batch)) % 3

    j = [jnp.asarray(a) for a in (feats, ghost, hist1, idx, mask, batch, keep)]

    def jloss(p):
        logits, _, _ = jgcn.gcn_batch_forward(p, *j[:6], nbr_keep=j[6],
                                              backend=backend, interpret=True)
        return jgcn.per_node_loss(logits, jnp.asarray(labels)).mean()

    want = jax.jit(jax.grad(jloss))({k: jnp.asarray(v) for k, v in params.items()})
    p = {k: v.requires_grad_(True) for k, v in params_from_numpy(params, "cpu").items()}
    logits, h1, _ = tgcn.gcn_batch_forward(p, _t(feats), _t(ghost), _t(hist1), _t(idx),
                                           _t(mask), _t(batch), nbr_keep=_t(keep),
                                           backend=backend)
    loss = tgcn.per_node_loss(logits, _t(labels)).mean()
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    for k in want:
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(want[k]), atol=1e-5,
                                   rtol=1e-4, err_msg=k)
    # the history is detached: only the fresh in-batch rows carry grads
    assert not _t(hist1).requires_grad and h1.requires_grad


def test_quantize_key_is_bit_exact():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(4096).astype(np.float32) * 10.0 ** rng.integers(
        -30, 30, 4096), np.array([0.0, -0.0, 1e-38, -1e-45, np.inf, -np.inf], np.float32)])
    got = timp.quantize_key(_t(x)).numpy()
    want = np.asarray(jimp.quantize_key(jnp.asarray(x)))
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def _keys_with_ties(rng, shape):
    """Keys whose quantized values tie: near-equal draws (the last ULPs
    differ), exact duplicates, and the 2.0 of masked slots."""
    u = rng.random(shape).astype(np.float32)
    u[..., 1::4] = u[..., 0::4][..., : u[..., 1::4].shape[-1]]            # exact ties
    u[..., 2::4] = np.nextafter(u[..., 0::4][..., : u[..., 2::4].shape[-1]],
                                np.float32(1))                              # ULP ties
    u[..., -3:] = 2.0
    return u


@pytest.mark.parametrize("shape", [(7, 12), (256, 32), (33,)])
def test_stable_rank_is_exact(shape):
    keys = _keys_with_ties(np.random.default_rng(1), shape)
    got = timp.stable_rank(_t(keys)).numpy()
    want = np.asarray(jimp.stable_rank(jnp.asarray(keys)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_sample_batch_is_exact_given_the_uniforms(seed):
    rng = np.random.default_rng(seed)
    n, b = 300, 64
    mask = (rng.random(n) < 0.7).astype(np.float32)
    probs = np.asarray(jimp.importance_probs(jnp.asarray(rng.random(n).astype(np.float32)),
                                             jnp.asarray(mask)))
    u = np.array(jax.random.uniform(jax.random.PRNGKey(seed), (n,), minval=1e-20,
                                      maxval=1.0))
    if seed == 3:       # ties: equal probabilities and equal uniforms
        probs = np.where(mask > 0, np.float32(1.0 / mask.sum()), 0).astype(np.float32)
        u[::2] = u[0]
    ji, jv = jimp.sample_batch(jax.random.PRNGKey(seed), jnp.asarray(probs), b,
                               jnp.asarray(mask)) if seed != 3 else (None, None)
    ti, tv = timp.sample_batch(_t(u), _t(probs), b, _t(mask))
    # the reference draws its own uniforms from the key: replay them
    g = -jnp.log(-jnp.log(jnp.asarray(u)))
    logp = jnp.log(jnp.maximum(probs, 1e-30)) + jnp.where(mask > 0, 0.0, -1e30)
    _, want = jax.lax.top_k(jimp.quantize_key(logp + g), b)
    assert np.array_equal(ti.numpy(), np.asarray(want))
    assert np.array_equal(tv.numpy(), mask[np.asarray(want)] > 0)
    if ji is not None:
        assert np.array_equal(ti.numpy(), np.asarray(ji)) and np.array_equal(tv.numpy(),
                                                                              np.asarray(jv))


def test_scores_and_probs_match():
    rng = np.random.default_rng(2)
    n = 200
    curr = rng.random(n).astype(np.float32) * 3
    prev = np.where(rng.random(n) < 0.3, -1.0, rng.random(n) * 3).astype(np.float32)
    mask = (rng.random(n) < 0.8).astype(np.float32)
    s_t = timp.loss_delta_scores(_t(curr), _t(prev), _t(mask))
    s_j = jimp.loss_delta_scores(jnp.asarray(curr), jnp.asarray(prev), jnp.asarray(mask))
    assert np.array_equal(s_t.numpy(), np.asarray(s_j))
    for t_fn, j_fn, args in ((timp.importance_probs, jimp.importance_probs, (s_t, mask)),
                             (timp.uniform_probs, jimp.uniform_probs, (mask,))):
        got = t_fn(*[a if torch.is_tensor(a) else _t(a) for a in args])
        want = j_fn(*[jnp.asarray(np.asarray(a)) for a in args])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    np.testing.assert_allclose(
        float(timp.sampling_variance(_t(s_t.numpy() + 0.1), _t(curr), _t(mask))),
        float(jimp.sampling_variance(jnp.asarray(s_t.numpy() + 0.1), jnp.asarray(curr),
                                     jnp.asarray(mask))), rtol=1e-6)


def test_historical_store_is_exact():
    rng = np.random.default_rng(3)
    K, n_max, g_max, F, H = 4, 10, 6, 5, 3
    n_tot = n_max + g_max
    hist1_all = rng.standard_normal((K, n_tot, H)).astype(np.float32)
    feats_all = rng.standard_normal((K, n_max, F)).astype(np.float32)
    age = rng.integers(0, 5, n_tot).astype(np.int32)
    batch = np.array([7, 0, 3, 12], np.int32)
    values = rng.standard_normal((4, H)).astype(np.float32)
    valid = np.array([True, False, True, True])
    t_h, t_a = thist.push_embeddings(_t(hist1_all[1]), _t(age), _t(batch).long(),
                                     _t(values), _t(valid))
    j_h, j_a = jhist.push_embeddings(jnp.asarray(hist1_all[1]), jnp.asarray(age),
                                     jnp.asarray(batch), jnp.asarray(values),
                                     jnp.asarray(valid))
    assert np.array_equal(t_h.numpy(), np.asarray(j_h))
    assert np.array_equal(t_a.numpy(), np.asarray(j_a)) and t_a.dtype == torch.int32
    owner = np.array([2, -1, 0, 3, 1, -1], np.int32)
    row = np.array([4, 0, 9, 1, 2, 0], np.int32)
    gmask = (owner >= 0).astype(np.float32)
    t_pull = thist.pull_ghosts(_t(hist1_all), _t(feats_all), _t(owner), _t(row), _t(gmask))
    j_pull = jhist.pull_ghosts(jnp.asarray(hist1_all), jnp.asarray(feats_all),
                               jnp.asarray(owner), jnp.asarray(row), jnp.asarray(gmask))
    for a, b in zip(t_pull, j_pull):
        assert np.array_equal(a.numpy(), np.asarray(b))
    t_pre = thist.pull_ghosts_prefetched(t_pull[0], t_pull[1], _t(gmask))
    for a, b in zip(t_pre, t_pull):
        assert torch.equal(a, b)
    node_mask = (rng.random(n_tot) < 0.6).astype(np.float32)
    t_m = thist.staleness_metrics(_t(age), _t(node_mask))
    j_m = jhist.staleness_metrics(jnp.asarray(age), jnp.asarray(node_mask))
    for k in j_m:
        assert float(t_m[k]) == float(j_m[k]), k
    st = thist.init_historical(K, n_max, g_max, F, H, torch.device("cpu"))
    js = jhist.init_historical(K, n_max, g_max, F, H)
    for a, b in zip(st, js):
        assert tuple(a.shape) == b.shape and not a.any()
