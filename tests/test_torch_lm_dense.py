"""The smoke configs of the three dense families the port now registers,
deepseek-67b, llama3-405b and nemotron-4-15b (fp32; nemotron's squared-ReLU
MLP is not gated), end to end against the reference on CPU tensors, the
port loaded with the reference's own ``init_lm`` params: forward logits,
prefill (logits and decode state) and 4 decode steps at 1e-4, the
reference jitted on the CPU as its tests run it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.models import lm as jlm
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.models import lm as tlm

TOL = 1e-4
FAMILIES = ["deepseek-67b", "llama3-405b", "nemotron-4-15b"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(arch):
        if arch not in cache:
            jc, tc = jsmoke(arch), get_smoke_config(arch)
            jp = jax.jit(jlm.init_lm, static_argnums=1)(jax.random.PRNGKey(0), jc)
            cache[arch] = (jc, tc, jp, lm_params_from_numpy(_np(jp), tc, "cpu"))
        return cache[arch]

    return get


def _assert_trees_close(got, want, tol=TOL):
    want = _np(want)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_prefill_and_decode_match_reference(arch, models):
    jc, tc, jp, tp = models(arch)
    rng = np.random.default_rng(1)
    B, S, G = 2, 19, 4
    toks = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    logits, aux = tlm.lm_forward(tp, tc, torch.from_numpy(toks).long())
    jlogits, jaux = jax.jit(jlm.lm_forward, static_argnums=1)(jp, jc, jnp.asarray(toks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), atol=TOL, rtol=TOL)
    assert (float(aux) > 0) == bool(tc.n_experts)

    last, state = tlm.lm_prefill(tp, tc, torch.from_numpy(toks).long(), S + G)
    jlast, jstate = jax.jit(jlm.lm_prefill, static_argnums=(1, 3))(jp, jc, jnp.asarray(toks),
                                                                   S + G)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=TOL, rtol=TOL)
    _assert_trees_close(lm_params_to_numpy(state), jstate)
    j_decode = jax.jit(jlm.decode_step, static_argnums=1)
    for i in range(G):
        tok = rng.integers(0, jc.vocab_size, (B, 1)).astype(np.int32)
        out, state = tlm.decode_step(tp, tc, state, torch.from_numpy(tok).long(), S + i)
        jout, jstate = j_decode(jp, jc, jstate, jnp.asarray(tok), jnp.asarray(S + i, jnp.int32))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL, rtol=TOL)
    _assert_trees_close(lm_params_to_numpy(state), jstate)
