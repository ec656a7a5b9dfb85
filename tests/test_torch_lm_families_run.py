"""The smoke configs of the Griffin, MoE and dense families end to end on
the port, against the reference, on CPU tensors.

recurrentgemma-2b, dbrx-132b and arctic-480b (fp32; the dense
deepseek-67b, llama3-405b and nemotron-4-15b are in
``test_torch_lm_dense.py``), the port loaded with the reference's own
``init_lm`` params: forward logits and aux loss, prefill (logits and
decode state) and 4 decode steps at 1e-4, the reference jitted on the CPU
as its tests run it; a prompt shorter than Griffin's convolution; the
prefill's kernel calls (flash attention once per ``attn``/``local``
block, nothing for ``rec`` blocks and the MoE FFN) and ``serve_lm_cli``
on the CPU.
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.models import lm as jlm
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.wkv6 import ops as wkv6_ops
from repro_torch.launch import serve_lm_cli
from repro_torch.models import lm as tlm

TOL = 1e-4
FAMILIES = ["recurrentgemma-2b", "dbrx-132b", "arctic-480b"]


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


def test_rec_state_of_a_prompt_shorter_than_the_convolution(models):
    """``collect_state`` keeps the last K−1 rows of the convolution's input,
    zeros in front when the prompt is shorter (T = 2 < K − 1 = 3)."""
    jc, tc, jp, tp = models("recurrentgemma-2b")
    toks = np.array([[5, 7], [1, 2]], np.int32)
    _, state = tlm.lm_prefill(tp, tc, torch.from_numpy(toks).long(), 4)
    _, jstate = jax.jit(jlm.lm_prefill, static_argnums=(1, 3))(jp, jc, jnp.asarray(toks), 4)
    _assert_trees_close(lm_params_to_numpy(state), jstate)
    conv = state["units"][0]["b0"]["conv"]
    assert conv.shape[1] == tc.conv1d_width - 1 and (conv[:, 0] == 0).all()




@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "dbrx-132b"])
def test_prefill_reaches_flash_once_per_attention_block(arch, models, monkeypatch):
    """``rec`` blocks and the MoE FFN launch no kernel: the prefill calls
    flash attention once per ``attn``/``local`` block and nothing else (what
    ``chip_smoke.py``'s launch gates rest on); ``serve_lm_cli`` serves the
    arch on the CPU."""
    _, tc, _, tp = models(arch)
    calls = {}
    for mod, name in ((flash_ops, "flash_attention"), (wkv6_ops, "wkv6")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, spy)
    kinds = list(tc.block_pattern) * tc.n_units + list(tc.remainder_pattern)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, tc.vocab_size, (2, 9)))
    tlm.lm_prefill(tp, tc, toks, 12)
    assert calls == {"flash_attention": sum(k in ("attn", "local") for k in kinds)}
    args = argparse.Namespace(arch=arch, batch=1, prompt_len=6, gen=3, seed=0, device="cpu")
    out = serve_lm_cli.serve(args)
    assert tuple(out["tokens"].shape) == (1, 3)
