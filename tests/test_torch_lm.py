"""The port's LM serving slice against the reference, on CPU tensors.

The reference's own ``init_lm`` params are loaded into the port
(``convert.lm_params_from_numpy``), so both compute the same function; the
kernels take their plain versions on CPU tensors. Configurations: the
smoke variants of ``rwkv6-1.6b`` and ``gemma3-12b`` and ``mini``, all fp32.
Tolerance for the model pieces 1e-5, for the prefill and decode 1e-4
(a few dozen dense products summed in another order). Greedy tokens are
not compared across frameworks: near-ties make argmax fragile.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import list_archs as jax_list_archs
from repro.launch.train import mini_config as jax_mini_config
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch.configs import ModelConfig, get_config, get_smoke_config, list_archs
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.wkv6 import ops as wkv6_ops
from repro_torch.launch.train import mini_config
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm

ARCHS = ["rwkv6-1.6b", "gemma3-12b", "mini"]
TOL = 1e-4
PIECE_TOL = 1e-5


def _configs(name):
    if name == "mini":
        return jax_mini_config(), mini_config()
    return jax_smoke_config(name), get_smoke_config(name)


@pytest.fixture(scope="module")
def models():
    """arch -> (jax cfg, port cfg, jax params, the same params in the port),
    built once per module: the reference's ``init_lm`` compiles per config."""
    cache = {}

    def get(name):
        if name not in cache:
            jc, tc = _configs(name)
            jp = jax.jit(jlm.init_lm, static_argnums=1)(jax.random.PRNGKey(0), jc)
            tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tc, "cpu")
            cache[name] = (jc, tc, jp, tp)
        return cache[name]

    return get


def _assert_trees_close(got: dict, want, tol=TOL):
    want = jax.tree_util.tree_map(np.asarray, want)
    assert (jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want))
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# configurations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "gemma3-12b"])
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_the_reference(arch, smoke):
    got = (get_smoke_config if smoke else get_config)(arch)
    want = (jax_smoke_config if smoke else jax_get_config)(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert got.torch_dtype == getattr(torch, want.dtype)


def test_registry_holds_what_the_port_runs():
    """The registry holds the reference's ten architectures and the port
    runs all ten; ``init_lm`` refuses only a block kind the reference does
    not have either."""
    assert list_archs() == jax_list_archs()
    assert dataclasses.asdict(mini_config()) == dataclasses.asdict(jax_mini_config())
    with pytest.raises(KeyError):
        get_config("gpt-2")
    for arch in list_archs():
        tlm.check_supported(get_config(arch))
        tlm.check_supported(get_smoke_config(arch))
    for cfg in (ModelConfig("x", "audio", 2, 64, 2, 2, 128, 100, block_pattern=("xdec",)),
                ModelConfig("x", "dense", 3, 64, 2, 2, 128, 100,
                            block_pattern=("attn", "conv"))):
        with pytest.raises(NotImplementedError, match="unknown block kinds"):
            tlm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_norms_rope_and_activations_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    pairs = [
        (tlayers.rmsnorm({"scale": torch.from_numpy(scale)}, tx, 1e-6),
         jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jx, 1e-6)),
        (tlayers.groupnorm(tx.reshape(2, 7, 128), 4), jlayers.groupnorm(jx.reshape(2, 7, 128), 4)),
        (tlayers.apply_rope(tx, torch.arange(7)[None], 1e6),
         jlayers.apply_rope(jx, jnp.arange(7)[None], 1e6)),
        (tlayers.apply_rope(tx, torch.tensor([[3]]).expand(2, 1)[:, :1].repeat(1, 7), 1e4),
         jlayers.apply_rope(jx, jnp.full((2, 7), 3), 1e4)),
    ]
    for name in ("silu", "gelu", "relu", "sqrelu"):
        pairs.append((tlayers.activation_fn(name)(tx * 3), jlayers.activation_fn(name)(jx * 3)))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PIECE_TOL,
                                   rtol=PIECE_TOL)


def test_gelu_is_the_tanh_form():
    """jax.nn.gelu defaults to the tanh approximation; the erf form differs
    by up to ~5e-4, far beyond the tolerance."""
    x = torch.linspace(-4, 4, 101)
    got = tlayers.activation_fn("gelu")(x)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(got.numpy(), want, atol=PIECE_TOL, rtol=PIECE_TOL)
    assert (torch.nn.functional.gelu(x) - got).abs().max() > 1e-4


# ---------------------------------------------------------------------------
# the slice: params, forward, prefill, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_has_the_reference_layout(arch):
    jc, tc = _configs(arch)
    tp = tlm.init_lm(torch.Generator().manual_seed(0), tc, "cpu")
    got = lm_params_to_numpy(tp)
    want = jax.eval_shape(lambda: jlm.init_lm(jax.random.PRNGKey(0), jc))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip(arch, models):
    jc, tc, jp, tp = models(arch)
    _assert_trees_close(lm_params_to_numpy(tp), jp, tol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_decode_match_reference(arch, models):
    jc, tc, jp, tp = models(arch)
    rng = np.random.default_rng(1)
    B, S, G = 2, 19, 4
    toks = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)

    # the reference's functions jitted (as its serve_lm_cli jits decode_step):
    # the same values as eager, in a third of the test time
    j_forward = jax.jit(jlm.lm_forward, static_argnums=1)
    j_prefill = jax.jit(jlm.lm_prefill, static_argnums=(1, 3))
    j_decode = jax.jit(jlm.decode_step, static_argnums=1)

    logits, _ = tlm.lm_forward(tp, tc, torch.from_numpy(toks).long())
    jlogits, _ = j_forward(jp, jc, jnp.asarray(toks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=TOL, rtol=TOL)

    last, state = tlm.lm_prefill(tp, tc, torch.from_numpy(toks).long(), S + G)
    jlast, jstate = j_prefill(jp, jc, jnp.asarray(toks), S + G)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=TOL, rtol=TOL)
    _assert_trees_close(lm_params_to_numpy(state), jstate)

    for i in range(G):
        tok = rng.integers(0, jc.vocab_size, (B, 1)).astype(np.int32)
        out, state = tlm.decode_step(tp, tc, state, torch.from_numpy(tok).long(), S + i)
        jout, jstate = j_decode(jp, jc, jstate, jnp.asarray(tok),
                                jnp.asarray(S + i, jnp.int32))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL, rtol=TOL)
    _assert_trees_close(lm_params_to_numpy(state), jstate)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "gemma3-12b"])
def test_plain_path_equals_kernel_path_on_the_cpu(arch, models, monkeypatch):
    """The prefill reaches the kernel wrappers once per block of their kind
    (what ``chip_smoke.py``'s launch counts rest on), ``use_kernel=False``
    never reaches them, and on CPU tensors both give the same answer."""
    _, tc, _, tp = models(arch)
    calls = {}

    def spy(mod, name):
        real = getattr(mod, name)

        def wrapper(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return real(*a, **kw)

        monkeypatch.setattr(mod, name, wrapper)

    spy(wkv6_ops, "wkv6")
    spy(flash_ops, "flash_attention")
    kinds = list(tc.block_pattern) * tc.n_units + list(tc.remainder_pattern)
    n_wkv = kinds.count("rwkv")
    want = {n: c for n, c in (("wkv6", n_wkv), ("flash_attention", len(kinds) - n_wkv)) if c}
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, tc.vocab_size, (2, 17)))
    a, sa = tlm.lm_prefill(tp, tc, toks, 20)
    assert calls == want
    calls.clear()
    b, sb = tlm.lm_prefill(tp, tc, toks, 20, use_kernel=False)
    assert calls == {}
    torch.testing.assert_close(a, b, atol=PIECE_TOL, rtol=PIECE_TOL)
    _assert_trees_close(lm_params_to_numpy(sa), lm_params_to_numpy(sb), tol=PIECE_TOL)
