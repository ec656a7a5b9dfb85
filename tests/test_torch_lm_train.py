"""The port's LM training step against the reference, on CPU tensors.

The reference's own ``init_lm`` params are carried into the port
(``convert.lm_params_from_numpy``), so both differentiate the same
function. For one smoke configuration of each family the training path
reaches (``mini``; internvl2-2b's image tokens; gemma3-12b's local
attention; recurrentgemma-2b's ``rec`` blocks; dbrx-132b's MoE aux loss;
whisper-large-v3's encoder frames and cross attention; rwkv6-1.6b with
``rwkv_chunk`` set, its chunked scan, and with ``rwkv_chunk`` 0, the WKV6
kernels' autograd function ``WKV6`` on its plain pair), ``lm_loss`` and every leaf's
gradient against ``jax.value_and_grad`` of the reference's ``lm_loss``:
loss rtol 1e-5, gradients atol 1e-5 and rtol 1e-4. RWKV's gradients are
ill-conditioned in fp32: one-ulp noise in the params moves the
reference's own gradients by 4.7e-5 of each leaf's largest |g| (which
reaches 12), and the port's differ from the reference's by 6.9e-5 of it,
chunked or not; its leaves are held at an atol of 1e-4 x the leaf's
largest |g| (about twice that spread), rtol 1e-4. Then three
``make_train_step`` steps against the reference's: the loss at 1e-5 and
the grad norm at rtol 1e-5 each step, the params after them at the
gradients' tier. RWKV's grad norm is held at rtol 1e-2 (one-ulp noise in
the params moves the reference's own grad norm over its three steps by up
to 4.5e-4, 2.3e-5 and 3.6e-3 of it, and the port's, chunked or through
``WKV6``, differs from the reference's by 2.1e-4, 4.6e-5 and 1.7e-3), and
in place of its params, each leaf's update over the three steps (after
minus before) at a relative L2 of 5e-2 against the reference's update:
AdamW moves an element by about lr a step whatever the size of its
gradient, so where fp32 noise flips the sign of a near-zero gradient the
params part by up to 2 x lr a step, as large as the update itself. The
same one-ulp noise moves the reference's own update by up to 3.0e-2 of a
leaf (median 1.3e-2); the port's differs from the reference's by up to
7.7e-3 (median 1.2e-3); a missing update gives 1 and a sign-flipped one 2.
Last, ``cfg.remat`` (each unit under ``torch.utils.checkpoint``)
against no remat.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch.train import mini_config as jax_mini_config
from repro.models import lm as jlm
from repro.optim import adamw_init as jadamw_init
from repro.optim.schedules import constant as jconstant
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch.train import mini_config
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw_init, constant

LOSS_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
B, S = 2, 16
ARCHS = ["mini", "internvl2-2b", "gemma3-12b", "recurrentgemma-2b", "dbrx-132b",
         "whisper-large-v3", "rwkv6-1.6b", "rwkv6-1.6b/chunk0"]
# small overrides: mini at 2 layers; RWKV through its chunked scan, and
# ("/chunk0") through WKV6 (the kernels' autograd function; its plain pair
# on CPU tensors)
OVERRIDES = {"mini": {"n_layers": 2, "d_model": 128, "d_ff": 256, "vocab_size": 512},
             "rwkv6-1.6b": {"rwkv_chunk": 8}, "rwkv6-1.6b/chunk0": {"rwkv_chunk": 0}}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch):
    base = arch.split("/")[0]
    jc, tc = ((jax_mini_config(), mini_config()) if base == "mini"
              else (jax_smoke_config(base), get_smoke_config(base)))
    over = OVERRIDES.get(arch, {})
    return dataclasses.replace(jc, **over), dataclasses.replace(tc, **over)


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(arch):
        if arch not in cache:
            jc, tc = _configs(arch)
            jp = jax.jit(jlm.init_lm, static_argnums=1)(jax.random.PRNGKey(0), jc)
            tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tc, "cpu")
            cache[arch] = (jc, tc, jp, tp)
        return cache[arch]

    return get


def _batch(cfg, seed):
    """The same batch as numpy: tokens, labels and the config's extra
    inputs (image embeddings, encoder frames)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.n_image_tokens:
        out["image_embeds"] = rng.standard_normal((B, cfg.n_image_tokens, cfg.d_model),
                                                  dtype=np.float32)
    if cfg.n_encoder_layers:
        out["enc_frames"] = rng.standard_normal((B, cfg.encoder_seq_len, cfg.d_model),
                                                dtype=np.float32)
    return out


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch_batch(b):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in b.items()}


def _leaves(tree, prefix=""):
    """{path: array} of a numpy tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


@dataclasses.dataclass(frozen=True)
class NoisyTol:
    """Where fp32 noise is larger than the tiers (see the module's
    docstring): each leaf's gradient atol as a share of its largest |g|,
    the train step's grad norm rtol, and the relative L2 of each leaf's
    update over the three train steps against the reference's."""
    grad_atol_share: float
    grad_norm_rtol: float
    update_rel_l2: float


# by base arch (the part before "/")
NOISY = {"rwkv6-1.6b": NoisyTol(grad_atol_share=1e-4, grad_norm_rtol=1e-2, update_rel_l2=5e-2)}


def _assert_grads_close(got_tree, want_tree, tol=None):
    got = _leaves(lm_params_to_numpy(got_tree))
    want = _leaves(jax.tree_util.tree_map(np.asarray, want_tree))
    assert got.keys() == want.keys()
    for path in sorted(want):
        atol = (GRAD_ATOL if tol is None
                else tol.grad_atol_share * float(np.abs(want[path]).max()))
        np.testing.assert_allclose(got[path], want[path], atol=atol, rtol=GRAD_RTOL,
                                   err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_reference(arch, models):
    jc, tc, jp, tp = models(arch)
    b = _batch(tc, 1)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p, bb: jlm.lm_loss(p, jc, bb), has_aux=True))(jp, _jax_batch(b))
    loss, metrics, grads = tlm.loss_and_grads(tp, tc, _torch_batch(b))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(float(metrics["aux"]), float(jmetrics["aux"]), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    assert (float(metrics["aux"]) > 0) == bool(tc.n_experts)
    _assert_grads_close(grads, jgrads, NOISY.get(arch.split("/")[0]))


@pytest.mark.parametrize("arch", ["mini", "gemma3-12b", "rwkv6-1.6b/chunk0"])
def test_three_train_steps_match_reference(arch, models):
    jc, tc, jp, tp = models(arch)
    tol = NOISY.get(arch.split("/")[0])
    jp0, tp0 = _leaves(jax.tree_util.tree_map(np.asarray, jp)), _leaves(lm_params_to_numpy(tp))
    jstep = jax.jit(jlm.make_train_step(jc, jconstant(1e-4)))
    tstep = tlm.make_train_step(tc, constant(1e-4))
    jopt, topt = jadamw_init(jp), adamw_init(tp)
    for i in range(3):
        b = _batch(tc, 10 + i)
        jp, jopt, jm = jstep(jp, jopt, _jax_batch(b))
        tp, topt, tm = tstep(tp, topt, _torch_batch(b))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_TOL,
                                   atol=LOSS_TOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-5 if tol is None else tol.grad_norm_rtol)
        assert tm["lr"] == float(np.asarray(jm["lr"]))
    assert topt.step == int(jopt.step) == 3
    if tol is None:
        _assert_grads_close(tp, jp)
        return
    jp1, tp1 = _leaves(jax.tree_util.tree_map(np.asarray, jp)), _leaves(lm_params_to_numpy(tp))
    assert jp1.keys() == tp1.keys()
    for path in sorted(jp1):
        want = jp1[path].astype(np.float64) - jp0[path]
        got = tp1[path].astype(np.float64) - tp0[path]
        assert np.linalg.norm(want) > 0, path
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= tol.update_rel_l2, f"{path}: update relative L2 {err}"


@pytest.mark.parametrize("arch", ["mini", "whisper-large-v3"])
def test_remat_gives_the_same_gradients(arch, models, monkeypatch):
    _, tc, _, tp = models(arch)
    b = _torch_batch(_batch(tc, 2))
    calls = {"n": 0}
    real = flash_ops.flash_attention

    def spy(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(flash_ops, "flash_attention", spy)
    loss, _, grads = tlm.loss_and_grads(tp, tc, b)
    plain_calls, calls["n"] = calls["n"], 0
    loss_r, _, grads_r = tlm.loss_and_grads(tp, dataclasses.replace(tc, remat=True), b)
    # each unit's blocks run again in the backward: more attention calls
    assert calls["n"] > plain_calls
    assert float(loss_r) == float(loss)
    for g, gr in zip(jax.tree_util.tree_leaves(lm_params_to_numpy(grads)),
                     jax.tree_util.tree_leaves(lm_params_to_numpy(grads_r))):
        np.testing.assert_array_equal(g, gr)


def test_train_step_leaves_its_inputs_alone(models):
    _, tc, _, tp = models("mini")
    before = [a.copy() for a in jax.tree_util.tree_leaves(lm_params_to_numpy(tp))]
    opt = adamw_init(tp)
    new, opt2, m = tlm.make_train_step(tc, constant(1e-3))(tp, opt, _torch_batch(_batch(tc, 3)))
    after = jax.tree_util.tree_leaves(lm_params_to_numpy(tp))
    assert all(np.array_equal(a, b) for a, b in zip(before, after))
    assert opt.step == 0 and opt2.step == 1
    from repro_torch.utils.tree import tree_leaves

    assert not any(t.requires_grad for t in tree_leaves(new) + tree_leaves(tp))
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
