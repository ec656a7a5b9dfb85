"""The flash attention autograd function of the port against the reference,
on CPU tensors (where the function runs the kernels' plain versions,
``attention_ref`` with ``return_lse``, ``attention_bwd_dq_ref`` and
``attention_bwd_dkdv_ref``).

* forward output and the rows' log-sum-exp against the reference's
  ``_flash_fwd_impl`` (lse = m + log l), and dq/dk/dv against ``jax.vjp``
  of its ``_chunked_attention`` (the flash ``custom_vjp``): causal, local
  window, GQA and MQA, S not a multiple of the chunk;
* unmasked self attention and cross attention (Sq != Sk) against
  ``jax.vjp`` of ``_einsum_attention``;
* the function's gradients against torch autograd of ``attention_ref``,
  rows with no live key included (Sq > Sk under a window);
* the backward calls the dk/dv kernel's wrapper only when k or v wants a
  gradient (the dq one always: it writes the delta the other reads).

fp32; values 1e-5, gradients 1e-4 (the reference's own tests hold the two
attention routes at 2e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels.flash_attention import ops, ref

VAL_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, Sq, Sk, H, Hkv, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, hd), dtype=np.float32)
    k = rng.standard_normal((B, Sk, Hkv, hd), dtype=np.float32)
    v = rng.standard_normal((B, Sk, Hkv, hd), dtype=np.float32)
    do = rng.standard_normal((B, Sq, H, hd), dtype=np.float32)
    return q, k, v, do


def _port(q, k, v, do, causal, window):
    """(o, lse, (dq, dk, dv)) of the port's function on CPU tensors."""
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert isinstance(o.grad_fn, ops.FlashAttention._backward_cls)
    grads = torch.autograd.grad(o, (qt, kt, vt), torch.tensor(do))
    _, lse = ops.flash_attention_lse(qt.detach(), kt.detach(), vt.detach(), causal=causal,
                                     window=window)
    return o.detach().numpy(), lse.numpy(), [g.numpy() for g in grads]


# (B, S, H, Hkv, hd, kind, window, chunk)
CHUNKED = {
    "causal": (2, 64, 4, 2, 16, "causal", None, 16),
    "local": (2, 64, 4, 2, 16, "local", 24, 16),
    "gqa_3": (1, 48, 6, 2, 8, "causal", None, 16),
    "mqa_local": (2, 48, 4, 1, 16, "local", 10, 16),
    "ragged_s": (2, 50, 4, 2, 16, "causal", None, 16),
    "ragged_s_local": (1, 45, 4, 2, 8, "local", 7, 16),
}


@pytest.mark.parametrize("case", sorted(CHUNKED))
def test_function_against_reference_flash_vjp(case):
    B, S, H, Hkv, hd, kind, window, chunk = CHUNKED[case]
    q, k, v, do = _inputs(sorted(CHUNKED).index(case), B, S, S, H, Hkv, hd)
    o, lse, grads = _port(q, k, v, do, True, window if kind == "local" else None)

    def f(q, k, v):
        return jattn._chunked_attention(q, k, v, kind=kind, window=window, chunk=chunk)

    want, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(o, np.asarray(want), atol=VAL_TOL, rtol=VAL_TOL)
    for got, exp in zip(grads, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(got, np.asarray(exp), atol=GRAD_TOL, rtol=GRAD_TOL)
    if S % chunk == 0:
        # lse = m + log l of the reference's forward, in its grouped layout
        R = H // Hkv
        qg = jnp.asarray(q).transpose(0, 2, 1, 3).reshape(B, Hkv, R, S, hd)
        kg, vg = (jnp.asarray(a).transpose(0, 2, 1, 3) for a in (k, v))
        out, m, l_ = jattn._flash_fwd_impl(qg, kg, vg, kind,
                                           window if kind == "local" else None, chunk)
        np.testing.assert_allclose(
            o, np.asarray(out.reshape(B, H, S, hd).transpose(0, 2, 1, 3)), atol=VAL_TOL,
            rtol=VAL_TOL)
        np.testing.assert_allclose(lse, np.asarray((m + jnp.log(l_)).reshape(B, H, S)),
                                   atol=VAL_TOL, rtol=VAL_TOL)


# (B, Sq, Sk, H, Hkv, hd)
EINSUM = {"bidir": (2, 40, 40, 4, 2, 16), "cross": (2, 20, 33, 4, 4, 16),
          "cross_gqa": (1, 33, 20, 6, 2, 8)}


@pytest.mark.parametrize("case", sorted(EINSUM))
def test_unmasked_and_cross_against_reference_einsum_vjp(case):
    B, Sq, Sk, H, Hkv, hd = EINSUM[case]
    q, k, v, do = _inputs(7, B, Sq, Sk, H, Hkv, hd)
    o, lse, grads = _port(q, k, v, do, False, None)

    def f(q, k, v):
        return jattn._einsum_attention(q, k, v, kind="bidir", window=None)

    want, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(o, np.asarray(want), atol=VAL_TOL, rtol=VAL_TOL)
    for got, exp in zip(grads, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(got, np.asarray(exp), atol=GRAD_TOL, rtol=GRAD_TOL)
    # lse: the log-sum-exp of the reference's scaled scores
    s = np.einsum("bqhd,bkhd->bhqk", q, np.repeat(k, H // Hkv, axis=2)) * hd ** -0.5
    np.testing.assert_allclose(lse, np.asarray(jax.nn.logsumexp(s, axis=-1)), atol=VAL_TOL,
                               rtol=VAL_TOL)


# (B, Sq, Sk, H, Hkv, hd, causal, window)
AUTOGRAD = {
    "causal_gqa": (2, 37, 37, 4, 2, 16, True, None),
    "local": (2, 37, 37, 4, 2, 16, True, 8),
    "unmasked_cross": (1, 20, 33, 4, 4, 8, False, None),
    "causal_cross": (1, 20, 33, 4, 1, 8, True, None),
    "past_sk_window": (1, 33, 20, 4, 2, 8, True, 6),
}


@pytest.mark.parametrize("case", sorted(AUTOGRAD))
def test_function_against_autograd_of_the_plain_version(case):
    B, Sq, Sk, H, Hkv, hd, causal, window = AUTOGRAD[case]
    q, k, v, do = _inputs(3, B, Sq, Sk, H, Hkv, hd)
    o, lse, grads = _port(q, k, v, do, causal, window)
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    want = ref.attention_ref(qt, kt, vt, causal=causal, window=window)
    expect = torch.autograd.grad(want, (qt, kt, vt), torch.tensor(do))
    np.testing.assert_allclose(o, want.detach().numpy(), atol=VAL_TOL, rtol=VAL_TOL)
    for got, exp in zip(grads, expect):
        np.testing.assert_allclose(got, exp.numpy(), atol=GRAD_TOL, rtol=GRAD_TOL)
    if case == "past_sk_window":
        # rows whose window lies wholly past Sk: lse +inf, output and dq 0
        dead = np.arange(Sq) - window + 1 > Sk - 1
        assert dead.any() and np.isinf(lse[:, :, dead]).all()
        assert np.isfinite(lse[:, :, ~dead]).all()
        assert (o[:, dead] == 0).all() and (grads[0][:, dead] == 0).all()


def test_no_gradient_takes_the_plain_forward_and_moves_no_counter():
    q, k, v, _ = _inputs(1, 1, 16, 16, 2, 2, 8)
    before = (ops.flash_attention.launches, ops.flash_bwd_dq.launches,
              ops.flash_bwd_dkdv.launches)
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    with torch.no_grad():
        o = ops.flash_attention(qt, kt, vt)
    assert o.grad_fn is None
    np.testing.assert_array_equal(o.numpy(), ref.attention_ref(qt, kt, vt).detach().numpy())
    y = ops.flash_attention(qt, kt, vt)
    y.sum().backward()
    assert qt.grad is not None and kt.grad is not None and vt.grad is not None
    assert (ops.flash_attention.launches, ops.flash_bwd_dq.launches,
            ops.flash_bwd_dkdv.launches) == before


# the inputs that want a gradient -> (dq wrapper calls, dk/dv wrapper calls)
WANT = {"q": (1, 0), "kv": (1, 1), "qkv": (1, 1)}


@pytest.mark.parametrize("which", sorted(WANT))
def test_gradient_only_for_the_inputs_that_want_one(monkeypatch, which):
    calls = {"dq": 0, "dkdv": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(ops, "flash_bwd_dq", spy("dq", ops.flash_bwd_dq))
    monkeypatch.setattr(ops, "flash_bwd_dkdv", spy("dkdv", ops.flash_bwd_dkdv))
    q, k, v, do = _inputs(4, 1, 20, 20, 4, 2, 8)
    ins = [torch.tensor(a, requires_grad=n in which) for n, a in zip("qkv", (q, k, v))]
    wants = [t for t in ins if t.requires_grad]
    o = ops.flash_attention(*ins, causal=True, window=7)
    got = torch.autograd.grad(o, wants, torch.tensor(do))
    assert (calls["dq"], calls["dkdv"]) == WANT[which]
    plain = [t.detach().requires_grad_(t.requires_grad) for t in ins]
    want = torch.autograd.grad(ref.attention_ref(*plain, causal=True, window=7),
                               [t for t in plain if t.requires_grad], torch.tensor(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=GRAD_TOL, rtol=GRAD_TOL)
