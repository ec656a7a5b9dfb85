"""The port's WKV6 module against the reference's, on CPU tensors.

On the CPU, ``repro_torch.kernels.wkv6.ops.wkv6`` takes its plain version
(the CUDA kernel is held against that same plain version on the card by
``chip_smoke.py``); the reference runs its Pallas kernel in interpret
mode, as its own tests do. Inputs come from numpy with a seed. Tolerance:
the reference's own for wkv6, 1e-5 on y and S.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels.wkv6 import ops as jops
from repro.kernels.wkv6 import ref as jref
from repro.models import rwkv as jrwkv
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.wkv6 import ops as tops
from repro_torch.kernels.wkv6 import ref as tref
from repro_torch.models import rwkv as trwkv

TOL = 1e-5


def _inputs(rng, b, t, h, n):
    r, k, v = (rng.standard_normal((b, t, h, n)).astype(np.float32) * 0.5
               for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((b, t, h, n)) - 1.0)).astype(np.float32)
    u = (rng.standard_normal((h, n)) * 0.5).astype(np.float32)
    return r, k, v, w, u


@pytest.mark.parametrize("b,t,h,n", [(1, 16, 1, 32), (2, 77, 2, 32), (1, 40, 3, 64),
                                     (2, 9, 2, 128)])
def test_wkv6_matches_reference(b, t, h, n):
    rng = np.random.default_rng(b * 100 + t + n)
    ins = _inputs(rng, b, t, h, n)
    y, s = tops.wkv6(*(torch.from_numpy(a) for a in ins))
    jins = [jnp.asarray(a) for a in ins]
    for yj, sj in (jops.wkv6(*jins, chunk=16, interpret=True), jref.wkv6_ref(*jins)):
        np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(sj), atol=TOL, rtol=TOL)
    assert y.dtype == torch.float32 and s.shape == (b, h, n, n)
    assert tops.wkv6.launches == 0


def test_wkv6_bf16_inputs_keep_fp32_state():
    """r/k/v in bf16 with w in fp32, as the bf16 model feeds them: y comes
    back in bf16, S in fp32, and both agree with the reference's oracle on
    the same bf16 inputs (y at bf16 rounding)."""
    rng = np.random.default_rng(3)
    r, k, v, w, u = _inputs(rng, 1, 33, 2, 32)
    rb, kb, vb = (torch.from_numpy(a).bfloat16() for a in (r, k, v))
    y, s = tops.wkv6(rb, kb, vb, torch.from_numpy(w), torch.from_numpy(u))
    yj, sj = jref.wkv6_ref(*(jnp.asarray(a, jnp.bfloat16) for a in (r, k, v)),
                           jnp.asarray(w), jnp.asarray(u))
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(yj, np.float32),
                               atol=1e-2, rtol=1e-2)


def test_wkv6_state_streaming():
    """Two halves with the state carried equal the whole (the plain
    version's ``state0``, which the decode step relies on)."""
    rng = np.random.default_rng(7)
    r, k, v, w, u = (torch.from_numpy(a) for a in _inputs(rng, 2, 32, 2, 32))
    y_full, s_full = tref.wkv6_ref(r, k, v, w, u)
    y1, s1 = tref.wkv6_ref(r[:, :16], k[:, :16], v[:, :16], w[:, :16], u)
    y2, s2 = tref.wkv6_ref(r[:, 16:], k[:, 16:], v[:, 16:], w[:, 16:], u, state0=s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, atol=TOL, rtol=TOL)
    torch.testing.assert_close(s2, s_full, atol=TOL, rtol=TOL)


def test_wkv6_empty_sequence():
    y, s = tops.wkv6(*(torch.zeros((2, 0, 2, 32)) for _ in range(4)),
                     torch.zeros((2, 32)))
    assert y.shape == (2, 0, 2, 32) and s.shape == (2, 2, 32, 32)
    assert not s.any()


def test_wkv6_refuses_a_device_without_a_kernel():
    """Only CPU tensors take the plain version: anything else launches the
    kernel or raises (here a meta tensor, which has no kernel)."""
    r = torch.empty((1, 4, 1, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tops.wkv6(r, r, r, r, torch.empty((1, 32), device="meta"))


@pytest.mark.parametrize("use_kernel", [True, False])
def test_rwkv_block_apply_matches_reference(use_kernel):
    """The port's block (WKV through ``ops.wkv6``, or the plain scan) against
    the reference's with its Pallas kernel in interpret mode and with its
    plain scan, at the smoke width (fp32). Block tolerance 1e-4: a dozen
    dense products in another summation order around the recurrence."""
    jc = jax_smoke_config("rwkv6-1.6b")
    tc = get_smoke_config("rwkv6-1.6b")
    jp = jrwkv.rwkv_block_init(jax.random.PRNGKey(1), jc)
    tp = lm_params_from_numpy({"b": jax.tree_util.tree_map(np.asarray, jp)}, tc,
                              "cpu")["b"]
    x = np.random.default_rng(2).standard_normal((2, 21, jc.d_model)).astype(np.float32)
    got = trwkv.rwkv_block_apply(tp, tc, torch.from_numpy(x), use_kernel=use_kernel)
    for jk in (True, False):
        want = jrwkv.rwkv_block_apply(jp, jc, jnp.asarray(x), use_kernel=jk)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
