"""The port's flash attention module against the reference's, on CPU
tensors.

On the CPU, ``repro_torch.kernels.flash_attention.ops.flash_attention``
takes its plain version (the CUDA kernel is held against that same plain
version on the card by ``chip_smoke.py``); the reference runs its Pallas
kernel in interpret mode, as its own tests do. Inputs come from numpy with
a seed. Tolerance: the reference's own for attention, 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention import ref as jref
from repro.models import attention as jattn
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.models import attention as tattn

TOL = 2e-5

CASES = [
    # b, s, h, hkv, hd, causal, window
    (1, 64, 2, 2, 32, True, None),
    (2, 100, 4, 2, 64, True, None),      # ragged S, GQA 2:1
    (1, 77, 4, 1, 32, True, 16),         # ragged S, GQA 4:1, window
    (1, 50, 4, 2, 240, True, None),      # gemma3's head_dim at a short S
    (1, 40, 4, 2, 240, True, 8),
    (2, 33, 2, 2, 16, False, None),      # not causal
    (1, 20, 2, 1, 32, True, 64),         # window wider than S
]


def _qkv(rng, b, s, h, hkv, hd):
    return (rng.standard_normal((b, s, h, hd)).astype(np.float32),
            rng.standard_normal((b, s, hkv, hd)).astype(np.float32),
            rng.standard_normal((b, s, hkv, hd)).astype(np.float32))


@pytest.mark.parametrize("b,s,h,hkv,hd,causal,window", CASES)
def test_flash_attention_matches_reference(b, s, h, hkv, hd, causal, window):
    rng = np.random.default_rng(s * 10 + hd)
    q, k, v = _qkv(rng, b, s, h, hkv, hd)
    got = tops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=causal, window=window)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    for want in (jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                      block_q=32, block_k=32, interpret=True),
                 jref.attention_ref(jq, jk, jv, causal=causal, window=window)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    assert tops.flash_attention.launches == 0


def test_flash_attention_refuses_a_device_without_a_kernel():
    """Only CPU tensors take the plain version: anything else launches the
    kernel or raises (here a meta tensor, which has no kernel)."""
    q = torch.empty((1, 8, 2, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tops.flash_attention(q, q, q)


@pytest.mark.parametrize("window", [None, 16])
def test_flash_attention_bf16_matches_reference(window):
    """bf16 inputs, GQA 2:1, gemma3's head_dim: the output comes back in
    bf16, within one bf16 ulp (rtol 2^-7) of the reference's kernel and its
    plain version (atol 1e-4 for outputs near 0), the same tolerance
    ``chip_smoke.py`` holds the CUDA kernel to in bf16."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(rng, 1, 45, 4, 2, 240))
    got = tops.flash_attention(q, k, v, causal=True, window=window)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in (q, k, v))
    for want in (jops.flash_attention(jq, jk, jv, causal=True, window=window,
                                      block_q=32, block_k=32, interpret=True),
                 jref.attention_ref(jq, jk, jv, causal=True, window=window)):
        assert want.dtype == jnp.bfloat16
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=1e-4, rtol=2.0 ** -7)


@pytest.mark.parametrize("kind", ["causal", "local"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_multihead_attn_matches_reference(kind, use_kernel):
    """gemma3's smoke width (GQA 2:1, rope, window 8), fp32: the port's
    ``multihead_attn`` (through ``ops.flash_attention`` or its plain version)
    and the roped K/V it returns for the cache, against the reference's.
    1e-4: the projections around the attention sum in another order."""
    jc = jax_smoke_config("gemma3-12b")
    tc = get_smoke_config("gemma3-12b")
    jp = jattn.attn_init(jax.random.PRNGKey(3), jc)
    tp = lm_params_from_numpy({"a": jax.tree_util.tree_map(np.asarray, jp)}, tc,
                              "cpu")["a"]
    x = np.random.default_rng(4).standard_normal((2, 19, jc.d_model)).astype(np.float32)
    out, (k, v) = tattn.multihead_attn(tp, tc, torch.from_numpy(x), kind=kind,
                                       return_kv=True, use_kernel=use_kernel)
    jout, (jk, jv) = jattn.multihead_attn(jp, jc, jnp.asarray(x), kind=kind,
                                          return_kv=True)
    for a, b in ((out, jout), (k, jk), (v, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kind", ["causal", "local"])
def test_decode_attn_matches_reference(kind):
    """One decode token against a half-filled cache: the output, and the
    cache written at ``pos`` (in place in the port)."""
    jc = jax_smoke_config("gemma3-12b")
    tc = get_smoke_config("gemma3-12b")
    jp = jattn.attn_init(jax.random.PRNGKey(6), jc)
    tp = lm_params_from_numpy({"a": jax.tree_util.tree_map(np.asarray, jp)}, tc,
                              "cpu")["a"]
    rng = np.random.default_rng(8)
    cache = {n: rng.standard_normal((2, 24, jc.n_kv_heads, jc.resolved_head_dim)
                                    ).astype(np.float32) for n in ("k", "v")}
    x = rng.standard_normal((2, 1, jc.d_model)).astype(np.float32)
    pos = 13
    tcache = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    out, tcache2 = tattn.decode_attn(tp, tc, torch.from_numpy(x), tcache, pos, kind=kind)
    jout, jcache = jattn.decode_attn(jp, jc, jnp.asarray(x),
                                     {n: jnp.asarray(a) for n, a in cache.items()},
                                     jnp.asarray(pos, jnp.int32), kind=kind)
    assert tcache2 is tcache
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-4, rtol=1e-4)
    for n in ("k", "v"):
        np.testing.assert_allclose(tcache[n].numpy(), np.asarray(jcache[n]),
                                   atol=1e-4, rtol=1e-4)
