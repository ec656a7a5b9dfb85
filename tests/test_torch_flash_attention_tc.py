"""The arithmetic of the bf16 tensor-core flash attention kernel, on the CPU.

``csrc/flash_attention.cu::flash_fwd_tc_kernel`` runs only on the card.
This file keeps a plain-torch emulation of the order in which it computes,
and holds that emulation against the port's plain version
(``attention_ref``) and against the JAX package's Pallas kernel in
interpret mode, at the bf16 tolerance ``chip_smoke.py`` holds the kernel
to (rtol 2^-7, one bf16 ulp; atol 1e-4 for outputs near 0). The order:

* 128-row query tiles as two 64-row halves (one consumer warpgroup each);
  64-key tiles in ascending order, the tiles that leave no pair of a half
  live skipped;
* hd zero-padded to 64, 128 or 256;
* S = Q K^T of the bf16 values, summed in fp32;
* the online softmax in fp32, in base 2 with the scale folded in, a masked
  score contributing exactly 0;
* P in two bf16 terms, hi = bf16(p) and lo = bf16(p - hi), both multiplied
  into the fp32 accumulator; the row sum l adds the fp32 p.

Inputs come from numpy with a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops
from repro_torch.kernels.flash_attention.ref import attention_ref

RTOL, ATOL = 2.0 ** -7, 1e-4
BQ, HALF, BK = 128, 64, 64


def tc_emulate(q, k, v, *, causal, window=None, split_p=True):
    """The kernel's order of operations on bf16 q (B, Sq, H, hd), k, v
    (B, Sk, Hkv, hd); returns bf16 (B, Sq, H, hd). ``split_p=False`` rounds
    P to bf16 once instead (what FlashAttention and SDPA do)."""
    B, S, H, hd = q.shape
    Sk = k.shape[1]
    rep = H // k.shape[2]
    hdp = 64 if hd <= 64 else 128 if hd <= 128 else 256
    pad = (0, hdp - hd)
    qf = torch.nn.functional.pad(q.float(), pad).transpose(1, 2)   # (B, H, S, hdp)
    kf = torch.nn.functional.pad(k.float(), pad).transpose(1, 2).repeat_interleave(rep, 1)
    vf = torch.nn.functional.pad(v.float(), pad).transpose(1, 2).repeat_interleave(rep, 1)
    scale_log2 = np.float32(np.float32(hd ** -0.5) * np.float32(1.4426950408889634))
    win = window if causal and window else 0
    out = torch.zeros((B, H, S, hdp))
    for q0 in range(0, S, BQ):
        q_last = min(q0 + BQ, S) - 1
        kt_lo, kt_hi = 0, (Sk - 1) // BK
        if causal:
            kt_hi = min(q_last, Sk - 1) // BK
            if win:
                kt_lo = max(0, q0 - win + 1) // BK
        for first in (q0, q0 + HALF):
            last = min(first + HALF - 1, S - 1)
            if last < first:
                continue
            qp = torch.arange(first, last + 1)
            m = torch.full((B, H, len(qp)), -torch.inf)
            l = torch.zeros((B, H, len(qp)))
            acc = torch.zeros((B, H, len(qp), hdp))
            for kt in range(kt_lo, kt_hi + 1):
                k0 = kt * BK
                if causal and (k0 > last or (win and k0 + BK - 1 <= first - win)):
                    continue
                keys = torch.arange(k0, min(k0 + BK, Sk))
                s = qf[:, :, qp] @ kf[:, :, keys].transpose(-1, -2)
                live = torch.ones((len(qp), len(keys)), dtype=torch.bool)
                if causal:
                    d = qp[:, None] - keys[None, :]
                    live = (d >= 0) & ((d < win) if win else True)
                s = torch.where(live, s, -torch.inf)
                mx = torch.maximum(m, s.amax(-1))
                b = torch.where(mx == -torch.inf, 0.0, mx * scale_log2)
                c = torch.exp2(m * scale_log2 - b)
                m = mx
                l = l * c
                acc = acc * c[..., None]
                p = torch.where(live, torch.exp2(s * scale_log2 - b[..., None]), 0.0)
                l = l + p.sum(-1)
                hi = p.bfloat16().float()
                vt = vf[:, :, keys]
                acc = acc + hi @ vt
                if split_p:
                    acc = acc + (p - hi).bfloat16().float() @ vt
            out[:, :, qp] = acc / l.clamp(min=1e-30)[..., None]
    return out[..., :hd].transpose(1, 2).bfloat16()


def _qkv(seed, b, s, h, hkv, hd):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
                 for shape in ((b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hd)))


def _broken(got, want):
    """Outputs outside the bf16 tolerance."""
    return int((~torch.isclose(got.float(), want.float(), atol=ATOL, rtol=RTOL)).sum())


CASES = [
    # b, s, h, hkv, hd, causal, window
    (1, 300, 4, 2, 240, True, None),      # gemma3's head_dim, GQA 2:1, causal
    (1, 300, 4, 2, 240, True, 100),       # and windowed
    (2, 201, 6, 2, 64, True, 70),         # GQA 3:1, ragged S, window
    (1, 190, 2, 2, 128, False, None),     # not causal
]


@pytest.mark.parametrize("b,s,h,hkv,hd,causal,window", CASES)
def test_tc_order_matches_reference(b, s, h, hkv, hd, causal, window):
    q, k, v = _qkv(s + hd, b, s, h, hkv, hd)
    got = tc_emulate(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = attention_ref(q, k, v, causal=causal, window=window)
    jq, jk, jv = (jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in (q, k, v))
    jwant = jops.flash_attention(jq, jk, jv, causal=causal, window=window, interpret=True)
    for w in (want.float().numpy(), np.asarray(jwant, np.float32)):
        np.testing.assert_allclose(got.float().numpy(), w, atol=ATOL, rtol=RTOL)


CROSS_CASES = [
    # b, sq, sk, h, hkv, hd, causal, window
    (1, 100, 300, 4, 4, 64, False, None),   # whisper's cross attention, ragged Sk
    (2, 150, 70, 4, 2, 128, False, None),   # Sk < Sq, GQA 2:1
    (1, 200, 333, 2, 1, 64, True, None),    # causal, Sq < Sk: key <= query from 0
    (1, 260, 90, 4, 2, 64, True, 40),       # causal, windowed, rows past Sk + window
]


@pytest.mark.parametrize("b,sq,sk,h,hkv,hd,causal,window", CROSS_CASES)
def test_tc_order_with_sq_ne_sk_matches_reference(b, sq, sk, h, hkv, hd, causal, window):
    """The kernel's order with the query and key lengths apart: query tiles
    over Sq, key tiles and the key mask over Sk, against the plain version
    (which gives a row without a live key 0, as the kernel does)."""
    rng = np.random.default_rng(sq + sk)
    q = torch.from_numpy(rng.standard_normal((b, sq, h, hd)).astype(np.float32)).bfloat16()
    k, v = (torch.from_numpy(rng.standard_normal((b, sk, hkv, hd)).astype(np.float32)
                             ).bfloat16() for _ in range(2))
    got = tc_emulate(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("window", [None, 1024])
def test_single_rounding_of_p_breaks_the_bf16_gate(window):
    """Why the kernel splits P: at gemma3's head_dim over a 2,048 prompt, P
    rounded once to bf16 puts outputs beyond one bf16 ulp of the fp32-P
    reference; hi + lo puts none there. Prints both counts."""
    q, k, v = _qkv(2048, 1, 2048, 4, 4, 240)
    want = attention_ref(q, k, v, causal=True, window=window)
    once = _broken(tc_emulate(q, k, v, causal=True, window=window, split_p=False), want)
    split = _broken(tc_emulate(q, k, v, causal=True, window=window), want)
    print(f"window {window}: outputs beyond rtol 2^-7 / atol 1e-4 of {want.numel()}: "
          f"P rounded once {once}, P as hi + lo {split}")
    assert split == 0 < once
