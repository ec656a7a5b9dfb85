"""The arithmetic of flash attention's fp32 tensor-core backward, on the CPU.

``csrc/flash_attention.cu``'s ``x3::flash_bwd_dq_x3_kernel`` and
``x3::flash_bwd_dkdv_x3_kernel`` (the ``"tf32x3"`` route) run only on the
card. This file keeps a plain-torch emulation of the order in which they
compute and holds it to the fp32 gate ``chip_smoke.py``'s phase 16 holds
the kernels to: atol = rtol = 1e-4 against the plain version
(``attention_bwd_ref`` on the same fp32 inputs). The order:

* every operand of a product (Q, K, V, dO, p, dS) is split into big =
  tf32(x), rounded to nearest with ties away from zero (``cvt.rna``), and
  small = tf32(x - big); a product A B is big.big + big.small + small.big,
  each product of TF32 values exact in fp32 and summed in fp32 (TF32
  rounding is emulated on the fp32 bits with integer operations);
* dq kernel, for each tile of T = 32 keys in ascending order: S = Q K^T
  and dP = dO V^T (at hd > 128, run at 256, each product's sum over hd is
  formed in two halves of 128 columns, one a block of a cluster pair, and
  the halves added); p = 2^(S * scale * log2(e) -
  lse * log2(e)) on live pairs (the exponent one fused multiply-add), 0 on
  masked ones; ds = p (dP - delta) scale, delta = sum dO * O per row; dq
  += ds K (the kernel forms dQ^T = K^T dS^T: the same three products);
* dK/dV kernel, for each query head of the KV head's group and each tile
  of T = 32 queries in ascending order: S^T = K Q^T, dP^T = V dO^T (in
  two halves at hd > 128, as in the dq kernel), p as above
  and split; ds from p's big + small (the consumer forming dS reads the
  split P); dv += p^T dO, dk += ds^T Q (formed as dV^T = dO^T P and dK^T =
  Q^T dS).

``terms=1`` rounds each operand to TF32 once and makes one product (what a
single TF32 wgmma does); the test prints how many outputs each puts beyond
the gate: one rounding puts many there, the split none. The emulation is
also held against ``jax.vjp`` of the JAX package's flash attention at 1e-4.
Inputs come from numpy with a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref

TOL = 1e-4   # phase 16's fp32 gate (chip_smoke.TOL_GRAD), atol and rtol
LOG2E = np.float32(1.4426950408889634)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tf32(x):
    """fp32 ``x`` rounded to TF32 (10 stored mantissa bits), to nearest with
    ties away from zero, on its bits: add half of the dropped field to the
    magnitude, then clear the low 13 bits (cvt.rna.tf32.f32)."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    """(big, small): big = tf32(x), small = tf32(x - big)."""
    big = tf32(x)
    return big, tf32(x - big)


def _mm(a, b, terms):
    """a @ b as the kernels' tensor cores take it: three TF32 products of
    the split operands, or (terms=1) one product of the rounded ones."""
    if terms == 1:
        return tf32(a) @ tf32(b)
    ab, as_ = split(a)
    bb, bs = split(b)
    return ab @ bb + ab @ bs + as_ @ bb


def _mm_halves(a, b, terms):
    """a @ b over a contraction (hd) above 128, as a cluster pair forms S
    and dP: each 128-column half on its own, then the halves added."""
    if a.shape[-1] <= 128:
        return _mm(a, b, terms)
    return _mm(a[..., :128], b[..., :128, :], terms) + _mm(a[..., 128:], b[..., 128:, :], terms)


def _live(Sq, Sk, causal, window):
    """(Sq, Sk) bool: key < Sk, and when causal key <= query (from 0) and
    query - key < window."""
    if not causal:
        return torch.ones((Sq, Sk), dtype=torch.bool)
    d = torch.arange(Sq)[:, None] - torch.arange(Sk)[None, :]
    ok = d >= 0
    if window:
        ok &= d < window
    return ok


def _p(s, lse2, scale_log2, live):
    """p = 2^(s scale log2(e) - lse log2(e)) on live pairs, 0 elsewhere; the
    exponent as one fused multiply-add (exact in fp64, rounded once)."""
    arg = (s.double() * float(scale_log2) - lse2.double()).float()
    return torch.where(live, torch.exp2(torch.where(live, arg, 0.0)), 0.0)


def x3_bwd_emulate(q, k, v, o, lse, do, *, causal, window=None, terms=3, scale_hd=None):
    """(dq, dk, dv) fp32 from fp32 q (B, Sq, H, hd), k, v (B, Sk, Hkv, hd), o,
    do (B, Sq, H, hd) and lse (B, H, Sq), in the kernels' order of
    arithmetic; the softmax scale is ``scale_hd ** -0.5`` (hd's when None)."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    T = 32
    scale = np.float32((scale_hd or hd) ** -0.5)
    scale_log2 = np.float32(scale * LOG2E)
    qf, of, dof = (t.float().transpose(1, 2) for t in (q, o, do))        # (B, H, Sq, hd)
    kf, vf = (t.float().transpose(1, 2) for t in (k, v))                 # (B, Hkv, Sk, hd)
    kr, vr = (t.repeat_interleave(rep, 1) for t in (kf, vf))
    delta = (dof * of).sum(-1)                                            # (B, H, Sq)
    lse2 = lse * LOG2E
    live = _live(Sq, Sk, causal, window if causal else None)
    # the dq kernel: key tiles in ascending order
    dq = torch.zeros_like(qf)
    for k0 in range(0, Sk, T):
        t = slice(k0, k0 + T)
        s = _mm_halves(qf, kr[:, :, t].transpose(-1, -2), terms)
        dp = _mm_halves(dof, vr[:, :, t].transpose(-1, -2), terms)
        p = _p(s, lse2[..., None], scale_log2, live[:, t])
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + _mm(ds, kr[:, :, t], terms)
    # the dK/dV kernel: per query head of the group, query tiles ascending
    dk = torch.zeros((B, Hkv, Sk, hd))
    dv = torch.zeros((B, Hkv, Sk, hd))
    for r in range(rep):
        heads = slice(r, H, rep)          # query head hk * rep + r of each KV head hk
        for q0 in range(0, Sq, T):
            t = slice(q0, q0 + T)
            st = _mm_halves(kf, qf[:, heads, t].transpose(-1, -2), terms)  # keys x queries
            dpt = _mm_halves(vf, dof[:, heads, t].transpose(-1, -2), terms)
            pt = _p(st, lse2[:, heads, None, t], scale_log2, live[t].T)
            pp = pt if terms == 1 else sum(split(pt))
            dst = pp * (dpt - delta[:, heads, None, t]) * scale
            dv = dv + _mm(dof[:, heads, t].transpose(-1, -2), pt.transpose(-1, -2),
                          terms).transpose(-1, -2)
            dk = dk + _mm(qf[:, heads, t].transpose(-1, -2), dst.transpose(-1, -2),
                          terms).transpose(-1, -2)
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


def _inputs(seed, B, Sq, Sk, H, Hkv, hd):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
                 for shape in ((B, Sq, H, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd),
                               (B, Sq, H, hd)))


def _beyond(got, want):
    """Outputs outside the fp32 gate, over dq, dk and dv."""
    return sum(int((~torch.isclose(g, w, atol=TOL, rtol=TOL)).sum()) for g, w in zip(got, want))


CASES = {
    # B, Sq, Sk, H, Hkv, hd, causal, window
    "internvl2_cut": (1, 1024, 1024, 4, 2, 128, True, None),     # causal, GQA 2
    "window_200": (1, 768, 768, 4, 2, 128, True, 200),
    "past_sk_window": (2, 333, 200, 8, 4, 128, True, 64),         # rows with no live key
    "cross_unmasked": (1, 224, 500, 4, 4, 64, False, None),       # Sq != Sk
    # hd > 128: gemma3-12b's hd 240 (run at 256) under GQA 2 and a window;
    # recurrentgemma-2b's hd 256 under MQA, ragged S
    "hd240_window_gqa": (1, 512, 512, 4, 2, 240, True, 200),
    "hd256_mqa_ragged": (1, 333, 333, 10, 1, 256, True, 300),
}


@pytest.mark.parametrize("case", list(CASES))
def test_split_emulation_holds_the_fp32_gate(case):
    """Three TF32 products a product put no output beyond phase 16's fp32
    gate; one TF32 rounding puts some there (both counts printed)."""
    B, Sq, Sk, H, Hkv, hd, causal, window = CASES[case]
    q, k, v, do = _inputs(list(CASES).index(case) + 40, B, Sq, Sk, H, Hkv, hd)
    kw = {"causal": causal, "window": window}
    o, lse = attention_ref(q, k, v, return_lse=True, **kw)
    want = attention_bwd_ref(q, k, v, o, lse, do, **kw)
    beyond = {}
    for n in (1, 3):
        got = x3_bwd_emulate(q, k, v, o, lse, do, terms=n, **kw)
        assert all(g.dtype == torch.float32 and g.shape == w.shape for g, w in zip(got, want))
        assert all(torch.isfinite(g).all() for g in got)
        beyond[n] = _beyond(got, want)
    print(f"{case}: outputs beyond atol = rtol = {TOL} of {sum(w.numel() for w in want)}: "
          f"one TF32 rounding {beyond[1]}, three TF32 products {beyond[3]}")
    assert beyond[3] == 0
    assert beyond[1] > 0


@pytest.mark.parametrize("hd", [64, 240])
def test_emulation_against_the_reference_vjp(hd):
    """The emulated kernels' gradients against ``jax.vjp`` of the JAX
    package's flash attention (``_chunked_attention``, the flash
    ``custom_vjp``) in fp32 at 1e-4: causal and a local window, GQA 2, a
    ragged S; hd 64 and gemma3-12b's hd 240."""
    B, S, H, Hkv, window = 1, 200, 4, 2, 48
    q, k, v, do = _inputs(7 + hd, B, S, S, H, Hkv, hd)
    for kind, win in (("causal", None), ("local", window)):
        o, lse = attention_ref(q, k, v, return_lse=True, causal=True, window=win)
        got = x3_bwd_emulate(q, k, v, o, lse, do, causal=True, window=win)

        def f(q_, k_, v_):
            return jattn._chunked_attention(q_, k_, v_, kind=kind, window=window, chunk=64)

        _, vjp = jax.vjp(f, *(jnp.asarray(t.numpy()) for t in (q, k, v)))
        want = vjp(jnp.asarray(do.numpy()))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)


def test_split_reproduces_x():
    """big + small gives x back within 2^-22 of |x| on random, tiny and huge
    values (small a normal fp32 number); big and small are TF32 (their low
    13 bits 0), and big is x rounded to nearest."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(np.concatenate([
        rng.standard_normal(4096), rng.standard_normal(1024) * 1e-30,
        rng.standard_normal(1024) * 1e30,
    ]).astype(np.float32))
    big, small = split(x)
    for t in (big, small):
        assert not (t.view(torch.int32) & 0x1FFF).any()
    err = (x.double() - big.double() - small.double()).abs()
    assert (err <= 2.0 ** -22 * x.double().abs()).all()
    # big is the nearest TF32 value: within half a TF32 ulp of x
    assert ((x.double() - big.double()).abs() <= 2.0 ** -11 * x.double().abs()).all()


def test_zero_padded_columns_give_zero_gradients():
    """hd 240 runs at 256 with the columns past hd zero (TMA fills them):
    the emulation on inputs padded with 16 zero columns gives exactly zero
    gradients in the pad and the unpadded gradients within the gate (the
    products sum 256 terms in other blocks than 240)."""
    q, k, v, do = _inputs(5, 1, 200, 200, 4, 2, 240)
    o, lse = attention_ref(q, k, v, return_lse=True, causal=True, window=64)
    got = x3_bwd_emulate(q, k, v, o, lse, do, causal=True, window=64)
    pad = [torch.nn.functional.pad(t, (0, 16)) for t in (q, k, v, o, do)]
    # the padded call keeps hd 240's softmax scale, as the kernels do
    padded = x3_bwd_emulate(*pad[:4], lse, pad[4], causal=True, window=64, scale_hd=240)
    for g, w in zip(padded, got):
        torch.testing.assert_close(g[..., :240], w, rtol=TOL, atol=TOL)
        assert not g[..., 240:].any()


def test_route_names():
    """The wrappers count backward launches under the library's three routes
    (the code ``flash_attention_bwd_route`` returns indexes ``BWD_ROUTES``):
    the FMA pair, the bf16 tensor-core pair and this fp32 pair."""
    from repro_torch.kernels.flash_attention import ops

    assert ops.BWD_ROUTES == ("fma", "tensor_core", "tf32x3")
    for f in (ops.flash_bwd_dq, ops.flash_bwd_dkdv):
        assert set(f.routes) == set(ops.BWD_ROUTES)
