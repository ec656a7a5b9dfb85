"""The arithmetic of flash attention's bf16 tensor-core backward, on the CPU.

``csrc/flash_attention.cu``'s ``tc::flash_bwd_dq_tc_kernel`` and
``tc::flash_bwd_dkdv_tc_kernel`` run only on the card. This file keeps a
plain-torch emulation of the order in which they compute and holds it to
the bf16 gate ``chip_smoke.py``'s phase 16 holds the kernels to: against
the plain version (``attention_bwd_ref`` on the same bf16 inputs), rtol
2^-7 (one bf16 ulp) and an atol of 4 x the max abs error of the fp32 plain
version against an fp64 evaluation on the same inputs. The order:

* S = Q K^T and dP = dO V^T of the bf16 values, summed in fp32;
* p = 2^(S * scale * log2(e) - lse * log2(e)) on live pairs (the exponent
  one fused multiply-add), exactly 0 on masked ones; ds = p (dP - delta)
  scale in fp32, delta = sum dO * O per row in fp32;
* p and ds enter the products as three bf16 terms each, t0 = bf16(x), t1
  = bf16(x - t0), t2 = bf16(x - t0 - t1), all multiplied into the fp32
  accumulators (K, Q and dO are bf16 already, so nothing else is rounded);
* each 64-key tile's share of dq is summed on its own (the terms of its
  keys) and then added to the running sum, the tiles in ascending order;
  dk and dv likewise over 64-query tiles, for each query head of the KV
  head's group in turn; each gradient is rounded to bf16 once at the end.
  At hd > 128 (run at 256, the columns past hd zero) the kernels split
  each output's columns in two halves, each summed by its own warpgroup
  or block in the same order, so the order is the same at every hd.

``terms=1`` rounds p and ds to bf16 once instead (what FlashAttention and
SDPA do), ``terms=2`` keeps hi + lo (the forward kernel's split); the test
prints how many outputs each puts beyond the gate. On the card the gate's
atol comes from the FMA kernels' error against the plain version, which at
whisper-large-v3's unmasked shapes is about 1e-7 (smaller than the fp32
plain version's error against fp64 here): two terms put outputs beyond
that, three none, so the kernels take three.
The emulation is also held against ``jax.vjp`` of the JAX package's flash
attention at small shapes (hd 64, and gemma3-12b's hd 240). Inputs come
from numpy with a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref

RTOL = 2.0 ** -7
TILE = 64
LOG2E = np.float32(1.4426950408889634)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _terms(x, n):
    """x (fp32) as the ``n`` bf16 terms the kernels multiply, each the
    rounding of what the ones before leave."""
    out = []
    for _ in range(n):
        out.append(x.bfloat16().float())
        x = x - out[-1]
    return out


def tc_bwd_emulate(q, k, v, o, lse, do, *, causal, window=None, terms=3, scale_hd=None):
    """(dq, dk, dv) in bf16 from bf16 q (B, Sq, H, hd), k, v (B, Sk, Hkv,
    hd), o, do (B, Sq, H, hd) and fp32 lse (B, H, Sq), in the kernels'
    order of arithmetic; the softmax scale is ``scale_hd ** -0.5`` (hd's
    when None)."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = np.float32((scale_hd or hd) ** -0.5)
    scale_log2 = np.float32(scale * LOG2E)
    qf, of, dof = (t.float().transpose(1, 2) for t in (q, o, do))           # (B, H, Sq, hd)
    kf, vf = (t.float().transpose(1, 2).repeat_interleave(rep, 1) for t in (k, v))
    delta = (dof * of).sum(-1)                                               # (B, H, Sq)
    live = _live(Sq, Sk, causal, window if causal else None)
    s = qf @ kf.transpose(-1, -2)
    dp = dof @ vf.transpose(-1, -2)
    # the exponent as one fused multiply-add: s * scale_log2 is exact in fp64
    arg = (s.double() * float(scale_log2) - (lse * LOG2E)[..., None].double()).float()
    p = torch.where(live, torch.exp2(torch.where(live, arg, 0.0)), 0.0)
    ds = p * (dp - delta[..., None]) * scale
    p_t, ds_t = _terms(p, terms), _terms(ds, terms)
    dq = torch.zeros_like(qf)
    for k0 in range(0, Sk, TILE):
        t = slice(k0, k0 + TILE)
        dq = dq + sum(term[..., t] @ kf[:, :, t] for term in ds_t)
    dk = torch.zeros((B, Hkv, Sk, hd))
    dv = torch.zeros((B, Hkv, Sk, hd))
    for r in range(rep):
        heads = slice(r, H, rep)          # query head hk * rep + r of each KV head hk
        for q0 in range(0, Sq, TILE):
            t = slice(q0, q0 + TILE)
            dv = dv + sum(term[:, heads, t].transpose(-1, -2) @ dof[:, heads, t]
                          for term in p_t)
            dk = dk + sum(term[:, heads, t].transpose(-1, -2) @ qf[:, heads, t]
                          for term in ds_t)
    return (dq.transpose(1, 2).bfloat16(), dk.transpose(1, 2).bfloat16(),
            dv.transpose(1, 2).bfloat16())


def _fp64_bwd(q, k, v, o, lse, do, causal, window):
    """(dq, dk, dv): the plain version's formulas in fp64 on the same
    inputs (the forward's o and lse included)."""
    B, Sq, H, hd = q.shape
    Sk, rep = k.shape[1], H // k.shape[2]
    qd, od, dod = (t.double().transpose(1, 2) for t in (q, o, do))
    kd, vd = (t.double().transpose(1, 2).repeat_interleave(rep, 1) for t in (k, v))
    live = _live(Sq, Sk, causal, window if causal else None)
    s = qd @ kd.transpose(-1, -2) * hd ** -0.5
    p = torch.where(live, torch.exp(torch.where(live, s, 0.0) - lse.double()[..., None]), 0.0)
    dp = dod @ vd.transpose(-1, -2)
    ds = p * (dp - (dod * od).sum(-1, keepdim=True)) * hd ** -0.5
    dq = ds @ kd
    dk = (ds.transpose(-1, -2) @ qd).reshape(B, H // rep, rep, Sk, hd).sum(2)
    dv = (p.transpose(-1, -2) @ dod).reshape(B, H // rep, rep, Sk, hd).sum(2)
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


def _inputs(seed, B, Sq, Sk, H, Hkv, hd):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).bfloat16()
                 for shape in ((B, Sq, H, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd),
                               (B, Sq, H, hd)))


def _gate(q, k, v, do, causal, window, atol=None):
    """(o, lse, want, atol): the forward's output and lse, the plain
    version's bf16 gradients, and phase 16's atol from the fp32 plain
    version's error against fp64 on the same inputs (or ``atol``)."""
    kw = {"causal": causal, "window": window}
    o, lse = attention_ref(q, k, v, return_lse=True, **kw)
    want = attention_bwd_ref(q, k, v, o, lse, do, **kw)
    w32 = [t.float() for t in (q, k, v, o)]
    g32 = attention_bwd_ref(*w32, lse, do.float(), **kw)
    g64 = _fp64_bwd(q, k, v, o, lse, do, causal, window)
    e32 = max(float((a.double() - b).abs().max()) for a, b in zip(g32, g64))
    return o, lse, want, 4 * e32 if atol is None else atol


def _beyond(got, want, atol):
    """Outputs outside the gate, over dq, dk and dv."""
    return sum(int((~torch.isclose(g.float(), w.float(), atol=atol, rtol=RTOL)).sum())
               for g, w in zip(got, want))


CASES = {
    # B, Sq, Sk, H, Hkv, hd, causal, window, atol (None: from fp64)
    "internvl2_cut": (1, 1024, 1024, 4, 2, 128, True, None, None),   # causal, GQA 2
    "windowed": (1, 768, 768, 4, 2, 128, True, 200, None),
    "past_sk_window": (2, 333, 200, 8, 4, 128, True, 64, None),      # rows with no live key
    "whisper_cross_cut": (1, 224, 500, 4, 4, 64, False, None, None),  # unmasked, Sq != Sk
    # whisper's cross attention at the atol the card's gate takes there
    "whisper_cross_card_atol": (1, 224, 1500, 4, 4, 64, False, None, 1e-7),
    # hd > 128: gemma3-12b's hd 240 (at 256, dq's tiles split even / odd),
    # local and global; recurrentgemma-2b's hd 256 under MQA, ragged S
    "hd240_window_gqa": (1, 768, 768, 4, 2, 240, True, 200, None),
    "hd240_causal": (1, 640, 640, 4, 2, 240, True, None, None),
    "hd256_mqa_ragged": (1, 333, 333, 10, 1, 256, True, 300, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_three_term_emulation_holds_the_bf16_gate(case):
    """Three terms put no output beyond phase 16's bf16 gate; prints how
    many one rounding and two terms (hi + lo) put there."""
    B, Sq, Sk, H, Hkv, hd, causal, window, atol = CASES[case]
    q, k, v, do = _inputs(list(CASES).index(case) + 24, B, Sq, Sk, H, Hkv, hd)
    o, lse, want, atol = _gate(q, k, v, do, causal, window, atol)
    kw = {"causal": causal, "window": window}
    beyond = {}
    for n in (1, 2, 3):
        got = tc_bwd_emulate(q, k, v, o, lse, do, terms=n, **kw)
        assert all(g.dtype == torch.bfloat16 and g.shape == w.shape
                   for g, w in zip(got, want))
        beyond[n] = _beyond(got, want, atol)
    print(f"{case}: atol {atol:.3g}; outputs beyond the gate of "
          f"{sum(w.numel() for w in want)}: p and ds rounded once {beyond[1]}, as hi + lo "
          f"{beyond[2]}, as three terms {beyond[3]}")
    assert beyond[3] == 0


def test_emulation_against_the_reference_vjp():
    """The emulated kernels' gradients against ``jax.vjp`` of the JAX
    package's flash attention (``_chunked_attention``, the flash
    ``custom_vjp``) on the same bf16 values widened to fp32: causal, a local
    window, GQA 2, a ragged S."""
    B, S, H, Hkv, hd, window = 1, 200, 4, 2, 64, 48
    q, k, v, do = _inputs(7, B, S, S, H, Hkv, hd)
    for kind, win in (("causal", None), ("local", window)):
        # o and lse of the fp32 forward, as the reference's vjp forms them
        o, lse = attention_ref(q.float(), k.float(), v.float(), return_lse=True, causal=True,
                               window=win)
        got = tc_bwd_emulate(q, k, v, o, lse, do, causal=True, window=win)

        def f(q_, k_, v_):
            return jattn._chunked_attention(q_, k_, v_, kind=kind, window=window, chunk=64)

        ins = [jnp.asarray(t.float().numpy()) for t in (q, k, v)]
        _, vjp = jax.vjp(f, *ins)
        want = vjp(jnp.asarray(do.float().numpy()))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.float().numpy(), np.asarray(w), rtol=2e-2,
                                       atol=2e-3)


def test_hd240_emulation_against_the_reference_vjp():
    """gemma3-12b's head width (hd 240) in the dq kernel's split order,
    against ``jax.vjp`` of the JAX package's ``_chunked_attention``:
    causal and a local window, GQA 2, a ragged S."""
    B, S, H, Hkv, hd, window = 1, 150, 4, 2, 240, 40
    q, k, v, do = _inputs(11, B, S, S, H, Hkv, hd)
    for kind, win in (("causal", None), ("local", window)):
        o, lse = attention_ref(q.float(), k.float(), v.float(), return_lse=True, causal=True,
                               window=win)
        got = tc_bwd_emulate(q, k, v, o, lse, do, causal=True, window=win)

        def f(q_, k_, v_):
            return jattn._chunked_attention(q_, k_, v_, kind=kind, window=window, chunk=64)

        ins = [jnp.asarray(t.float().numpy()) for t in (q, k, v)]
        _, vjp = jax.vjp(f, *ins)
        want = vjp(jnp.asarray(do.float().numpy()))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.float().numpy(), np.asarray(w), rtol=2e-2,
                                       atol=2e-3)


def test_zero_padded_columns_change_nothing():
    """hd 240 runs at 256 with the columns past hd zero (TMA fills them):
    the emulation on inputs padded with 16 zero columns gives exactly zero
    gradients in the pad and the unpadded gradients within one bf16 ulp
    (the CPU's products sum 256 terms in other blocks than 240)."""
    q, k, v, do = _inputs(5, 1, 200, 200, 4, 2, 240)
    o, lse = attention_ref(q, k, v, return_lse=True, causal=True, window=64)
    got = tc_bwd_emulate(q, k, v, o, lse, do, causal=True, window=64)
    pad = [torch.nn.functional.pad(t, (0, 16)) for t in (q, k, v, o, do)]
    # the padded call keeps hd 240's softmax scale, as the kernels do
    padded = tc_bwd_emulate(*pad[:4], lse, pad[4], causal=True, window=64, scale_hd=240)
    for g, w in zip(padded, got):
        torch.testing.assert_close(g[..., :240].float(), w.float(), rtol=RTOL, atol=1e-6)
        assert not g[..., 240:].any()


def test_cpu_backward_moves_no_route_count():
    """On CPU tensors the backward runs the plain versions: neither the
    launch counts nor the per-route counts (``routes``, which split the
    card's launches between the bf16 tensor-core, the fp32 3xTF32 and the
    FMA kernels) move."""
    from repro_torch.kernels.flash_attention import ops

    q, k, v, do = _inputs(3, 1, 70, 70, 4, 2, 64)
    qt, kt, vt = (t.float().requires_grad_(True) for t in (q, k, v))
    before = [dict(f.routes) for f in (ops.flash_bwd_dq, ops.flash_bwd_dkdv)]
    launches = (ops.flash_bwd_dq.launches, ops.flash_bwd_dkdv.launches)
    o = ops.flash_attention(qt, kt, vt, causal=True, window=None)
    grads = torch.autograd.grad(o, (qt, kt, vt), do.float())
    assert all(torch.isfinite(g).all() for g in grads)
    assert [dict(f.routes) for f in (ops.flash_bwd_dq, ops.flash_bwd_dkdv)] == before
    assert set(before[0]) == set(before[1]) == {"tensor_core", "fma", "tf32x3"}
    assert (ops.flash_bwd_dq.launches, ops.flash_bwd_dkdv.launches) == launches
