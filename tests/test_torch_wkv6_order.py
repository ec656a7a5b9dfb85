"""The arithmetic of the WKV6 recurrence kernel, on the CPU.

``csrc/wkv6.cu::wkv6_kernel`` runs only on the card. This file keeps a
plain-torch emulation of the order in which it computes, and holds that
emulation against the JAX package's Pallas kernel in interpret mode and
against its plain ``wkv6_ref``: fp32 at 1e-5 on y and S (the reference's
own tolerance); bf16 r/k/v at one bf16 ulp on y (rtol 2^-7, atol 1e-2, as
``chip_smoke.py`` holds the kernel) and 1e-5 on S. The order:

* the value columns of a (b, h) row split over ``splits`` blocks, and in a
  block over thread tiles of 8 key rows by ``cols`` value columns of S;
* T in stages of ``ops.STAGE_STEPS`` steps, the last one ragged;
* per step, coef = sum_n r u k once: each of the KT = N/8 key-row threads
  sums its 8 rows (r·u, then an FMA with k), then an xor tree over the KT
  lanes (lane 0's sum is kept);
* per step and thread, acc = sum over its 8 rows of r·S (FMAs, rows in
  order) and S = FMA(w, S, k·v);
* after a stage, y = FMA(coef, v, the KT partial sums added in order).

On the card coef and the sums into y are the helper warps' work, a stage
ahead of and behind the state threads; that moves no operation of this
order.

An FMA is emulated exactly: the product and sum in fp64, rounded once to
fp32. No step of the order depends on ``cols`` or ``splits``, so every
launch gives the same bits; the test checks that of the emulation too.
Inputs come from numpy with a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6 import ops as jops
from repro.kernels.wkv6 import ref as jref
from repro_torch.kernels.wkv6 import ops

TOL = 1e-5
RTOL_BF16, ATOL_BF16_Y = 2.0 ** -7, 1e-2
RK, TS = ops.ROWS_PER_THREAD, ops.STAGE_STEPS


def fma(a, b, c):
    """fp32 fmaf: a·b + c rounded once."""
    return (a.double() * b.double() + c.double()).float()


def kernel_order(r, k, v, w, u, cols, splits):
    """The kernel's order of operations on r, k, v (B, T, H, N) fp32 or
    bf16, w (B, T, H, N) fp32, u (H, N); returns y (B, T, H, N) in r's type
    and S (B, H, N, N) fp32. The state lives as register tiles
    (B, H, block, q, row, ct, col): key row q*8 + row, value column
    block*CG + ct*cols + col."""
    B, T, H, N = r.shape
    kt, cg = N // RK, N // splits
    ct = cg // cols
    rf, kf, vf, wf = (a.float().transpose(1, 2) for a in (r, k, v, w))   # (B, H, T, N)
    uf = u.float()[None]                                                  # (1, H, N)
    S = torch.zeros((B, H, splits, kt, RK, ct, cols))
    y = torch.zeros((B, H, T, N))
    lanes = torch.arange(kt)
    for t0 in range(0, T, TS):
        steps = min(TS, T - t0)
        ts = slice(t0, t0 + steps)
        # coef of every step of the stage: kt lanes of 8 rows, then the
        # xor tree (it reads only r, k, u: the helpers sum it ahead)
        ru = (rf[:, :, ts] * uf[:, :, None]).view(B, H, steps, kt, RK)
        kr = kf[:, :, ts].reshape(B, H, steps, kt, RK)
        cp = torch.zeros((B, H, steps, kt))
        for j in range(RK):
            cp = fma(ru[..., j], kr[..., j], cp)
        off = kt // 2
        while off:
            cp = cp + cp[..., lanes ^ off]
            off //= 2
        coef = cp[..., 0]                                                 # (B, H, steps)
        # the steps: every thread tile at once
        part = []
        for t in range(t0, t0 + steps):
            rt = rf[:, :, t].view(B, H, 1, kt, RK, 1, 1)
            kt_ = kf[:, :, t].view(B, H, 1, kt, RK, 1, 1)
            wt = wf[:, :, t].view(B, H, 1, kt, RK, 1, 1)
            vt = vf[:, :, t].view(B, H, splits, 1, 1, ct, cols)
            acc = torch.zeros((B, H, splits, kt, ct, cols))
            for i in range(RK):
                acc = fma(rt[:, :, :, :, i], S[:, :, :, :, i], acc)
                S[:, :, :, :, i] = fma(wt[:, :, :, :, i], S[:, :, :, :, i],
                                       kt_[:, :, :, :, i] * vt[:, :, :, :, 0])
            part.append(acc)
        # after the stage: partial sums in order, then the FMA with coef·v
        part = torch.stack(part, 2)                         # (B, H, steps, splits, kt, ct, cols)
        tot = part[:, :, :, :, 0]
        for q in range(1, kt):
            tot = tot + part[:, :, :, :, q]
        y[:, :, ts] = fma(coef[..., None], vf[:, :, ts], tot.reshape(B, H, steps, N))
    s_out = S.permute(0, 1, 3, 4, 2, 5, 6).reshape(B, H, N, N)
    return y.transpose(1, 2).to(r.dtype), s_out


def _inputs(seed, b, t, h, n, w_value=None):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, t, h, n)).astype(np.float32) * 0.5 for _ in range(3))
    if w_value is None:
        w = np.exp(-np.exp(rng.standard_normal((b, t, h, n)) - 1.0)).astype(np.float32)
    else:
        w = np.full((b, t, h, n), w_value, np.float32)
    u = (rng.standard_normal((h, n)) * 0.5).astype(np.float32)
    return r, k, v, w, u


def _hold(ins, dtype=torch.float32):
    """Every launch the kernel takes against the JAX kernel in interpret
    mode and ``wkv6_ref``; all launches give the same bits."""
    r, k, v, w, u = ins
    n = r.shape[-1]
    tr, tk, tv = (torch.from_numpy(a).to(dtype) for a in (r, k, v))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jr, jk, jv = (jnp.asarray(a.float().numpy(), jdt) for a in (tr, tk, tv))
    jw, ju = jnp.asarray(w), jnp.asarray(u)
    wants = [jops.wkv6(jr, jk, jv, jw, ju, interpret=True), jref.wkv6_ref(jr, jk, jv, jw, ju)]
    atol_y, rtol_y = (TOL, TOL) if dtype == torch.float32 else (ATOL_BF16_Y, RTOL_BF16)
    first = None
    for cols, splits in ops.configs(n, dtype):
        y, s = kernel_order(tr, tk, tv, torch.from_numpy(w), torch.from_numpy(u), cols, splits)
        assert y.dtype == dtype and y.shape == tr.shape and s.shape == (r.shape[0], r.shape[2],
                                                                         n, n)
        for yj, sj in wants:
            np.testing.assert_allclose(y.float().numpy(), np.asarray(yj, np.float32),
                                       atol=atol_y, rtol=rtol_y)
            np.testing.assert_allclose(s.numpy(), np.asarray(sj), atol=TOL, rtol=TOL)
        if first is None:
            first = (y, s)
        assert torch.equal(y, first[0]) and torch.equal(s, first[1])


@pytest.mark.parametrize("n", [32, 64, 128])
@pytest.mark.parametrize("t", [1, TS - 1, TS + 1, 77])
def test_order_matches_reference(n, t):
    """fp32, every launch at each head size; T of one step, one step short
    of a stage, one past it (a ragged second stage) and 77 (three stages)."""
    _hold(_inputs(n * 1000 + t, 2, t, 2, n))


@pytest.mark.parametrize("w_value", [1e-6, 1.0 - 1e-6])
def test_order_extreme_decays(w_value):
    """Decays near 0 (the state forgets each step) and near 1 (it keeps
    everything over 77 steps)."""
    _hold(_inputs(5, 2, 77, 2, 64, w_value))


@pytest.mark.parametrize("n", [32, 64, 128])
def test_order_bf16_inputs(n):
    """bf16 r/k/v with fp32 w, as the bf16 model feeds the kernel."""
    _hold(_inputs(n + 3, 2, 77, 2, n), torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_configs_follow_the_kernels_rules(dtype):
    """``CONFIG``'s pick is among the launches the kernel takes, and each
    of those has whole 16-byte rows of v per block, a multiple of 32
    threads up to 256 and fits the shared memory of a block."""
    for n in ops.HEAD_SIZES:
        got = ops.configs(n, dtype)
        assert ops.CONFIG[n] in got
        for cols, splits in got:
            cg = n // splits
            assert n % splits == 0 and cg % cols == 0 and (cg * dtype.itemsize) % 16 == 0
            nt = ops.threads(n, cols, splits)
            assert nt % 32 == 0 and nt <= ops.MAX_THREADS
            assert ops.smem_bytes(n, dtype.itemsize, splits) <= ops.MAX_SMEM


def test_launch_refuses_a_config_the_kernel_does_not_take():
    r = torch.zeros((1, 4, 1, 64))
    with pytest.raises(ValueError, match="cols, splits"):
        ops.launch(r, r, r, r, torch.zeros((1, 64)), 3, 2)
