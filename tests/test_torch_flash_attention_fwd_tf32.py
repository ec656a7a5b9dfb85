"""The arithmetic of flash attention's fp32 tensor-core forward, on the CPU.

``csrc/flash_attention.cu``'s ``x3::flash_fwd_x3_kernel`` (the ``"tf32x3"``
forward route) runs only on the card. This file keeps a plain-torch
emulation of the order in which it computes and holds it to the fp32 gate
``chip_smoke.py``'s phase 7 holds the kernel to: atol = rtol = 2e-5 on o
(the reference's attention tolerance) and 1e-5 on lse (phase 16's) against
the plain version (``attention_ref`` on the same fp32 inputs). The order:

* every operand of a product (Q, K, V, p) is split into big = tf32(x),
  rounded to nearest with ties away from zero, and small = tf32(x - big); a
  product A B is big.big + big.small + small.big, summed in fp32;
* key tiles of T = 32 keys in ascending order, for each 64-row half of a
  128-row query block (the kernel skips a tile that leaves no pair of a half
  live; the emulation runs it, which changes nothing: every score of the
  tile is masked, so the rescale is 1 and p is 0);
* S = Q K^T, at hd > 128 (run at 256) in two halves of 128 columns, one a
  block of a cluster pair, the halves added;
* the online softmax in base 2 with scale log2(e) folded in: a row's max m
  over its live scores, b = m scale log2(e), the rescale 2^(m_old scale
  log2(e) - b), p = 2^(s scale log2(e) - b) (one fused multiply-add), a
  masked score -inf so its p is 0; l = l * rescale + sum p;
* O = O * rescale + P V; at the end o = O / max(l, 1e-30) and lse = (m
  scale log2(e) + log2 l) ln 2, +inf for a row with no live key (o 0).

``terms=1`` rounds each operand to TF32 once and makes one product (what a
single TF32 wgmma does); the test prints how many outputs each puts beyond
the gate: one rounding puts many there, the split none. The emulation is
also held against the JAX package's Pallas kernel in interpret mode. Inputs
come from numpy with a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_flash_attention_bwd_tf32 import split, tf32

from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention.flash_attention import flash_attention_pallas
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import attention_ref

TOL = 2e-5       # phase 7's fp32 gate on o (chip_smoke.TOL_ATTN), atol and rtol
TOL_LSE = 1e-5   # phase 16's on the forward's lse (chip_smoke.TOL_LSE)
LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)
T = 32           # keys a tile (x3::kTileRows)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mm(a, b, terms):
    """a @ b as the kernel's tensor cores take it: three TF32 products of
    the split operands, or (terms=1) one product of the rounded ones."""
    if terms == 1:
        return tf32(a) @ tf32(b)
    ab, as_ = split(a)
    bb, bs = split(b)
    return ab @ bb + ab @ bs + as_ @ bb


def _mm_halves(a, b, terms):
    """a @ b over hd above 128 as a cluster pair forms S: each 128-column
    half on its own, then the halves added (both blocks add the same two
    values, so both hold the same bits)."""
    if a.shape[-1] <= 128:
        return _mm(a, b, terms)
    return _mm(a[..., :128], b[..., :128, :], terms) + _mm(a[..., 128:], b[..., 128:, :], terms)


def _live(Sq, Sk, causal, window):
    """(Sq, Sk) bool: when causal key <= query (from 0) and query - key <
    window; every key is below Sk here."""
    if not causal:
        return torch.ones((Sq, Sk), dtype=torch.bool)
    d = torch.arange(Sq)[:, None] - torch.arange(Sk)[None, :]
    ok = d >= 0
    if window:
        ok &= d < window
    return ok


def x3_fwd_emulate(q, k, v, *, causal, window=None, terms=3, scale_hd=None):
    """(o (B, Sq, H, hd), lse (B, H, Sq)) fp32 from fp32 q (B, Sq, H, hd),
    k, v (B, Sk, Hkv, hd), in the kernel's order of arithmetic; the softmax
    scale is ``scale_hd ** -0.5`` (hd's when None)."""
    B, Sq, H, hd = q.shape
    Sk, rep = k.shape[1], H // k.shape[2]
    scale = np.float32((scale_hd or hd) ** -0.5)
    sl2 = float(np.float32(scale * LOG2E))
    qf = q.float().transpose(1, 2)                                   # (B, H, Sq, hd)
    kf, vf = (t.float().transpose(1, 2).repeat_interleave(rep, 1) for t in (k, v))
    live = _live(Sq, Sk, causal, window if causal else None)
    m = torch.full((B, H, Sq), -torch.inf)
    l = torch.zeros((B, H, Sq))
    acc = torch.zeros((B, H, Sq, hd))
    for k0 in range(0, Sk, T):
        t = slice(k0, k0 + T)
        s = _mm_halves(qf, kf[:, :, t].transpose(-1, -2), terms)
        s = torch.where(live[:, t], s, -torch.inf)
        mx = torch.maximum(m, s.amax(-1))
        b = torch.where(mx == -torch.inf, 0.0, mx * sl2)
        c = torch.exp2(m * sl2 - b)
        p = torch.exp2((s.double() * sl2 - b[..., None].double()).float())
        l = l * c + p.sum(-1)
        acc = acc * c[..., None] + _mm(p, vf[:, :, t], terms)
        m = mx
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    lse = torch.where(l > 0, (m * sl2 + torch.log2(l)) * LN2, torch.inf)
    return o.transpose(1, 2), lse


def _inputs(seed, B, Sq, Sk, H, Hkv, hd):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
                 for shape in ((B, Sq, H, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd)))


def _pallas(q, k, v, *, causal, window, block=128):
    """The JAX package's Pallas kernel (interpret mode) on the same arrays:
    its wrapper ``ops.flash_attention`` where Sq = Sk; where they differ,
    the kernel itself on (BH, S, hd) rows, Sq and Sk padded to the block,
    ``seq_len = Sk``, the padded query rows sliced off."""
    qn, kn, vn = (t.numpy() for t in (q, k, v))
    B, Sq, H, hd = qn.shape
    Sk, Hkv = kn.shape[1], kn.shape[2]
    if Sq == Sk:
        return np.asarray(jops.flash_attention(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
                                               causal=causal, window=window, block_q=block,
                                               block_k=block, interpret=True))

    def rows(x, S, heads):
        x = np.transpose(x, (0, 2, 1, 3)).reshape(B * heads, S, hd)
        return jnp.asarray(np.pad(x, ((0, 0), (0, -S % block), (0, 0))))

    o = flash_attention_pallas(rows(qn, Sq, H), rows(kn, Sk, Hkv), rows(vn, Sk, Hkv),
                               n_q_heads=H, seq_len=Sk, causal=causal, window=window,
                               block_q=block, block_k=block, interpret=True)
    return np.transpose(np.asarray(o)[:, :Sq].reshape(B, H, Sq, hd), (0, 2, 1, 3))


CASES = {
    # B, Sq, Sk, H, Hkv, hd, causal, window
    "whisper_enc_cut": (1, 1500, 1500, 2, 2, 64, False, None),   # unmasked, Sk 1,500
    "whisper_cross": (1, 224, 1500, 4, 4, 64, False, None),       # Sq != Sk
    "past_sk_window": (2, 333, 200, 8, 4, 128, True, 64),         # rows with no live key
    "hd240_window_gqa": (1, 512, 512, 4, 2, 240, True, 200),      # gemma3-12b's hd, run at 256
    "hd256_mqa_ragged": (1, 333, 333, 10, 1, 256, True, 300),     # recurrentgemma-2b's
}


def _case(name):
    B, Sq, Sk, H, Hkv, hd, causal, window = CASES[name]
    return _inputs(list(CASES).index(name) + 90, B, Sq, Sk, H, Hkv, hd), \
        {"causal": causal, "window": window}


@pytest.mark.parametrize("case", list(CASES))
def test_split_emulation_holds_the_fp32_gate(case):
    """Three TF32 products a product put no output beyond phase 7's fp32
    gate and no lse beyond 1e-5; one TF32 rounding puts some outputs there
    (both counts printed). Rows with no live key come out 0 with lse
    +inf."""
    (q, k, v), kw = _case(case)
    want, want_lse = attention_ref(q, k, v, return_lse=True, **kw)
    beyond = {}
    for n in (1, 3):
        o, lse = x3_fwd_emulate(q, k, v, terms=n, **kw)
        assert o.dtype == torch.float32 and o.shape == want.shape
        assert torch.isfinite(o).all()
        assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
        beyond[n] = int((~torch.isclose(o, want, atol=TOL, rtol=TOL)).sum())
        if n == 3:
            fin = torch.isfinite(want_lse)
            torch.testing.assert_close(lse[fin], want_lse[fin], atol=TOL_LSE, rtol=TOL_LSE)
            dead = torch.isinf(want_lse).transpose(1, 2)     # (B, Sq, H)
            assert not o[dead].any()
    print(f"{case}: outputs beyond atol = rtol = {TOL} of {want.numel()}: one TF32 rounding "
          f"{beyond[1]}, three TF32 products {beyond[3]}")
    assert beyond[3] == 0
    assert beyond[1] > 0


@pytest.mark.parametrize("case", list(CASES))
def test_emulation_against_the_reference_pallas(case):
    """The emulated kernel against the JAX package's Pallas kernel in
    interpret mode and against ``attention_ref``, at 2e-5. Against the
    Pallas kernel only the rows with a live key: its rule differs for a row
    whose every key in a visited tile is masked (its -1e30 scores give the
    tile's mean of V), where the port writes 0 (``past_sk_window``)."""
    (q, k, v), kw = _case(case)
    got, _ = x3_fwd_emulate(q, k, v, **kw)
    want = attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    jax_o = _pallas(q, k, v, **kw)
    Sq, Sk = q.shape[1], k.shape[1]
    rows = _live(Sq, Sk, kw["causal"], kw["window"]).any(-1).numpy()
    assert rows.any()
    np.testing.assert_allclose(got.numpy()[:, rows], jax_o[:, rows], atol=TOL, rtol=TOL)


def test_zero_padded_columns_change_nothing():
    """hd 240 runs at 256 with the columns past hd zero (TMA fills them): the
    emulation on inputs padded with 16 zero columns gives exactly zero
    outputs in the pad, and the unpadded outputs and lse within the gate
    (the products sum 256 terms, split 128 + 128 rather than 128 + 112)."""
    (q, k, v), kw = _case("hd240_window_gqa")
    o, lse = x3_fwd_emulate(q, k, v, **kw)
    pad = [torch.nn.functional.pad(t, (0, 16)) for t in (q, k, v)]
    # the padded call keeps hd 240's softmax scale, as the kernel does
    po, plse = x3_fwd_emulate(*pad, scale_hd=240, **kw)
    torch.testing.assert_close(po[..., :240], o, atol=TOL, rtol=TOL)
    torch.testing.assert_close(plse, lse, atol=TOL_LSE, rtol=TOL_LSE)
    assert not po[..., 240:].any()


def test_a_pair_forms_the_same_scores_in_both_blocks():
    """At hd > 128 each block of a cluster pair adds its own half of S to
    the partner's, own + other: block 0 forms h0 + h1, block 1 h1 + h0.
    fp32 addition commutes, so both hold the same bits and form the same p."""
    (q, k, _), _ = _case("hd256_mqa_ragged")
    a = q.transpose(1, 2)
    b = k.transpose(1, 2).transpose(-1, -2)
    h0, h1 = _mm(a[..., :128], b[..., :128, :], 3), _mm(a[..., 128:], b[..., 128:, :], 3)
    assert torch.equal(h0 + h1, h1 + h0)


def test_route_names_and_no_count_on_the_cpu():
    """The wrapper counts forward launches under the library's three routes
    (the code ``flash_attention_fwd_route`` returns indexes ``FWD_ROUTES``),
    beside the backward's; a forward on CPU tensors, with or without the
    lse and under autograd, moves no count."""
    assert ops.FWD_ROUTES == ("fma", "tensor_core", "tf32x3")
    assert ops.BWD_ROUTES == ("fma", "tensor_core", "tf32x3")
    assert set(ops.flash_attention.routes) == set(ops.FWD_ROUTES)
    before = (ops.flash_attention.launches, dict(ops.flash_attention.routes))
    q, k, v = _inputs(3, 1, 40, 40, 2, 1, 32)
    ops.flash_attention(q, k, v, causal=True)
    ops.flash_attention_lse(q, k, v, causal=False)
    qg = q.clone().requires_grad_(True)
    ops.flash_attention(qg, k, v, causal=True, window=8).sum().backward()
    assert (ops.flash_attention.launches, ops.flash_attention.routes) == before
