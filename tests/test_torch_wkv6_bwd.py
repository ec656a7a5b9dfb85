"""The WKV6 recurrence's gradient in the port against the reference's, on the
CPU.

The reference differentiates ``wkv_scan`` (and the oracle ``wkv6_ref``)
with jnp's autodiff; the port computes the gradient itself: the plain
``ref.wkv6_bwd_ref`` (what ``WKV6`` runs on CPU tensors) and, on the card,
the backward kernel of ``csrc/wkv6.cu``. Here, at the reference's grad
tier (rtol 1e-4, atol 1e-5), on inputs from numpy with a seed, at a ragged
T, N of 32, 64 and 128, w drawn as the model draws it (exp(-exp(.))), near
0 (1e-6) and near 1 (0.999), with and without an incoming gradient of S:

* ``wkv6_bwd_ref`` against ``jax.vjp`` of ``repro.kernels.wkv6.ref.wkv6_ref``
  and of ``repro.models.rwkv.wkv_scan``;
* ``WKV6.apply`` on CPU tensors (its plain pair) against the same, and the
  stage states its forward saves against the states the reference's scan
  passes through;
* a plain-torch emulation of the backward kernel's order of arithmetic
  (``kernel_bwd_order``) against the same. The kernel sums in another
  order than the plain version: per (step, key row) dr, dw and dk over 4
  value columns a lane (FMAs), then folded over the row's N / 4 lanes (the
  butterfly); dv per row pair (an FMA), the pairs of a block (32 key rows
  up to N = 64, 16 at 128) in order, then the cluster's N / 32 or N / 16
  blocks in rank order; coef per block (folded over its rows' lanes), then
  the blocks in order; v·dy over
  32 lanes and an xor tree; du over sub-stages, stages and then b. dv's
  and du's orders are also held alone, on the reference's G. In bf16 the
  emulation is held at ``chip_smoke.py``'s gate (rtol 2^-7, atol 4 x the
  fp32 emulation's error on the same inputs widened), so the gate is known
  to hold before the card. An FMA is emulated as the product and sum in
  fp64 rounded once to fp32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6 import ref as jref
from repro.models import rwkv as jrwkv
from repro_torch.kernels.wkv6 import ops
from repro_torch.kernels.wkv6 import ref as tref

RTOL, ATOL = 1e-4, 1e-5
RTOL_BF16 = 2.0 ** -7
# csrc/wkv6.cu's kTS, kSub and kBC: steps per stage, steps per sub-stage
# (the states it holds in registers at once), value columns per thread (a
# key row's lanes are N / kBC); its key rows per backward block are
# ops.bwd_rows(N)
TS, SUB, COLS = tref.STAGE_STEPS, 8, 4

# (B, T, H, N, w, incoming gradient of S): T ragged against the 32-step
# stage (and the kernel's 8-step sub-stage) in every case
CASES = {
    "n32_ragged": (2, 70, 2, 32, "model", False),
    "n64_ds": (1, 45, 2, 64, "model", True),
    "n128_ds": (1, 37, 1, 128, "model", True),
    "w_near0_ds": (2, 41, 1, 32, 1e-6, True),
    "w_near1": (1, 75, 2, 32, 0.999, False),
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(name):
    B, T, H, N, wmode, with_ds = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    r, k, v = (rng.standard_normal((B, T, H, N)).astype(np.float32) * 0.5 for _ in range(3))
    if wmode == "model":
        w = np.exp(-np.exp(rng.standard_normal((B, T, H, N)) - 2.0)).astype(np.float32)
    else:
        w = np.full((B, T, H, N), wmode, np.float32)
    u = (rng.standard_normal((H, N)) * 0.5).astype(np.float32)
    dy = rng.standard_normal((B, T, H, N)).astype(np.float32)
    ds = rng.standard_normal((B, H, N, N)).astype(np.float32) if with_ds else None
    return (r, k, v, w, u), dy, ds


def _jax_vjp(fn, ins, dy, ds):
    (y, s), vjp = jax.vjp(fn, *map(jnp.asarray, ins))
    ds = np.zeros(s.shape, np.float32) if ds is None else ds
    return [np.asarray(g) for g in vjp((jnp.asarray(dy), jnp.asarray(ds)))]


@pytest.fixture(scope="module")
def want():
    cache = {}

    def get(name):
        if name not in cache:
            ins, dy, ds = _inputs(name)
            cache[name] = (_jax_vjp(jref.wkv6_ref, ins, dy, ds),
                           _jax_vjp(jrwkv.wkv_scan, ins, dy, ds))
        return cache[name]

    return get


def _close(got, grads, what):
    for name, g, w in zip(("dr", "dk", "dv", "dw", "du"), got, grads):
        g = g.detach().float().numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=f"{what} {name}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_bwd_ref_matches_jax_vjp(name, want):
    ins, dy, ds = _inputs(name)
    got = tref.wkv6_bwd_ref(*map(torch.from_numpy, ins), torch.from_numpy(dy),
                            None if ds is None else torch.from_numpy(ds))
    assert [g.dtype for g in got] == [torch.float32] * 5
    for grads, what in zip(want(name), ("wkv6_ref", "wkv_scan")):
        _close(got, grads, what)


def _launches():
    return ops.wkv6.launches, ops.wkv6_bwd.launches


@pytest.mark.parametrize("name", sorted(CASES))
def test_wkv6_autograd_on_the_cpu_matches_jax_vjp(name, want):
    """``wkv6`` with a gradient wanted goes through ``WKV6`` (its plain
    pair on CPU tensors) and launches nothing."""
    ins, dy, ds = _inputs(name)
    ts = [torch.tensor(a, requires_grad=True) for a in ins]
    before = _launches()
    y, s = ops.wkv6(*ts)
    assert type(y.grad_fn).__name__ == "WKV6Backward"
    outs, cot = ((y, s), (torch.from_numpy(dy), torch.from_numpy(ds))) if ds is not None \
        else ((y,), (torch.from_numpy(dy),))
    got = torch.autograd.grad(outs, ts, cot)
    assert _launches() == before
    _close(got, want(name)[0], "WKV6")


@pytest.mark.parametrize("name", ["n32_ragged", "n128_ds", "w_near1"])
def test_stage_states_match_the_reference_scan(name):
    """The forward's saved states: S at the start of each 32-step stage,
    against the reference's state after that many steps; y and S as the
    serving call gives them."""
    ins, _, _ = _inputs(name)
    T = ins[0].shape[1]
    y, s, states = tref.wkv6_ref(*map(torch.from_numpy, ins), stage_states=True)
    y0, s0 = tref.wkv6_ref(*map(torch.from_numpy, ins))
    assert torch.equal(y, y0) and torch.equal(s, s0)
    assert states.shape[2] == -(-T // TS) and states.dtype == torch.float32
    assert not states[:, :, 0].any()
    for st in range(1, states.shape[2]):
        _, want_s = jref.wkv6_ref(*(jnp.asarray(a[:, :st * TS]) for a in ins[:4]),
                                  jnp.asarray(ins[4]))
        np.testing.assert_allclose(states[:, :, st].numpy(), np.asarray(want_s),
                                   rtol=1e-5, atol=1e-5)


def test_an_unused_state_gets_no_gradient_and_no_grad_takes_the_serving_path():
    ins, dy, _ = _inputs("n32_ragged")
    ts = [torch.tensor(a, requires_grad=True) for a in ins]
    y, _ = ops.wkv6(*ts)
    (y * torch.from_numpy(dy)).sum().backward()
    want = tref.wkv6_bwd_ref(*map(torch.from_numpy, ins), torch.from_numpy(dy), None)
    for t, w in zip(ts, want):
        assert torch.equal(t.grad, w)
    with torch.no_grad():
        y, s = ops.wkv6(*ts)
    assert y.grad_fn is None and torch.equal(y, tref.wkv6_ref(*ts)[0].detach())


# ---------------------------------------------------------------------------
# the backward kernels' order of arithmetic
# ---------------------------------------------------------------------------

def fma(a, b, c):
    """fp32 fmaf: a·b + c rounded once."""
    return (a.double() * b.double() + c.double()).float()


def _lanes_then_tree(x, y):
    """Σ_n x·y as a warp sums it: lane l takes n = l + 32 j (FMAs, j
    ascending), then an xor tree over the 32 lanes. x, y (..., N)."""
    lead, N = x.shape[:-1], x.shape[-1]
    xl = x.reshape(*lead, N // 32, 32)
    yl = y.reshape(*lead, N // 32, 32)
    acc = torch.zeros((*lead, 32))
    for j in range(N // 32):
        acc = fma(xl[..., j, :], yl[..., j, :], acc)
    lanes = torch.arange(32)
    off = 16
    while off:
        acc = acc + acc[..., lanes ^ off]
        off //= 2
    return acc[..., 0]


def _fold(acc):
    """Sum the last axis as a butterfly over lanes does: lane l + L/2 onto
    l, then L/4, ..., 1 (L a power of 2)."""
    while acc.shape[-1] > 1:
        h = acc.shape[-1] // 2
        acc = acc[..., :h] + acc[..., h:]
    return acc[..., 0]


def _row_sum(x, y):
    """Σ_m x·y over a key row as the kernel sums it: lane l of the row's
    N / 4 lanes takes columns 4l .. 4l + 3 (FMAs, columns ascending), then
    the lanes fold (``_fold``). x, y broadcast to (..., N)."""
    x, y = torch.broadcast_tensors(x, y)
    lead, N = x.shape[:-1], x.shape[-1]
    xl = x.reshape(*lead, N // COLS, COLS)
    yl = y.reshape(*lead, N // COLS, COLS)
    acc = torch.zeros((*lead, N // COLS))
    for c in range(COLS):
        acc = fma(xl[..., c], yl[..., c], acc)
    return _fold(acc)


def _in_order(parts):
    """((p0 + p1) + p2) + ...: a sum over blocks (or b) in order."""
    tot = parts[0]
    for p in parts[1:]:
        tot = tot + p
    return tot


def _coef(r, u, k):
    """coef = Σ_n r·u·k as the kernel sums it: (r·u)·k per key row, folded
    over each block's rows (one lane each), then the blocks in rank order.
    r, k (..., N), u broadcast to them."""
    x = (r * u) * k
    N = x.shape[-1]
    rg = ops.bwd_rows(N)
    return _in_order([_fold(x[..., g * rg:(g + 1) * rg]) for g in range(N // rg)])


def _dv_sum(G, k):
    """Σ_n G[n][m]·k[n] as the cluster sums it: per row pair fmaf(G[1], k1,
    G[0]·k0), the pairs of a block in order, then the blocks in rank order.
    G (..., N, N), k (..., N); returns (..., N)."""
    N = G.shape[-1]
    pairs = fma(G[..., 1::2, :], k[..., 1::2, None], G[..., 0::2, :] * k[..., 0::2, None])
    rg = ops.bwd_rows(N)
    per = rg // 2
    return _in_order([_in_order([pairs[..., p, :] for p in range(g * per, (g + 1) * per)])
                      for g in range(N // rg)])


def _du_sum(terms, T):
    """du over t as the kernel sums a row's terms ((r·k)·(v·dy), one per
    step; ``terms[t]`` (B, H, N)): each 8-step sub-stage's in reverse, the
    sub-stages' sums into the stage's, the stages' into the total, each in
    reverse; then the B shares in b order."""
    du = torch.zeros_like(terms[0])
    for t0 in reversed(range(0, T, TS)):
        stage = torch.zeros_like(du)
        for a in reversed(range(t0, min(t0 + TS, T), SUB)):
            sub = torch.zeros_like(du)
            for t in reversed(range(a, min(a + SUB, T))):
                sub = sub + terms[t]
            stage = stage + sub
        du = du + stage
    return _in_order(list(du))


def kernel_bwd_order(r, k, v, w, u, dy, ds=None):
    """``csrc/wkv6.cu``'s forward state updates and its backward kernel, in
    their order, on r, k, v, dy (B, T, H, N) fp32 or bf16, w fp32, u (H, N),
    ds (B, H, N, N) or None. Returns (dr, dk, dv in r's dtype, dw, du fp32).

    The states: S = fmaf(w, S, k·v), the forward kernel's instruction (the
    backward recomputes a stage from the forward's saved state with the
    same one, so these are its states bit for bit). G = fmaf(w, G, r·dy).
    Per (step, key row): dr, dw, dk summed as ``_row_sum``, then dr =
    fmaf(u·k, v·dy, ·), dk = fmaf(u·r, v·dy, ·), and du's term (r·k)·(v·dy),
    summed as ``_du_sum``; dv = fmaf(coef, dy, ``_dv_sum``) with coef as
    ``_coef``; v·dy over 32 lanes and an xor tree."""
    B, T, H, N = r.shape
    rf, kf, vf, dyf = (a.float().transpose(1, 2) for a in (r, k, v, dy))   # (B, H, T, N)
    wf = w.float().transpose(1, 2)
    uf = u.float()[None]                                                    # (1, H, N)
    vdy = _lanes_then_tree(vf, dyf)                                         # (B, H, T)
    coef = _coef(rf, uf[:, :, None], kf)                                    # (B, H, T)
    S = torch.zeros((B, H, N, N))
    before = []
    for t in range(T):
        before.append(S)
        S = fma(wf[:, :, t, :, None], S, kf[:, :, t, :, None] * vf[:, :, t, None, :])
    G = torch.zeros((B, H, N, N)) if ds is None else ds.float().clone()
    dr, dk, dw, dv = (torch.zeros((B, H, T, N)) for _ in range(4))
    terms = [None] * T
    for t in reversed(range(T)):
        Sp = before[t]
        vd = vdy[:, :, t, None]
        dr[:, :, t] = fma(uf * kf[:, :, t], vd, _row_sum(Sp, dyf[:, :, t, None, :]))
        dk[:, :, t] = fma(uf * rf[:, :, t], vd, _row_sum(G, vf[:, :, t, None, :]))
        dw[:, :, t] = _row_sum(Sp, G)
        terms[t] = (rf[:, :, t] * kf[:, :, t]) * vd
        dv[:, :, t] = fma(coef[:, :, t, None], dyf[:, :, t], _dv_sum(G, kf[:, :, t]))
        G = fma(wf[:, :, t, :, None], G, rf[:, :, t, :, None] * dyf[:, :, t, None, :])
    back = lambda a, dt: a.transpose(1, 2).to(dt)
    return (back(dr, r.dtype), back(dk, r.dtype), back(dv, r.dtype), back(dw, torch.float32),
            _du_sum(terms, T))


@pytest.mark.parametrize("name", ["n32_ragged", "n64_ds", "n128_ds", "w_near0_ds", "w_near1"])
def test_kernel_order_matches_jax_vjp(name, want):
    ins, dy, ds = _inputs(name)
    got = kernel_bwd_order(*map(torch.from_numpy, ins), torch.from_numpy(dy),
                           None if ds is None else torch.from_numpy(ds))
    _close(got, want(name)[0], "kernel order")


@pytest.mark.parametrize("name", ["n32_ragged", "n64_ds"])
def test_kernel_order_in_bf16_holds_the_chip_gate(name):
    """bf16 r, k, v, dy: dr, dk, dv within rtol 2^-7 and 4 x the fp32
    emulation's max error on the same inputs widened, of the plain version
    in bf16 (what ``chip_smoke.py`` asks of the kernels); dw and du, fp32
    sums of the same widened inputs, within 1e-4."""
    ins, dy, ds = _inputs(name)
    r, k, v = (torch.from_numpy(a).bfloat16() for a in ins[:3])
    w, u = torch.from_numpy(ins[3]), torch.from_numpy(ins[4])
    dyb = torch.from_numpy(dy).bfloat16()
    dst = None if ds is None else torch.from_numpy(ds)
    got = kernel_bwd_order(r, k, v, w, u, dyb, dst)
    plain = tref.wkv6_bwd_ref(r, k, v, w, u, dyb, dst)
    wide = [a.float() for a in (r, k, v)]
    e32 = max(float((a - b).abs().max()) for a, b in zip(
        kernel_bwd_order(*wide, w, u, dyb.float(), dst)[:3],
        tref.wkv6_bwd_ref(*wide, w, u, dyb.float(), dst)[:3]))
    assert 0 < e32 < 1e-4
    for gname, g, p in zip(("dr", "dk", "dv"), got[:3], plain[:3]):
        assert g.dtype == p.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), p.float(), rtol=RTOL_BF16, atol=4 * e32,
                                   msg=lambda m: f"{gname}: {m}")
    for g, p in zip(got[3:], plain[3:]):
        torch.testing.assert_close(g, p.float(), rtol=1e-4, atol=1e-4)


def _g_states(ins, dy, ds):
    """G_t = dL/dS_t for every t, (B, H, T, N, N), from the recurrence in
    fp64 (independent of both the kernel's order and the plain version's)."""
    r, w = (np.asarray(a, np.float64).transpose(0, 2, 1, 3) for a in (ins[0], ins[3]))
    B, H, T, N = r.shape
    dyt = np.asarray(dy, np.float64).transpose(0, 2, 1, 3)
    G = np.zeros((B, H, N, N)) if ds is None else np.asarray(ds, np.float64).copy()
    out = np.zeros((B, H, T, N, N))
    for t in reversed(range(T)):
        out[:, :, t] = G
        G = w[:, :, t, :, None] * G + r[:, :, t, :, None] * dyt[:, :, t, None, :]
    return out


@pytest.mark.parametrize("name", ["n32_ragged", "n64_ds", "n128_ds"])
def test_cluster_dv_and_ticket_du_orders_match_jax_vjp(name, want):
    """dv and du alone in the kernel's order, on the reference's G_t: dv_t
    = fmaf(coef_t, dy_t, Σ_n G_t[n] k_t[n]) with the row pairs, the blocks
    and the cluster's ranks (1, 2, 8 at N 32, 64, 128) summed in order and
    coef likewise; du's terms over sub-stages, stages and then b in order
    (the ticket's last block)."""
    ins, dy, ds = _inputs(name)
    r, k, v = (torch.from_numpy(a).transpose(1, 2) for a in ins[:3])
    u = torch.from_numpy(ins[4])
    dyt = torch.from_numpy(dy).transpose(1, 2)
    B, H, T, N = r.shape
    G = torch.from_numpy(_g_states(ins, dy, ds)).float()
    coef = _coef(r, u[None, :, None], k)
    dv = torch.stack([fma(coef[:, :, t, None], dyt[:, :, t], _dv_sum(G[:, :, t], k[:, :, t]))
                      for t in range(T)], 2)
    vdy = _lanes_then_tree(v, dyt)
    du = _du_sum([(r[:, :, t] * k[:, :, t]) * vdy[:, :, t, None] for t in range(T)], T)
    np.testing.assert_allclose(dv.transpose(1, 2).numpy(), want(name)[0][2], rtol=RTOL,
                               atol=ATOL, err_msg="dv")
    np.testing.assert_allclose(du.numpy(), want(name)[0][4], rtol=RTOL, atol=ATOL,
                               err_msg="du")
