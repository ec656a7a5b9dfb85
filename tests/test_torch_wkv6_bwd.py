"""The WKV6 recurrence's gradient in the port against the reference's, on the
CPU.

The reference differentiates ``wkv_scan`` (and the oracle ``wkv6_ref``)
with jnp's autodiff; the port computes the gradient itself: the plain
``ref.wkv6_bwd_ref`` (what ``WKV6`` runs on CPU tensors) and, on the card,
the backward kernels of ``csrc/wkv6.cu``. Here, at the reference's grad
tier (rtol 1e-4, atol 1e-5), on inputs from numpy with a seed, at a ragged
T, N of 32, 64 and 128, w drawn as the model draws it (exp(-exp(.))), near
0 (1e-6) and near 1 (0.999), with and without an incoming gradient of S:

* ``wkv6_bwd_ref`` against ``jax.vjp`` of ``repro.kernels.wkv6.ref.wkv6_ref``
  and of ``repro.models.rwkv.wkv_scan``;
* ``WKV6.apply`` on CPU tensors (its plain pair) against the same, the
  stage states its forward saves against the states the reference's scan
  passes through, and ``wkv6_bwd_reduce_ref`` (the plain version of the
  backward's second kernel) completing the reference's dv and du from
  their shares;
* a plain-torch emulation of the backward kernels' order of arithmetic
  (``kernel_bwd_order``) against the same. The kernels sum in another
  order than the plain version: per (step, key row) dr, dw and dk over the
  value columns in order, dv over 16 key rows a block and then the N / 16
  blocks' shares in order, v·dy and coef over 32 lanes and an xor tree,
  du over sub-stages, stages and then b. In bf16 the emulation is held at
  ``chip_smoke.py``'s gate (rtol 2^-7, atol 4 x the fp32 emulation's error
  on the same inputs widened), so the gate is known to hold before the
  card. An FMA is emulated as the product and sum in fp64 rounded once to
  fp32.
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
# csrc/wkv6.cu's kTS, kRG and kSub: steps per stage, key rows per backward
# block, steps per sub-stage (the states it holds in shared memory at once)
TS, RG, SUB = tref.STAGE_STEPS, ops.BWD_ROWS, 8

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
    return ops.wkv6.launches, ops.wkv6_bwd_blocks.launches, ops.wkv6_bwd_reduce.launches


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


@pytest.mark.parametrize("name", ["n32_ragged", "w_near0_ds"])
def test_reduce_ref_completes_the_reference_gradient(name, want):
    """``wkv6_bwd_reduce_ref``, the plain version of the backward's second
    kernel: from dv's N / 16 shares (any split of the reference's
    Σ_n G_t[n] k_t[n]) and du per b (the reference's du of each b alone)
    it gives the reference's dv and du."""
    ins, dy, ds = _inputs(name)
    r, k, _, _, u = ins
    B, T, H, N = r.shape
    dv, du = want(name)[0][2], want(name)[0][4]
    rest = dv - (r * u * k).sum(-1, keepdims=True) * dy
    shares = np.random.default_rng(0).standard_normal((N // RG - 1, B, T, H, N))
    dv_part = np.concatenate([shares, (rest - shares.sum(0))[None]]).astype(np.float32)
    du_part = np.stack([
        _jax_vjp(jref.wkv6_ref, [a[b:b + 1] for a in ins[:4]] + [u], dy[b:b + 1],
                 None if ds is None else ds[b:b + 1])[4] for b in range(B)])
    got = tref.wkv6_bwd_reduce_ref(*map(torch.from_numpy, (r, k, u, dy, dv_part, du_part)))
    np.testing.assert_allclose(got[0].numpy(), dv, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[1].numpy(), du, rtol=RTOL, atol=ATOL)


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


def kernel_bwd_order(r, k, v, w, u, dy, ds=None):
    """``csrc/wkv6.cu``'s forward state updates and its backward pair, in
    their order, on r, k, v, dy (B, T, H, N) fp32 or bf16, w fp32, u (H, N),
    ds (B, H, N, N) or None. Returns (dr, dk, dv in r's dtype, dw, du fp32).

    The states: S = fmaf(w, S, k·v), the forward kernel's instruction (the
    backward recomputes a stage from the forward's saved state with the
    same one, so these are its states bit for bit). G = fmaf(w, G, r·dy).
    Per (step, key row): dr, dw, dk summed over the value columns in order
    (FMAs), then dr = fmaf(u·k, v·dy, ·), dk = fmaf(u·r, v·dy, ·), and du's
    term (r·k)·(v·dy); a row's du sums its terms over each 8-step
    sub-stage, those sums over the stage and the stages' sums over T, each
    in reverse. dv: per
    block of 16 key rows a share (FMAs over its rows in order), the shares
    added in block order, then fmaf(coef, dy, ·); du's shares over b in
    order."""
    B, T, H, N = r.shape
    rf, kf, vf, dyf = (a.float().transpose(1, 2) for a in (r, k, v, dy))   # (B, H, T, N)
    wf = w.float().transpose(1, 2)
    uf = u.float()[None]                                                    # (1, H, N)
    vdy = _lanes_then_tree(vf, dyf)                                         # (B, H, T)
    coef = _lanes_then_tree(rf * uf[:, :, None], kf)                        # (B, H, T)
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
        ar, aw, ak = (torch.zeros((B, H, N)) for _ in range(3))
        for m in range(N):
            ar = fma(Sp[..., m], dyf[:, :, t, None, m], ar)
            aw = fma(Sp[..., m], G[..., m], aw)
            ak = fma(G[..., m], vf[:, :, t, None, m], ak)
        vd = vdy[:, :, t, None]
        dr[:, :, t] = fma(uf * kf[:, :, t], vd, ar)
        dk[:, :, t] = fma(uf * rf[:, :, t], vd, ak)
        dw[:, :, t] = aw
        terms[t] = (rf[:, :, t] * kf[:, :, t]) * vd
        shares = []
        for g in range(N // RG):
            acc = torch.zeros((B, H, N))
            for ii in range(g * RG, (g + 1) * RG):
                acc = fma(G[:, :, ii, :], kf[:, :, t, ii, None], acc)
            shares.append(acc)
        tot = shares[0]
        for sh in shares[1:]:
            tot = tot + sh
        dv[:, :, t] = fma(coef[:, :, t, None], dyf[:, :, t], tot)
        G = fma(wf[:, :, t, :, None], G, rf[:, :, t, :, None] * dyf[:, :, t, None, :])
    du = torch.zeros((B, H, N))
    for t0 in reversed(range(0, T, TS)):
        stage = torch.zeros((B, H, N))
        for a in reversed(range(t0, min(t0 + TS, T), SUB)):
            sub = torch.zeros((B, H, N))
            for t in reversed(range(a, min(a + SUB, T))):
                sub = sub + terms[t]
            stage = stage + sub
        du = du + stage
    du_sum = du[0]
    for b in range(1, B):
        du_sum = du_sum + du[b]
    back = lambda a, dt: a.transpose(1, 2).to(dt)
    return (back(dr, r.dtype), back(dk, r.dtype), back(dv, r.dtype), back(dw, torch.float32),
            du_sum)


@pytest.mark.parametrize("name", ["n32_ragged", "n64_ds", "w_near0_ds", "w_near1"])
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
