"""The SpMM as the training path uses it, and the two faults it had.

* ``block_spmm`` is differentiable in ``x``: its backward is ``dx = Aᵀ·dy``
  through the same wrapper (on the card, the kernel's transposed launch).
  On CPU tensors it is held against autograd of the plain dense product
  and against the reference's custom VJP (Pallas in interpret mode, tiny
  shapes), at the reference's spmm tolerance 1e-5.
* A non-finite row of X reaches the same rows under the gather, segment
  and spmm backends: the rows that name it (the kernel's rule). The CPU
  path used to multiply the zeros too and poison every row.
* The segment backend sums only the bucketed CSR layout and refuses the
  reference's two-call layout (real edges first, padding after), which it
  used to sum wrong without a word.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph.csr import csr_from_padded as jcsr_from_padded
from repro.kernels.spmm import ops as jops
from repro_torch.graph.csr import bucketed_csr_from_padded
from repro_torch.kernels.spmm import ops as tops
from repro_torch.kernels.spmm import ref as tref
from repro_torch.models import gcn as tgcn

TOL = 1e-5


def _case(seed, n=21, m=27, k=5, d=8):
    """A padded batch with the awkward rows of tests/test_train_backend.py:
    isolated rows, duplicate slots, reads of ghost rows (here: high
    columns), and a ragged row count."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, m, (n, k)).astype(np.int32)
    idx[3] = idx[3, 0]                                   # duplicate slots
    idx[5, :2] = m - 1                                   # ghost reads
    mask = (rng.random((n, k)) < 0.6).astype(np.float32)
    mask[[0, 7]] = 0.0                                   # isolated rows
    mask[5, :2] = 1.0
    x = rng.standard_normal((m, d)).astype(np.float32)
    dy = rng.standard_normal((n, d)).astype(np.float32)
    return idx, mask, x, dy


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("normalised", [True, False])
def test_value_and_grad_match_plain_autograd_and_reference_vjp(seed, normalised):
    idx, mask, x, dy = _case(seed)
    ti, tm = torch.from_numpy(idx), torch.from_numpy(mask)
    a = tops.adjacency_from_neighbors(ti, tm, x.shape[0])
    if not normalised:                  # Aᵀ's rows do not sum to 1 either
        a = a * 3.7
    bm = tops.adjacency_block_mask(ti, tm, x.shape[0], tops.TILE_M, tops.TILE_K)
    tx = torch.from_numpy(x).requires_grad_(True)
    y = tops.block_spmm(a, tx, bm)
    (dx,) = torch.autograd.grad(y, tx, torch.from_numpy(dy))

    px = torch.from_numpy(x).requires_grad_(True)
    y_plain = tref.spmm_ref(a, px)
    (dx_plain,) = torch.autograd.grad(y_plain, px, torch.from_numpy(dy))

    ja = jnp.asarray(a.numpy())
    jy, vjp = jax.vjp(lambda v: jops.block_spmm(ja, v, interpret=True), jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(dy))
    for want_y, want_dx in ((y_plain.detach().numpy(), dx_plain.numpy()),
                            (np.asarray(jy), np.asarray(jdx))):
        np.testing.assert_allclose(y.detach().numpy(), want_y, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(dx.numpy(), want_dx, atol=TOL, rtol=TOL)
    # isolated rows send nothing back; a column no row names gets 0
    named = np.zeros(x.shape[0], bool)
    named[idx[mask > 0]] = True
    assert np.all(dx.numpy()[~named] == 0)


def test_backward_runs_only_where_x_needs_a_grad(monkeypatch):
    """The transposed product runs only when ``x`` asks for a grad, with
    Aᵀ and the transposed block mask; A itself gets none."""
    idx, mask, x, dy = _case(3)
    ti, tm = torch.from_numpy(idx), torch.from_numpy(mask)
    a = tops.adjacency_from_neighbors(ti, tm, x.shape[0])
    bm = tops.adjacency_block_mask(ti, tm, x.shape[0], tops.TILE_M, tops.TILE_K)
    calls = []
    real = tops._product

    def counted(a_, x_, mask_):
        calls.append((tuple(a_.shape), None if mask_ is None else tuple(mask_.shape)))
        return real(a_, x_, mask_)

    monkeypatch.setattr(tops, "_product", counted)
    a_req = a.clone().requires_grad_(True)
    y = tops.block_spmm(a_req, torch.from_numpy(x), bm)
    y.sum().backward()
    assert a_req.grad is None and calls == [(a.shape, tuple(bm.shape))]
    calls.clear()
    with torch.no_grad():
        tops.block_spmm(a, torch.from_numpy(x).requires_grad_(True), bm)
    assert len(calls) == 1
    calls.clear()
    tx = torch.from_numpy(x).requires_grad_(True)
    tops.block_spmm(a, tx, bm).backward(torch.from_numpy(dy))
    assert calls == [(a.shape, tuple(bm.shape)), (a.t().shape, tuple(bm.t().shape))]
    assert tx.grad is not None


def test_cpu_backward_never_moves_the_launch_counter():
    idx, mask, x, dy = _case(4)
    a = tops.adjacency_from_neighbors(torch.from_numpy(idx), torch.from_numpy(mask),
                                      x.shape[0])
    before = tops.block_spmm.launches
    tx = torch.from_numpy(x).requires_grad_(True)
    tops.block_spmm(a, tx).backward(torch.from_numpy(dy))
    assert tops.block_spmm.launches == before


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_nonfinite_row_reaches_the_same_rows_on_every_backend(bad):
    """40 batch rows, K 4, M 600, one non-finite row named by one batch row:
    every backend makes exactly that row non-finite."""
    rng = np.random.default_rng(12)
    n, k, m, d = 40, 4, 600, 16
    bad_row = 321
    idx = rng.integers(0, m, (n, k)).astype(np.int32)
    idx[idx == bad_row] = bad_row + 1
    mask = (rng.random((n, k)) < 0.8).astype(np.float32)
    idx[17, 2], mask[17, 2] = bad_row, 1.0
    table = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32))
    table[bad_row] = bad
    ti, tm = torch.from_numpy(idx), torch.from_numpy(mask)
    rows = {be: (~torch.isfinite(tgcn.neighbor_aggregate(table, ti, tm, backend=be))).any(1)
            for be in tgcn.AGG_BACKENDS}
    for be, r in rows.items():
        assert r.nonzero().flatten().tolist() == [17], be
    # on the finite rows the backends agree, as they do without the bad row
    ok = ~rows["gather"]
    want = tgcn.neighbor_aggregate(table, ti, tm, backend="gather")[ok]
    for be in ("segment", "spmm"):
        got = tgcn.neighbor_aggregate(table, ti, tm, backend=be)[ok]
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=TOL)


def test_nonzeros_ref_matches_the_dense_plain_version():
    rng = np.random.default_rng(5)
    a = ((rng.random((33, 70)) < 0.1) * rng.random((33, 70))).astype(np.float32)
    x = rng.standard_normal((70, 9)).astype(np.float32)
    got = tref.spmm_nonzeros_ref(torch.from_numpy(a), torch.from_numpy(x))
    want = tref.spmm_ref(torch.from_numpy(a), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=TOL)
    assert tref.spmm_nonzeros_ref(torch.zeros(4, 5), torch.ones(5, 3)).abs().max() == 0


def _two_call_layout(idx, mask):
    """The reference's two-call serve operands
    (``repro/serve/engine.py:214-230``): the real edges first, then
    padding routed to segment b."""
    b, k = idx.shape
    c = jcsr_from_padded(idx, mask)
    e = len(c["src"])
    src = np.zeros(b * k, np.int32)
    src[:e] = c["src"]
    dst = np.full(b * k, b, np.int32)
    dst[:e] = c["dst"]
    return {"src": torch.from_numpy(src), "dst": torch.from_numpy(dst),
            "inv_deg": torch.from_numpy(c["inv_deg"])}


def test_segment_refuses_a_layout_that_is_not_bucketed():
    idx, mask, x, _ = _case(6, n=8, k=4)
    ti, tm, tx = torch.from_numpy(idx), torch.from_numpy(mask), torch.from_numpy(x)
    with pytest.raises(ValueError, match="bucketed"):
        tgcn.neighbor_aggregate(tx, ti, tm, backend="segment",
                                csr=_two_call_layout(idx, mask))
    short = {k: v[:-1] if k != "inv_deg" else v
             for k, v in bucketed_csr_from_padded(ti, tm).items()}
    with pytest.raises(ValueError, match="bucketed"):
        tgcn.neighbor_aggregate(tx, ti, tm, backend="segment", csr=short)
    got = tgcn.neighbor_aggregate(tx, ti, tm, backend="segment",
                                  csr=bucketed_csr_from_padded(ti, tm))
    want = tgcn.neighbor_aggregate(tx, ti, tm, backend="gather")
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=TOL)
