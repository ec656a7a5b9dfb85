"""The arithmetic of the block-sparse SpMM kernel, on the CPU.

``csrc/spmm.cu::spmm_nnz_kernel`` runs only on the card. This file keeps a
plain-torch emulation of the order in which it computes, and holds that
emulation against the JAX package's Pallas kernel in interpret mode and
against its plain ``spmm_ref`` at 1e-5 (the reference's own tolerance).
The order:

* for each row tile of 32 rows, the list of its live 32 x 32 tiles (mask
  entry not 0), in ascending column order;
* with ``splits`` warps per row group, split s takes the tiles whose rank
  in that list is s modulo ``splits``;
* in a split, for each output row, the nonzeros of its tiles in ascending
  column order (a zero of A is skipped, never multiplied): the row's sums
  start at 0 and take one FMA per nonzero, sum = fma(a, X[k, :], sum);
* the partial sums of the splits are added in split order,
  (p0 + p1) + p2 ...

Which row group a warp owns, the batching of its loads and the column slab
move no operation of this order, so the same launch gives the same bits
every time; launches with another split may differ in the last bits.

An FMA is emulated as the product and sum in fp64, rounded once to fp32.
Skipping the zeros defines 0 * inf and 0 * NaN away: a non-finite row k of
X reaches exactly the rows of A with a nonzero in column k, as the
neighbor-list mean (``neighbor_mean_ref``) gives. Inputs come from numpy
with a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.spmm import ops as jops
from repro.kernels.spmm import ref as jref
from repro_torch.kernels.spmm import ops
from repro_torch.kernels.spmm import ref as tref

TOL = 1e-5
T = ops.TILE_K


def fma(a, b, c):
    """fp32 fmaf: a·b + c rounded once."""
    return (a.double() * b.double() + c.double()).float()


def kernel_order(a, x, mask, splits):
    """The kernel's order of operations on a (N, M), x (M, D) fp32 and the
    (ceil(N/32), ceil(M/32)) int32 mask; returns y (N, D) fp32."""
    n, m = a.shape
    d = x.shape[1]
    live = mask != 0
    rank = torch.cumsum(live.to(torch.int64), 1) - 1           # rank in the row tile's list
    tile_of_row = torch.arange(n) // ops.TILE_M
    parts = []
    for s in range(splits):
        mine = live & (rank % splits == s)                      # (row tiles, col tiles)
        p = torch.zeros((n, d))
        for k in range(m):
            a_k = a[:, k]
            rows = mine[tile_of_row, k // T] & (a_k != 0)
            if rows.any():
                p[rows] = fma(a_k[rows, None], x[k][None, :], p[rows])
        parts.append(p)
    y = parts[0]
    for p in parts[1:]:
        y = y + p
    return y


def _sparse(rng, n, m, density):
    return ((rng.random((n, m)) < density).astype(np.float32)
            * rng.random((n, m)).astype(np.float32))


def _hold(a, x, mask=None):
    """Every split against the JAX kernel in interpret mode and
    ``spmm_ref``; returns the outputs by split."""
    ta, tx = torch.from_numpy(a), torch.from_numpy(x)
    if mask is None:
        mask = ops.block_mask_from_dense(ta, ops.TILE_M, ops.TILE_K)
    wants = [np.asarray(jops.block_spmm(jnp.asarray(a), jnp.asarray(x), interpret=True)),
             np.asarray(jref.spmm_ref(jnp.asarray(a), jnp.asarray(x)))]
    outs = {}
    for splits in ops.SPLITS:
        y = kernel_order(ta, tx, mask, splits)
        assert y.dtype == torch.float32 and tuple(y.shape) == (a.shape[0], x.shape[1])
        assert torch.equal(y, kernel_order(ta, tx, mask, splits))    # same bits again
        for want in wants:
            np.testing.assert_allclose(y.numpy(), want, atol=TOL, rtol=TOL)
        outs[splits] = y
    return outs


@pytest.mark.parametrize("n,m,d,density", [
    (64, 64, 32, 0.1),
    (100, 130, 70, 0.05),     # ragged N, M and D
    (33, 257, 65, 0.02),      # one row past a tile; most tiles dead
    (40, 96, 19, 0.3),        # D not a multiple of 4 (the kernel's scalar columns)
])
def test_order_matches_reference(n, m, d, density):
    rng = np.random.default_rng(n * 7 + m * 3 + d)
    _hold(_sparse(rng, n, m, density), rng.standard_normal((m, d)).astype(np.float32))


def test_order_fully_dense_tiles():
    """Every element of A nonzero: 32 FMAs per row of every tile."""
    rng = np.random.default_rng(5)
    a = rng.random((64, 96)).astype(np.float32) + 0.1
    _hold(a, rng.standard_normal((96, 40)).astype(np.float32))


def test_order_live_tiles_with_zero_rows():
    """A mask that marks every tile live over an A whose tiles hold zero
    rows, and whole tiles of zeros: the kernel loads them and finds
    nothing to multiply."""
    rng = np.random.default_rng(6)
    a = _sparse(rng, 70, 100, 0.05)
    a[10:40] = 0.0
    a[:, 32:64] = 0.0
    mask = torch.ones((3, 4), dtype=torch.int32)
    _hold(a, rng.standard_normal((100, 33)).astype(np.float32), mask)


def test_order_all_dead_is_exactly_zero():
    rng = np.random.default_rng(7)
    a = np.zeros((300, 500), np.float32)
    x = rng.standard_normal((500, 64)).astype(np.float32)
    dead = torch.zeros((10, 16), dtype=torch.int32)
    for y in _hold(a, x, dead).values():
        assert torch.count_nonzero(y) == 0


def test_order_neighbor_adjacency():
    """The serving path's operands: the row-normalised adjacency and the
    mask scattered from a padded neighbor list, against the neighbor mean."""
    rng = np.random.default_rng(8)
    n, m, k = 70, 90, 6
    idx = rng.integers(0, m, (n, k)).astype(np.int32)
    nm = (rng.random((n, k)) < 0.7).astype(np.float32)
    ti, tm = torch.from_numpy(idx), torch.from_numpy(nm)
    a = ops.adjacency_from_neighbors(ti, tm, m)
    mask = ops.adjacency_block_mask(ti, tm, m, ops.TILE_M, ops.TILE_K)
    f = rng.standard_normal((m, 24)).astype(np.float32)
    want = tref.neighbor_mean_ref(torch.from_numpy(f), ti, tm)
    for y in _hold(a.numpy(), f, mask).values():
        np.testing.assert_allclose(y.numpy(), want.numpy(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_order_nonfinite_row_reaches_only_its_neighbors(bad):
    """One non-finite row k of X: exactly the rows with an edge to k are
    non-finite, as in the neighbor mean, and the rest agree with it; the
    dense ``spmm_ref`` makes every row non-finite (0 · inf)."""
    rng = np.random.default_rng(9)
    n, m, k = 64, 80, 5
    idx = rng.integers(1, m, (n, k)).astype(np.int32)
    nm = (rng.random((n, k)) < 0.7).astype(np.float32)
    idx[nm == 0] = 0                       # padding slots name row 0, not the bad row
    bad_row = int(idx[nm > 0][0])
    ti, tm = torch.from_numpy(idx), torch.from_numpy(nm)
    a = ops.adjacency_from_neighbors(ti, tm, m)
    mask = ops.adjacency_block_mask(ti, tm, m, ops.TILE_M, ops.TILE_K)
    f = torch.from_numpy(rng.standard_normal((m, 12)).astype(np.float32))
    f[bad_row] = bad
    reaches = ((ti == bad_row) & (tm > 0)).any(1)
    assert 0 < int(reaches.sum()) < n
    wants = [tref.neighbor_mean_ref(f, ti, tm),
             torch.from_numpy(np.array(jref.neighbor_mean_ref(
                 jnp.asarray(f.numpy()), jnp.asarray(idx), jnp.asarray(nm))))]
    assert (~torch.isfinite(tref.spmm_ref(a, f))).any(1).all()
    for splits in ops.SPLITS:
        y = kernel_order(a, f, mask, splits)
        finite_rows = torch.isfinite(y).all(1)
        assert torch.equal(~finite_rows, reaches)
        for want in wants:
            assert torch.equal(torch.isfinite(want).all(1), finite_rows)
            np.testing.assert_allclose(y[finite_rows].numpy(), want[finite_rows].numpy(),
                                       atol=TOL, rtol=TOL)


def test_launch_refuses_a_split_the_kernel_does_not_take():
    a = torch.zeros((4, 5))
    with pytest.raises(ValueError, match="splits"):
        ops.launch(a, torch.zeros((5, 3)), torch.zeros((1, 1), dtype=torch.int32), 3)
