"""The port's SpMM module against the reference's, on CPU tensors.

On the CPU, ``repro_torch.kernels.spmm.ops.block_spmm`` takes its plain
version (the CUDA kernel is held against that same plain version on the
card by ``chip_smoke.py``); the reference runs its Pallas kernel in
interpret mode, as its own tests do. Inputs come from numpy with a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.spmm import ops as jops
from repro.kernels.spmm import ref as jref
from repro_torch.kernels import build
from repro_torch.kernels.spmm import ops as tops
from repro_torch.kernels.spmm import ref as tref

SHAPES = [(64, 64, 32), (100, 130, 70), (256, 256, 128), (33, 257, 65)]


def _sparse(rng, n, m, density=0.1):
    return ((rng.random((n, m)) < density).astype(np.float32)
            * rng.random((n, m)).astype(np.float32))


@pytest.mark.parametrize("n,m,d", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_spmm_matches_reference(n, m, d, dtype):
    rng = np.random.default_rng(n * 7 + m * 3 + d)
    a = _sparse(rng, n, m)
    x = rng.standard_normal((m, d)).astype(np.float32)
    td = getattr(torch, dtype)
    jd = getattr(jnp, dtype)
    got = tops.block_spmm(torch.from_numpy(a).to(td), torch.from_numpy(x).to(td))
    want_kernel = jops.block_spmm(jnp.asarray(a, jd), jnp.asarray(x, jd),
                                  interpret=True)
    want_ref = jref.spmm_ref(jnp.asarray(a, jd), jnp.asarray(x, jd))
    tol = 1e-5 if dtype == "float32" else 3e-2
    assert got.dtype == td and tuple(got.shape) == (n, d)
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=tol, rtol=tol)


def test_single_live_tile_is_exact():
    rng = np.random.default_rng(1)
    a = np.zeros((256, 256), np.float32)
    a[:64, :64] = rng.random((64, 64))
    x = rng.standard_normal((256, 64)).astype(np.float32)
    at = torch.from_numpy(a)
    mask = tops.block_mask_from_dense(at, 128, 32)
    assert mask.shape == (2, 8) and mask.sum() == 2          # rows 0..127, k 0..63
    assert mask[0, :2].tolist() == [1, 1]
    got = tops.block_spmm(at, torch.from_numpy(x), mask)
    want = jops.block_spmm(jnp.asarray(a), jnp.asarray(x), block_n=64,
                           block_m=64, block_d=64, interpret=True)
    np.testing.assert_allclose(got.numpy(), a @ x, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def _neighbor_case(seed, n=40, m=57, k=6):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, m, (n, k)).astype(np.int32)
    mask = (rng.random((n, k)) < 0.6).astype(np.float32)
    mask[:3] = 0.0                                    # isolated rows
    idx[mask == 0] = 0                                # padding slots point at 0
    idx[5, 0], mask[5, 0] = 0, 1.0                    # a real edge into column 0
    idx[6, :3], mask[6, :3] = m // 2, 1.0             # one real edge three times
    idx[7, -1], mask[7, -1] = m - 1, 0.0              # padding naming a column
    return idx, mask


@pytest.mark.parametrize("blocks", [(128, 32), (32, 32), (8, 16)])
def test_adjacency_and_block_mask_exact(blocks):
    idx, mask = _neighbor_case(0)
    m = 57
    ta = tops.adjacency_from_neighbors(torch.from_numpy(idx), torch.from_numpy(mask), m)
    ja = jops.adjacency_from_neighbors(jnp.asarray(idx), jnp.asarray(mask), m)
    assert ta.dtype == torch.float32 and np.array_equal(ta.numpy(), np.asarray(ja))
    assert np.all(ta.numpy()[:3] == 0)
    tm = tops.adjacency_block_mask(torch.from_numpy(idx), torch.from_numpy(mask), m,
                                   *blocks)
    jm = jops.adjacency_block_mask(jnp.asarray(idx), jnp.asarray(mask), m, *blocks)
    assert tm.dtype == torch.int32 and np.array_equal(tm.numpy(), np.asarray(jm))
    # the O(N·K) scatter equals the O(N·M) tile reduce over the adjacency
    assert torch.equal(tm, tops.block_mask_from_dense(ta, *blocks))


def test_adjacency_narrower_than_the_neighbor_list():
    """m < K: the padding slots' spare columns wrap around."""
    idx, mask = _neighbor_case(4, n=9, m=3, k=6)
    ta = tops.adjacency_from_neighbors(torch.from_numpy(idx), torch.from_numpy(mask), 3)
    ja = jops.adjacency_from_neighbors(jnp.asarray(idx), jnp.asarray(mask), 3)
    assert np.array_equal(ta.numpy(), np.asarray(ja))
    assert tops.adjacency_from_neighbors(torch.from_numpy(idx),
                                         torch.from_numpy(mask), 0).shape == (9, 0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_neighbor_spmm_matches_neighbor_mean(seed):
    idx, mask = _neighbor_case(seed)
    rng = np.random.default_rng(seed + 10)
    f = rng.standard_normal((57, 19)).astype(np.float32)
    ti, tm, tf = torch.from_numpy(idx), torch.from_numpy(mask), torch.from_numpy(f)
    before = tops.block_spmm.launches
    got = tops.neighbor_spmm(tf, ti, tm)
    assert tops.block_spmm.launches == before         # CPU: no kernel launch
    np.testing.assert_allclose(got.numpy(), tref.neighbor_mean_ref(tf, ti, tm).numpy(),
                               atol=1e-5, rtol=1e-5)
    want = jref.neighbor_mean_ref(jnp.asarray(f), jnp.asarray(idx), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tops.neighbor_mean(tf, ti, tm).numpy(),
                               np.asarray(jops.neighbor_mean(
                                   jnp.asarray(f), jnp.asarray(idx), jnp.asarray(mask),
                                   interpret=True)), atol=1e-5, rtol=1e-5)


def test_cpu_path_never_moves_the_launch_counter():
    rng = np.random.default_rng(3)
    a, x = torch.from_numpy(_sparse(rng, 50, 60)), torch.randn(60, 9)
    before = tops.block_spmm.launches
    tops.block_spmm(a, x)
    tops.block_spmm(a, x, tops.block_mask_from_dense(a, 128, 32))
    assert tops.block_spmm.launches == before


def test_non_cpu_tensors_never_take_the_plain_path():
    """Only a CPU tensor selects the plain version: any other device
    raises (here 'meta', since this machine has no card)."""
    a = torch.empty((4, 5), device="meta")
    x = torch.empty((5, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tops.block_spmm(a, x)
    with pytest.raises(ValueError, match="CUDA"):
        tops.block_spmm(torch.zeros(4, 5), x)


def test_kernel_tiles_and_splits():
    assert (tops.TILE_M, tops.TILE_K, tops.ROWS_PER_WARP, tops.SLAB) == (32, 32, 2, 512)
    assert tops.SPLITS == (1, 2, 4, 8)
    # the row groups alone give 64 warps for each of 132 SMs: no split
    assert tops.split_count(24647, 24647, 500, 132) == 1        # warm fill
    # a query bucket shares each row group's live tiles among 2..8 warps
    assert tops.split_count(4224, 24647, 500, 132) == 4         # 2,112 row warps
    assert tops.split_count(1056, 24647, 500, 132) == 8         # 528 row warps
    assert tops.split_count(264, 24647, 500, 132) == 8
    assert tops.split_count(8, 24647, 256, 132) == 8
    assert tops.split_count(128, 24647, 500, 132) == 8
    assert tops.split_count(300, 500, 64, 132) == 8             # 16 mask columns
    assert tops.split_count(8448, 24647, 500, 132) == 2
    # at most one split per mask column; wider outputs count their slabs
    assert tops.split_count(300, 64, 64, 132) == 2
    assert tops.split_count(4224, 24647, 1024, 132) == 2


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc means an error, not a fallback."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build.os.path, "isfile", lambda _: False)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["spmm"])
    assert build.library_path("spmm").name.startswith("libspmm-")
