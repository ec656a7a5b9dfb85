"""Public wrapper for the block-sparse SpMM kernel.

``block_spmm(a, x, mask)`` computes ``Y = A @ X``. On CUDA tensors it
launches the hand-written Hopper kernel (``csrc/spmm.cu``, built by
``kernels/build.py``), which replaces the TPU kernel
``src/repro/kernels/spmm/spmm.py::spmm_pallas``; on CPU tensors it runs the
plain version ``ref.spmm_nonzeros_ref``, which multiplies only the nonzeros
of A, as the kernel does. There is no other fallback: a CUDA tensor of the
wrong type, shape or layout, or a failed build or launch, raises.

``block_spmm`` is differentiable in ``x`` (a ``torch.autograd.Function``,
the reference's custom VJP, ``src/repro/kernels/spmm/ops.py:84-119``): the
backward is ``dx = Aᵀ @ dy`` through the same kernel, launched only when
``x`` needs a grad. The kernel reads A row by row, so Aᵀ is copied into a
contiguous (M, N) operand; at the square 32 x 32 tile its block mask is the
transpose of A's. A is an index-derived constant (the adjacency of a
neighbor list): it gets no grad.

The kernel reads each live tile of A once and multiplies only its
nonzeros: a warp owns two rows of Y for all of D, and ``splits`` warps may
share a row group's live tiles, their partial sums added in a fixed order
(``csrc/spmm.cu`` has the design). The block mask is at the kernel's own
tile shape, ``TILE_M`` x ``TILE_K`` = 32 x 32 of A. The TPU version's
``AUTOTUNE_TABLE`` was measured for the Pallas interpreter and does not
carry over. The kernel masks the ragged edges itself, so nothing is padded.

``neighbor_spmm`` expresses the padded neighbor-list mean aggregation as
an SpMM against the row-normalised adjacency of ``adjacency_from_neighbors``,
with the mask scattered straight from the neighbor list
(``adjacency_block_mask``).

``block_spmm.launches`` counts kernel launches (a plain integer; the CPU
path never moves it), so a run can show that it went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.spmm.ref import spmm_nonzeros_ref

TILE_M = 32     # rows of A per mask tile
TILE_K = 32     # columns of A per mask tile (equal to TILE_M: Aᵀ's mask is A's transposed)
ROWS_PER_WARP = 2   # rows of Y a warp owns (the kernel's kRows)
SLAB = 512          # columns of Y a block owns; wider outputs take more slabs
SPLITS = (1, 2, 4, 8)
# Warps of the grid the split aims at per SM: four waves of the 16 that
# are resident (two blocks of eight; the kernel's registers allow two).
# Against one wave, the query buckets ran faster with more splits, the warm
# fill (six waves unsplit) did not (measured on an H100, PERF.md).
WARPS_PER_SM = 64

_fn = None
_sm_count: dict[int, int] = {}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_count(n: int, m: int, d: int, n_sm: int) -> int:
    """How many warps share one row group's live tiles: 1 when the row
    groups alone give ``WARPS_PER_SM`` warps for every SM, else the least
    power of two that does (at most 8, and at most one per mask column)."""
    row_warps = _cdiv(n, ROWS_PER_WARP) * _cdiv(d, SLAB)
    nbm = _cdiv(m, TILE_K)
    s = 1
    while s < SPLITS[-1] and row_warps * s < WARPS_PER_SM * n_sm and 2 * s <= nbm:
        s *= 2
    return s


def _kernel():
    global _fn
    if _fn is None:
        from repro_torch.kernels import build

        lib = build.load("spmm")
        fn = lib.spmm_block_f32
        # a, x, mask, y; N, M, D, lda, ldx, ldy, bm, bk, splits; stream
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.spmm_error_string.argtypes = [ctypes.c_int]
        lib.spmm_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.spmm_error_string)
    return _fn


def block_mask_from_dense(a: torch.Tensor, bm: int, bk: int) -> torch.Tensor:
    """(ceil(N/bm), ceil(M/bk)) int32, 1 where the A tile has a nonzero —
    the O(N·M) reduce ``block_spmm`` pays when it is given no mask."""
    n, m = a.shape
    nz = torch.nn.functional.pad((a != 0).to(torch.uint8),
                                 (0, (-m) % bk, 0, (-n) % bm))
    tiles = nz.reshape(_cdiv(n, bm), bm, _cdiv(m, bk), bk)
    return tiles.amax(dim=(1, 3)).to(torch.int32)


def block_spmm(a: torch.Tensor, x: torch.Tensor,
               mask: torch.Tensor | None = None) -> torch.Tensor:
    """Y = A @ X, a (N, M) fp32, x (M, D) fp32 -> (N, D) fp32.

    ``mask`` is the (ceil(N/TILE_M), ceil(M/TILE_K)) int32 block-liveness
    grid; None derives it from A. On CUDA the output is allocated with
    ``torch.empty`` and the kernel runs on the current stream, without a
    synchronise. Differentiable in ``x`` (module docstring).

    Non-finite values: both versions skip the zeros of A, so 0·inf and
    0·NaN never happen, and a non-finite row k of X reaches exactly the
    rows of A with a nonzero in column k (as the gather and segment
    backends and ``ref.neighbor_mean_ref`` give). The reference's spmm
    backend multiplies whole live tiles, so there the row reaches every
    row of a live tile that covers column k: the port keeps the gather
    backends' rule instead.
    """
    return _BlockSpmm.apply(a, x, mask)


class _BlockSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, x, mask):
        ctx.save_for_backward(a, mask)
        return _product(a, x, mask)

    @staticmethod
    def backward(ctx, dy):
        if not ctx.needs_input_grad[1]:
            return None, None, None
        a, mask = ctx.saved_tensors
        mask_t = None if mask is None else mask.t().contiguous()
        return None, _product(a.t().contiguous(), dy.contiguous(), mask_t), None


def _product(a: torch.Tensor, x: torch.Tensor,
             mask: torch.Tensor | None) -> torch.Tensor:
    """The plain version on CPU tensors, else the checked kernel launch."""
    if a.device.type == "cpu" and x.device.type == "cpu":
        return spmm_nonzeros_ref(a, x)
    if a.device.type != "cuda" or x.device != a.device:
        raise ValueError(f"block_spmm: a on {a.device}, x on {x.device}; "
                         "both must be on one CUDA device (or both on the CPU)")
    if a.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"block_spmm kernel takes fp32, got {a.dtype}/{x.dtype}")
    if a.ndim != 2 or x.ndim != 2 or a.shape[1] != x.shape[0]:
        raise ValueError(f"block_spmm: bad shapes {tuple(a.shape)} @ "
                         f"{tuple(x.shape)}")
    if not (a.is_contiguous() and x.is_contiguous()):
        raise ValueError("block_spmm: a and x must be contiguous")
    n, m = a.shape
    d = x.shape[1]
    if mask is None:
        mask = block_mask_from_dense(a, TILE_M, TILE_K)
    want = (_cdiv(n, TILE_M), _cdiv(m, TILE_K))
    if (mask.device != a.device or mask.dtype != torch.int32
            or tuple(mask.shape) != want or not mask.is_contiguous()):
        raise ValueError(f"block_spmm: mask must be contiguous int32 {want} on "
                         f"{a.device}, got {mask.dtype} {tuple(mask.shape)} "
                         f"on {mask.device}")
    dev = a.device.index
    if dev not in _sm_count:
        _sm_count[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return launch(a, x, mask, split_count(n, m, d, _sm_count[dev]))


block_spmm.launches = 0


def launch(a: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
           splits: int) -> torch.Tensor:
    """Launch the kernel with an explicit split (``SPLITS``) on checked
    contiguous fp32 CUDA operands. ``block_spmm`` picks the split;
    ``chip_smoke.py`` calls this directly to time the splits it did not
    pick."""
    if splits not in SPLITS:
        raise ValueError(f"block_spmm: splits {splits} not in {SPLITS}")
    n, m = a.shape
    d = x.shape[1]
    y = torch.empty((n, d), dtype=torch.float32, device=a.device)
    if n == 0 or d == 0:
        return y
    fn, err_str = _kernel()
    rc = fn(a.data_ptr(), x.data_ptr(), mask.data_ptr(), y.data_ptr(), n, m, d, m, d, d,
            TILE_M, TILE_K, splits, torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"spmm_block_f32 launch failed: "
                           f"{err_str(rc).decode()} (cudaError {rc})")
    block_spmm.launches += 1
    return y


def adjacency_from_neighbors(nbr_idx: torch.Tensor, nbr_mask: torch.Tensor,
                             m: int) -> torch.Tensor:
    """Dense row-normalised adjacency (N, m) from a padded neighbor list.

    Duplicate (row, col) slots add up (``accumulate=True``), as the
    reference's ``.at[].add`` does. A padding slot adds 0.0; slot j of a
    row sends it to column j rather than to the column its index names, so
    no cell gets more than one padding write — the same sums, without the
    long runs of duplicates on which CUDA's sort-based deterministic
    accumulate serialises.
    """
    n, k = nbr_idx.shape
    dev = nbr_idx.device
    deg = torch.clamp(nbr_mask.sum(-1, keepdim=True), min=1.0)
    w = nbr_mask / deg                                               # (N, K)
    a = torch.zeros((n, m), dtype=torch.float32, device=dev)
    if n * k == 0 or m == 0:
        return a
    rows = torch.arange(n, device=dev)[:, None].expand(n, k)
    spare = torch.arange(k, device=dev)
    if k > m:
        spare = spare % m
    spare = spare[None, :].expand(n, k)
    cols = torch.where(nbr_mask > 0, nbr_idx.long(), spare)
    a.index_put_((rows.reshape(-1), cols.reshape(-1)),
                 w.reshape(-1).to(torch.float32), accumulate=True)
    return a


def adjacency_block_mask(nbr_idx: torch.Tensor, nbr_mask: torch.Tensor, m: int,
                         block_n: int, block_m: int) -> torch.Tensor:
    """Block-liveness grid of ``adjacency_from_neighbors``' (N, m) matrix,
    scattered straight from the neighbor list in O(N·K). Every live slot
    writes 1 into its tile and every padding slot into a spare column that
    is cut off, so all writes to a cell agree and their order does not
    matter (no accumulate, no sort)."""
    n, k = nbr_idx.shape
    dev = nbr_idx.device
    nb_m = _cdiv(m, block_m)
    grid = torch.zeros((_cdiv(n, block_n), nb_m + 1), dtype=torch.int32, device=dev)
    rows = torch.arange(n, device=dev)[:, None].expand(n, k) // block_n
    cols = torch.where(nbr_mask > 0, nbr_idx.long() // block_m, nb_m)
    grid.index_put_((rows.reshape(-1), cols.reshape(-1)),
                    torch.ones((), dtype=torch.int32, device=dev))
    return grid[:, :nb_m].contiguous()


def neighbor_spmm(table: torch.Tensor, nbr_idx: torch.Tensor,
                  nbr_mask: torch.Tensor, *,
                  adj: torch.Tensor | None = None) -> torch.Tensor:
    """Mean-aggregate ``table`` rows for a padded neighbor batch through
    the kernel, the block mask derived from the neighbor list. ``adj``
    optionally reuses a precomputed adjacency."""
    m = table.shape[0]
    if adj is None:
        adj = adjacency_from_neighbors(nbr_idx, nbr_mask, m)
    mask = adjacency_block_mask(nbr_idx, nbr_mask, m, TILE_M, TILE_K)
    return block_spmm(adj, table, mask).to(table.dtype)


def neighbor_mean(features: torch.Tensor, nbr_idx: torch.Tensor,
                  nbr_mask: torch.Tensor) -> torch.Tensor:
    """Mean-aggregate neighbor features via the SpMM kernel."""
    return neighbor_spmm(features, nbr_idx, nbr_mask)
