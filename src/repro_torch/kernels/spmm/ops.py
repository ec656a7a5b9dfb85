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

The sparse route (``sparse_spmm``, ``csrc/spmm_sparse.cu``) is the same
mean aggregation with no (N, M) operand: its forward reads the padded
neighbour list itself (an ELL operand, 8 bytes a slot), its transposed
launch a column-sorted copy of the live slots (``column_sorted``), built on
the device at fixed shape when a gradient is asked for. A run takes one
route for every aggregation, from the graph (``spmm_route``): the dense
operand where the eval's (n, n) fp32 matrix fits in
``DENSE_OPERAND_BYTES``, else the sparse one.

``block_spmm.launches`` counts kernel launches of both routes (a plain
integer; the CPU path never moves it), so a run can show that it went
through the kernels; ``block_spmm.sparse_launches`` counts the sparse
route's alone. A launch recorded into a CUDA graph under capture runs
nothing then: it adds to ``block_spmm.captured`` (and
``sparse_captured``) instead, and the graph's owner (``api.fused``) adds
the launches it captured to ``launches`` (and ``sparse_launches``) each
time it replays the graph.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.spmm.ref import ell_spmm_ref, ell_spmm_t_ref, spmm_nonzeros_ref

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
# The largest dense (n, n) fp32 eval operand a run builds: above it every
# aggregation of the run takes the sparse route (``spmm_route``). Pubmed's
# is 1.55 GB, Coauthor's 1.34 GB, Reddit's 217 GB.
DENSE_OPERAND_BYTES = 4 << 30

_fn = None
_sparse_fn = None
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
block_spmm.captured = 0
block_spmm.sparse_launches = 0
block_spmm.sparse_captured = 0


def _count(sparse: bool) -> None:
    """One launch on the current stream: captured or run."""
    if torch.cuda.is_current_stream_capturing():
        block_spmm.captured += 1
        block_spmm.sparse_captured += int(sparse)
    else:
        block_spmm.launches += 1
        block_spmm.sparse_launches += int(sparse)


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
    _count(False)
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


# -- the sparse route ---------------------------------------------------------

def spmm_route(n_nodes: int) -> str:
    """The route of every aggregation of a run on a graph of ``n_nodes``:
    ``"dense"`` (the block kernel on a row-normalised adjacency) where the
    eval's (n, n) fp32 operand fits in ``DENSE_OPERAND_BYTES``, else
    ``"sparse"``."""
    return "sparse" if 4 * n_nodes * n_nodes > DENSE_OPERAND_BYTES else "dense"


def _sparse_kernels():
    global _sparse_fn
    if _sparse_fn is None:
        from repro_torch.kernels import build

        lib = build.load("spmm_sparse")
        fwd = lib.spmm_ell_f32
        # x, idx, mask, y; N, M, K, D; stream
        fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fwd.restype = ctypes.c_int
        trn = lib.spmm_ell_t_f32
        # dy, rows, w, ptr, dx; M, N, D; stream
        trn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        trn.restype = ctypes.c_int
        lib.spmm_ell_error_string.argtypes = [ctypes.c_int]
        lib.spmm_ell_error_string.restype = ctypes.c_char_p
        _sparse_fn = (fwd, trn, lib.spmm_ell_error_string)
    return _sparse_fn


def column_sorted(nbr_idx: torch.Tensor, nbr_mask: torch.Tensor, m: int) -> dict:
    """The transposed launch's operand: the N·K slots of a neighbour list
    sorted stably by the column they name, dead slots (mask 0) last, so the
    live slots of column j are ``ptr[j] <= p < ptr[j + 1]`` in (row, slot)
    order. ``rows`` (N·K,) int32 is each entry's row, ``w`` (N·K,) fp32 its
    weight mask / max(deg, 1), ``ptr`` (m + 1,) int32 from a search of the
    sorted columns. Fixed shapes, built on the device with no read back
    (CUDA-graph capture takes it)."""
    n, k = nbr_idx.shape
    dev = nbr_idx.device
    live = nbr_mask != 0
    cols = torch.where(live, nbr_idx.long(), m).reshape(-1)
    sorted_cols, perm = torch.sort(cols, stable=True)
    deg = torch.clamp(nbr_mask.to(torch.float32).sum(-1, keepdim=True), min=1.0)
    w = (nbr_mask.to(torch.float32) / deg).reshape(-1)[perm]
    ptr = torch.searchsorted(sorted_cols, torch.arange(m + 1, device=dev))
    return {"rows": torch.div(perm, max(k, 1), rounding_mode="floor").to(torch.int32),
            "w": w, "ptr": ptr.to(torch.int32), "m": m}


def sparse_spmm(x: torch.Tensor, nbr_idx: torch.Tensor,
                nbr_mask: torch.Tensor) -> torch.Tensor:
    """The sparse route: Y (N, D) = the mean of the rows of ``x`` (M, D) that
    the live slots of ``nbr_idx`` / ``nbr_mask`` (N, K) name,
    (sum_s mask·x[idx]) / max(sum_s mask, 1), as ``neighbor_spmm`` gives it
    through a dense adjacency. On CUDA one launch of ``spmm_ell_kernel``;
    differentiable in ``x``, whose gradient is one launch of the transposed
    kernel over ``column_sorted``. On the CPU the plain versions
    (``ref.ell_spmm_ref``, ``ref.ell_spmm_t_ref``)."""
    return _SparseSpmm.apply(x, nbr_idx.to(torch.int32).contiguous(),
                             nbr_mask.to(torch.float32).contiguous())


class _SparseSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, nbr_idx, nbr_mask):
        ctx.save_for_backward(nbr_idx, nbr_mask)
        ctx.m = x.shape[0]
        if x.device.type == "cpu":
            return ell_spmm_ref(x, nbr_idx, nbr_mask)
        return sparse_forward(x, nbr_idx, nbr_mask)

    @staticmethod
    def backward(ctx, dy):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        nbr_idx, nbr_mask = ctx.saved_tensors
        op = column_sorted(nbr_idx, nbr_mask, ctx.m)
        dy = dy.contiguous()
        if dy.device.type == "cpu":
            return ell_spmm_t_ref(dy, op["rows"], op["w"], op["ptr"], op["m"]), None, None
        return sparse_transposed(dy, op), None, None


def _check_cuda(named: dict, dev) -> None:
    for name, (t, dtype) in named.items():
        if t.device != dev:
            raise ValueError(f"sparse_spmm: {name} on {t.device}, x on {dev}; all must "
                             "be on one CUDA device (or all on the CPU)")
        if t.dtype != dtype:
            raise TypeError(f"sparse_spmm kernel takes {name} as {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"sparse_spmm: {name} must be contiguous")


def sparse_forward(x: torch.Tensor, nbr_idx: torch.Tensor,
                   nbr_mask: torch.Tensor) -> torch.Tensor:
    """One checked launch of the sparse route's forward on CUDA tensors
    (``x`` fp32 (M, D), ``nbr_idx`` int32 and ``nbr_mask`` fp32 (N, K))."""
    _check_cuda({"x": (x, torch.float32), "nbr_idx": (nbr_idx, torch.int32),
                 "nbr_mask": (nbr_mask, torch.float32)}, x.device)
    if x.ndim != 2 or nbr_idx.ndim != 2 or tuple(nbr_mask.shape) != tuple(nbr_idx.shape):
        raise ValueError(f"sparse_spmm: bad shapes x {tuple(x.shape)}, nbr_idx "
                         f"{tuple(nbr_idx.shape)}, nbr_mask {tuple(nbr_mask.shape)}")
    (n, k), (m, d) = nbr_idx.shape, x.shape
    y = torch.empty((n, d), dtype=torch.float32, device=x.device)
    if n == 0 or d == 0:
        return y
    fwd, _, err_str = _sparse_kernels()
    rc = fwd(x.data_ptr(), nbr_idx.data_ptr(), nbr_mask.data_ptr(), y.data_ptr(), n, m, k, d,
             torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"spmm_ell_f32 launch failed: {err_str(rc).decode()} "
                           f"(cudaError {rc})")
    _count(True)
    return y


def sparse_transposed(dy: torch.Tensor, op: dict) -> torch.Tensor:
    """One checked launch of the sparse route's transposed kernel on CUDA
    tensors: dX (m, D) = Aᵀ @ ``dy`` over ``op = column_sorted(...)``."""
    _check_cuda({"dy": (dy, torch.float32), "rows": (op["rows"], torch.int32),
                 "w": (op["w"], torch.float32), "ptr": (op["ptr"], torch.int32)}, dy.device)
    m = op["m"]
    if dy.ndim != 2 or tuple(op["ptr"].shape) != (m + 1,):
        raise ValueError(f"sparse_spmm: bad shapes dy {tuple(dy.shape)}, ptr "
                         f"{tuple(op['ptr'].shape)} for {m} rows")
    n, d = dy.shape
    dx = torch.empty((m, d), dtype=torch.float32, device=dy.device)
    if m == 0 or d == 0:
        return dx
    _, trn, err_str = _sparse_kernels()
    rc = trn(dy.data_ptr(), op["rows"].data_ptr(), op["w"].data_ptr(), op["ptr"].data_ptr(),
             dx.data_ptr(), m, n, d, torch.cuda.current_stream(dy.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"spmm_ell_t_f32 launch failed: {err_str(rc).decode()} "
                           f"(cudaError {rc})")
    _count(True)
    return dx
