"""Public wrappers for the WKV6 recurrence kernels.

``wkv6(r, k, v, w, u)`` returns ``(y, S)`` from a zero state, in the
(B, T, H, N) layout of ``models/rwkv.py``. On CUDA tensors it launches the
hand-written Hopper kernel (``csrc/wkv6.cu``, built by ``kernels/build.py``),
which replaces the TPU kernel ``src/repro/kernels/wkv6/wkv6.py::wkv6_pallas``;
on CPU tensors it runs the plain version (``ref.wkv6_ref``). There is no
other fallback: a CUDA tensor of the wrong type, shape or layout, or a
failed build or launch, raises.

The kernel reads the layout in place through TMA tensor maps and walks the
ragged T itself, so nothing is transposed or padded (the TPU wrapper pads
T with identity steps and transposes to per-head rows). TMA needs 16-byte
aligned bases: a tensor that is not (an offset view) is copied to a fresh
one first, which no caller on the main path hands it.

The launch is fixed per head size by ``CONFIG``: value columns per thread
and blocks per (b, h) row. ``configs`` lists every launch the kernel takes
(the same rules as ``csrc/wkv6.cu::config_ok``), and ``launch`` runs one
of them, which ``chip_smoke.py`` uses to time the ones ``CONFIG`` did not
pick.

Training: when a gradient is wanted (grad mode on, any input requiring
one) ``wkv6`` goes through ``WKV6``, on any device. Its forward is the
same kernel writing also the state at the start of each
``STAGE_STEPS``-step stage (the same y and S, bit for bit); its backward
is ``wkv6_bwd``: on CUDA tensors one launch of the hand-written backward
kernel (``csrc/wkv6.cu::wkv6_bwd_kernel``, a thread-block cluster of
``N / bwd_rows(N)`` blocks per (b, h); it replaces the reference's jnp
autodiff of ``wkv_scan``), on CPU tensors the plain pair (``ref.wkv6_ref``
with its stage states, then ``ref.wkv6_bwd_ref``). A call with no gradient
wanted takes the serving path unchanged.

``wkv6.launches`` and ``wkv6_bwd.launches`` count the launches of the two
kernels; plain integers the CPU path never moves, so a run can show that it
went through the kernels.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.wkv6.ref import STAGE_STEPS, wkv6_bwd_ref, wkv6_ref

HEAD_SIZES = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's constants (csrc/wkv6.cu): key rows per thread, stages of
# the input ring (of STAGE_STEPS steps each, kTS), state threads per
# block, shared memory
ROWS_PER_THREAD = 8
STAGES = 2
MAX_THREADS = 256
MAX_SMEM = 232448
# head size -> (value columns per thread, blocks per (b, h) row): the
# fastest of ``configs`` at B=4, T=2,048 and d 2,048 on an H100
# (chip_smoke.py phase 7 times the others beside it; PERF.md)
CONFIG = {32: (1, 1), 64: (2, 1), 128: (2, 8)}

_fn = None


def bwd_rows(n: int) -> int:
    """The backward's key rows per block at head size ``n``
    (``csrc/wkv6.cu::rows_per_block``): a cluster of n / bwd_rows(n) blocks
    per (b, h) sums dv over its blocks' rows."""
    return 16 if n == 128 else 32


def smem_bytes(n: int, esz: int, splits: int) -> int:
    """Dynamic shared memory of a launch (``csrc/wkv6.cu::layout``): the
    mbarriers, the ring, for bf16 two buffers of the rows widened to fp32,
    two of coef and two of the partial sums."""
    cg = n // splits
    stage = STAGE_STEPS * (2 * n * esz + 4 * n + cg * esz)
    widened = STAGE_STEPS * (2 * n + cg) * 4 if esz == 2 else 0
    part = STAGE_STEPS * (n // ROWS_PER_THREAD) * cg * 4
    return 128 + STAGES * stage + 2 * widened + 2 * 128 + 2 * part


def threads(n: int, cols: int, splits: int) -> int:
    """State threads per block (the kernel adds 128 helper threads)."""
    return (n // ROWS_PER_THREAD) * (n // splits // cols)


@functools.lru_cache(maxsize=None)
def configs(n: int, dtype: torch.dtype) -> list[tuple[int, int]]:
    """Every (value columns per thread, blocks per row) the kernel takes at
    head size ``n`` for r/k/v of ``dtype``: whole 16-byte rows of v per
    block, a multiple of 32 state threads up to 256, the shared memory a
    block may have."""
    esz = dtype.itemsize
    out = []
    for cols in (1, 2, 4):
        for splits in range(1, n + 1):
            if n % splits or (n // splits) % cols or (n // splits * esz) % 16:
                continue
            nt = threads(n, cols, splits)
            if nt % 32 == 0 and nt <= MAX_THREADS and smem_bytes(n, esz, splits) <= MAX_SMEM:
                out.append((cols, splits))
    return out


def _kernel():
    global _fn
    if _fn is None:
        from repro_torch.kernels import build

        lib = build.load("wkv6")
        fn = lib.wkv6_fwd
        # r, k, v, w, u, y, s, states; B, T, H, N, dtype, cols, splits; stream
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        bwd = lib.wkv6_bwd
        # r, k, v, w, u, dy, ds, states, dr, dk, dv, dw, du, du_part,
        # tickets; B, T, H, N, dtype; stream
        bwd.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        bwd.restype = ctypes.c_int
        lib.wkv6_error_string.argtypes = [ctypes.c_int]
        lib.wkv6_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.wkv6_error_string, bwd)
    return _fn


def _check(r, k, v, w, u) -> None:
    """The kernel's operands: one CUDA device, fp32/bf16 r/k/v, fp32 w,
    one (B, T, H, N) shape, u (H, N), N in ``HEAD_SIZES``, contiguous."""
    tensors = (r, k, v, w, u)
    dev = r.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("wkv6: r, k, v, w, u must all be on one CUDA device "
                         f"(or all on the CPU), got {[str(t.device) for t in tensors]}")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"wkv6 kernel takes r/k/v in one of fp32/bf16, got "
                        f"{r.dtype}/{k.dtype}/{v.dtype}")
    if w.dtype != torch.float32:
        raise TypeError(f"wkv6 kernel takes w in fp32, got {w.dtype}")
    if r.ndim != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"wkv6: r, k, v, w must share one (B, T, H, N) shape, got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    B, T, H, N = r.shape
    if tuple(u.shape) != (H, N):
        raise ValueError(f"wkv6: u must be ({H}, {N}), got {tuple(u.shape)}")
    if N not in HEAD_SIZES:
        raise ValueError(f"wkv6 kernel takes head sizes {HEAD_SIZES}, got {N}")
    if not all(t.is_contiguous() for t in (r, k, v, w)):
        raise ValueError("wkv6: r, k, v, w must be contiguous")


def _all_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """r,k,v (B, T, H, N) fp32 or bf16, w (B, T, H, N) fp32, u (H, N).
    Returns (y (B, T, H, N) in r's dtype, S (B, H, N, N) fp32),
    differentiable in r, k, v, w and u (through ``WKV6`` when a gradient is
    wanted).

    On CUDA the outputs are allocated with ``torch.empty`` and the kernel
    runs on the current stream, without a synchronise.
    """
    tensors = (r, k, v, w, u)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return WKV6.apply(*tensors)
    if _all_cpu(*tensors):
        return wkv6_ref(r, k, v, w, u)
    _check(*tensors)
    B, T, H, N = r.shape
    return launch(r, k, v, w, u, *CONFIG[N])


wkv6.launches = 0


def launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
           u: torch.Tensor, cols: int, splits: int, stage_states: bool = False) -> tuple:
    """Launch the kernel with ``cols`` value columns per thread and
    ``splits`` blocks per (b, h) row on checked contiguous CUDA operands.
    ``wkv6`` picks them from ``CONFIG``; ``chip_smoke.py`` calls this
    directly to time the other ``configs``. With ``stage_states`` it also
    returns the state at the start of each stage, (B, H, ceil(T /
    STAGE_STEPS), N, N) fp32, which the kernel writes beside y and S."""
    B, T, H, N = r.shape
    if (cols, splits) not in configs(N, r.dtype):
        raise ValueError(f"wkv6 kernel takes (cols, splits) in {configs(N, r.dtype)} at "
                         f"N={N} {r.dtype}, got {(cols, splits)}")
    r, k, v, w = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (r, k, v, w))
    u = u.float().contiguous()
    y = torch.empty_like(r)
    s = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    states = (torch.empty((B, H, -(-T // STAGE_STEPS), N, N), dtype=torch.float32,
                          device=r.device) if stage_states else None)
    out = (y, s, states) if stage_states else (y, s)
    if B * H == 0:
        return out
    fn, err_str, *_ = _kernel()
    rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            y.data_ptr(), s.data_ptr(), None if states is None else states.data_ptr(),
            B, T, H, N, _DTYPES[r.dtype], cols, splits,
            torch.cuda.current_stream(r.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wkv6_fwd launch failed: {err_str(rc).decode()} "
                           f"(cudaError {rc})")
    wkv6.launches += 1
    return out


def wkv6_bwd(r, k, v, w, u, dy, ds, states) -> tuple:
    """(dr, dk, dv in r's dtype, dw fp32, du in u's dtype): the gradient of
    ``wkv6`` from dy (B, T, H, N), ds (B, H, N, N) fp32 or None (the
    gradient of the returned S) and ``states``, the forward's stage states.
    One launch of the backward kernel on CUDA operands (its scratch: du's
    share per b, (B, H, N) fp32, and the (H, N / bwd_rows(N)) int32 tickets
    that pick the block summing them), ``ref.wkv6_bwd_ref`` on CPU ones."""
    if _all_cpu(r, k, v, w, u, dy):
        return wkv6_bwd_ref(r, k, v, w, u, dy, ds, states=states)
    _check(r, k, v, w, u)
    B, T, H, N = r.shape
    dy = dy.contiguous()
    if dy.shape != r.shape or dy.dtype != r.dtype or dy.device != r.device:
        raise ValueError(f"wkv6 backward: dy must be {tuple(r.shape)} {r.dtype} on "
                         f"{r.device}, got {tuple(dy.shape)} {dy.dtype} on {dy.device}")
    n_stages = -(-T // STAGE_STEPS)
    if (tuple(states.shape) != (B, H, n_stages, N, N) or states.dtype != torch.float32
            or states.device != r.device or not states.is_contiguous()):
        raise ValueError(f"wkv6 backward: states must be contiguous fp32 "
                         f"{(B, H, n_stages, N, N)}, got {tuple(states.shape)} {states.dtype}")
    if ds is not None:
        ds = ds.float().contiguous()
        if tuple(ds.shape) != (B, H, N, N) or ds.device != r.device:
            raise ValueError(f"wkv6 backward: ds must be {(B, H, N, N)} on {r.device}, got "
                             f"{tuple(ds.shape)} on {ds.device}")
    if B * T * H == 0:
        return (torch.zeros_like(r), torch.zeros_like(k), torch.zeros_like(v),
                torch.zeros_like(w), torch.zeros_like(u))
    # TMA reads r, k, v, w, dy from 16-byte aligned bases
    r, k, v, w, dy, states = (t if t.data_ptr() % 16 == 0 else t.clone()
                              for t in (r, k, v, w, dy, states))
    if ds is not None and ds.data_ptr() % 16:
        ds = ds.clone()
    uf = u.float().contiguous()
    dr, dk, dv = torch.empty_like(r), torch.empty_like(k), torch.empty_like(v)
    dw = torch.empty_like(w)
    du = torch.empty((H, N), dtype=torch.float32, device=r.device)
    du_part = torch.empty((B, H, N), dtype=torch.float32, device=r.device)
    tickets = torch.empty((H, N // bwd_rows(N)), dtype=torch.int32, device=r.device)
    _, err_str, fn = _kernel()
    rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), uf.data_ptr(),
            dy.data_ptr(), None if ds is None else ds.data_ptr(), states.data_ptr(),
            dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
            du_part.data_ptr(), tickets.data_ptr(), B, T, H, N, _DTYPES[r.dtype],
            torch.cuda.current_stream(r.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wkv6_bwd launch failed: {err_str(rc).decode()} (cudaError {rc})")
    wkv6_bwd.launches += 1
    return dr, dk, dv, dw, du.to(u.dtype)


wkv6_bwd.launches = 0


class WKV6(torch.autograd.Function):
    """WKV6 with the kernels' backward: the forward saves (r, k, v, w, u)
    and the state at the start of each stage; the backward recomputes the
    states inside a stage from them. An unused S gives no gradient (None),
    so nothing of (B, H, N, N) zeros is made for it."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.set_materialize_grads(False)
        if _all_cpu(r, k, v, w, u):
            y, s, states = wkv6_ref(r, k, v, w, u, stage_states=True)
        else:
            _check(r, k, v, w, u)
            y, s, states = launch(r, k, v, w, u, *CONFIG[r.shape[-1]], stage_states=True)
        ctx.save_for_backward(r, k, v, w, u, states)
        return y, s

    @staticmethod
    def backward(ctx, dy, ds):
        r, k, v, w, u, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(r)
        grads = wkv6_bwd(r, k, v, w, u, dy, ds, states)
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))
