"""Public wrapper for the WKV6 recurrence kernel.

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

The kernel has no backward yet (ROADMAP A8.2b brings it). On CUDA
tensors a call that needs a gradient (grad mode on, any input requiring
one) raises ``NotImplementedError``: an output filled through ctypes has
no ``grad_fn``, and returning it would drop the gradient of every weight
before it. The serving path (no gradient) is unchanged; on CPU tensors the
plain version is differentiable.

``wkv6.launches`` counts kernel launches (a plain integer; the CPU path
never moves it), so a run can show that it went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.wkv6.ref import wkv6_ref

HEAD_SIZES = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's constants (csrc/wkv6.cu): key rows per thread, steps per
# stage of the input ring, stages, state threads per block, shared memory
ROWS_PER_THREAD = 8
STAGE_STEPS = 32
STAGES = 2
MAX_THREADS = 256
MAX_SMEM = 232448
# head size -> (value columns per thread, blocks per (b, h) row): the
# fastest of ``configs`` at B=4, T=2,048 and d 2,048 on an H100
# (chip_smoke.py phase 7 times the others beside it; PERF.md)
CONFIG = {32: (1, 1), 64: (2, 1), 128: (2, 8)}

_fn = None


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
        # r, k, v, w, u, y, s; B, T, H, N, dtype, cols, splits; stream
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.wkv6_error_string.argtypes = [ctypes.c_int]
        lib.wkv6_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.wkv6_error_string)
    return _fn


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """r,k,v (B, T, H, N) fp32 or bf16, w (B, T, H, N) fp32, u (H, N).
    Returns (y (B, T, H, N) in r's dtype, S (B, H, N, N) fp32).

    On CUDA the outputs are allocated with ``torch.empty`` and the kernel
    runs on the current stream, without a synchronise.
    """
    tensors = (r, k, v, w, u)
    if all(t.device.type == "cpu" for t in tensors):
        return wkv6_ref(r, k, v, w, u)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "wkv6: the CUDA kernel has no backward yet (ROADMAP A8.2b, the WKV6 backward "
            "kernel); call it without gradients (torch.no_grad) or train RWKV on the CPU")
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
    return launch(r, k, v, w, u, *CONFIG[N])


wkv6.launches = 0


def launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
           u: torch.Tensor, cols: int, splits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel with ``cols`` value columns per thread and
    ``splits`` blocks per (b, h) row on checked contiguous CUDA operands.
    ``wkv6`` picks them from ``CONFIG``; ``chip_smoke.py`` calls this
    directly to time the other ``configs``."""
    B, T, H, N = r.shape
    if (cols, splits) not in configs(N, r.dtype):
        raise ValueError(f"wkv6 kernel takes (cols, splits) in {configs(N, r.dtype)} at "
                         f"N={N} {r.dtype}, got {(cols, splits)}")
    r, k, v, w = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (r, k, v, w))
    u = u.float().contiguous()
    y = torch.empty_like(r)
    s = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    if B * H == 0:
        return y, s
    fn, err_str = _kernel()
    rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            y.data_ptr(), s.data_ptr(), B, T, H, N, _DTYPES[r.dtype], cols, splits,
            torch.cuda.current_stream(r.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wkv6_fwd launch failed: {err_str(rc).decode()} "
                           f"(cudaError {rc})")
    wkv6.launches += 1
    return y, s
