"""Public wrapper for the WKV6 recurrence kernel.

``wkv6(r, k, v, w, u)`` returns ``(y, S)`` from a zero state, in the
(B, T, H, N) layout of ``models/rwkv.py``. On CUDA tensors it launches the
hand-written Hopper kernel (``csrc/wkv6.cu``, built by ``kernels/build.py``),
which replaces the TPU kernel ``src/repro/kernels/wkv6/wkv6.py::wkv6_pallas``;
on CPU tensors it runs the plain version (``ref.wkv6_ref``). There is no
other fallback: a CUDA tensor of the wrong type, shape or layout, or a
failed build or launch, raises.

The kernel reads the layout in place and walks the ragged T itself, so
nothing is transposed or padded (the TPU wrapper pads T with identity
steps and transposes to per-head rows).

``wkv6.launches`` counts kernel launches (a plain integer; the CPU path
never moves it), so a run can show that it went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.wkv6.ref import wkv6_ref

HEAD_SIZES = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from repro_torch.kernels import build

        lib = build.load("wkv6")
        fn = lib.wkv6_fwd
        # r, k, v, w, u, y, s; B, T, H, N, dtype; stream
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
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
    u = u.float().contiguous()
    y = torch.empty_like(r)
    s = torch.empty((B, H, N, N), dtype=torch.float32, device=dev)
    if B * H == 0:
        return y, s
    fn, err_str = _kernel()
    rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            y.data_ptr(), s.data_ptr(), B, T, H, N, _DTYPES[r.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wkv6_fwd launch failed: {err_str(rc).decode()} "
                           f"(cudaError {rc})")
    wkv6.launches += 1
    return y, s


wkv6.launches = 0
