"""The stamp kernel (``csrc/stamp.cu``): the device's global timer written
into one slot of an int64 CUDA buffer when the current stream reaches the
launch. ``repro_torch.utils.spans`` marks device phases with it; inside a
CUDA graph capture a launch is a kernel node that every replay runs.
"""
from __future__ import annotations

import ctypes

import torch

_fn = None
# stamp kernels launched: eagerly, or recorded into a graph under a capture
# (a replay runs those again without a launch)
launches = 0


def _kernel():
    global _fn
    if _fn is None:
        from repro_torch.kernels import build

        lib = build.load("stamp")
        fn = lib.stamp_globaltimer
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.stamp_error_string.argtypes = [ctypes.c_int]
        lib.stamp_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.stamp_error_string)
    return _fn


def stamp(buf: torch.Tensor, slot: int) -> None:
    """Write the global timer (ns) into ``buf[slot]`` on the current stream."""
    if not buf.is_cuda or buf.dtype != torch.int64 or not buf.is_contiguous():
        raise ValueError(f"stamp: buf must be a contiguous int64 CUDA tensor, got "
                         f"{buf.dtype} on {buf.device}")
    if not 0 <= slot < buf.numel():
        raise IndexError(f"stamp: slot {slot} outside a buffer of {buf.numel()}")
    global launches
    fn, err_str = _kernel()
    launches += 1
    rc = fn(buf.data_ptr() + 8 * slot, torch.cuda.current_stream(buf.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stamp_globaltimer launch failed: {err_str(rc).decode()} "
                           f"(cudaError {rc})")
