"""Public wrapper for the flash attention kernels.

``flash_attention(q, k, v, causal, window)`` in the (B, S, H, hd) layout of
``models/attention.py``, with the query and key lengths apart: q (B, Sq, H,
hd) against k, v (B, Sk, Hkv, hd), so one kernel serves self attention
(Sq = Sk) and cross attention onto an encoder's output (Sq != Sk). On CUDA tensors it launches a hand-written Hopper
kernel from ``csrc/flash_attention.cu`` (built by ``kernels/build.py``),
which replaces the TPU kernel
``src/repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas``.
The input type picks the kernel: bf16 runs ``flash_fwd_tc_kernel`` (both
products on the tensor cores with ``wgmma``, K/V fed by TMA, P as two bf16
terms so the output stays within one bf16 ulp of fp32 probabilities), or,
for a layout TMA cannot take (hd not a multiple of 8, a base not 16-byte
aligned), ``flash_fwd_kernel``'s bf16 instance; fp32 runs
``flash_fwd_kernel`` (fp32 FMA, which holds the reference's 2e-5). On
CPU tensors it runs the plain version (``ref.attention_ref``). There is no
other fallback: a CUDA tensor of the wrong type, shape or layout, or a
failed build or launch, raises.

GQA maps query head h to KV head ``h // (H // Hkv)`` inside the kernels,
where the ragged Sq, Sk and hd edges arrive zero-filled: nothing is
repeated, transposed or padded in device memory. Keys at or past Sk are
masked. ``causal`` keeps key j for query i when j <= i, both counted from
0 (the Pallas kernel's rule); the window applies only when ``causal``. A
query row with no live key comes out 0.

``flash_attention.launches`` counts kernel launches (a plain integer; the
CPU path never moves it), so a run can show that it went through a
kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.flash_attention.ref import attention_ref

MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from repro_torch.kernels import build

        lib = build.load("flash_attention")
        fn = lib.flash_attention_fwd
        # q, k, v, o; B, Sq, Sk, H, Hkv, hd, causal, window; scale; dtype; stream
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_float]
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.flash_attention_error_string)
    return _fn


def _check_shapes(q, k, v) -> tuple:
    """(B, Sq, Sk, H, Hkv, hd) of shapes the kernels take, else ValueError."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or Hkv < 1 or H % Hkv or Sq < 1 or Sk < 1:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (same B and hd, Sq and Sk at least 1, H a "
                         "multiple of Hkv)")
    return B, Sq, Sk, H, Hkv, hd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None) -> torch.Tensor:
    """q (B, Sq, H, hd); k, v (B, Sk, Hkv, hd), Sq >= 1 and Sk >= 1, one
    dtype (fp32 or bf16 on CUDA). Returns (B, Sq, H, hd) in q's dtype.

    On CUDA the output is allocated with ``torch.empty`` and the kernel
    runs on the current stream, without a synchronise.
    """
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"flash_attention: q on {q.device}, k on {k.device}, v on "
                         f"{v.device}; all must be on one CUDA device (or the CPU)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes one of fp32/bf16 for q, k, v, "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
    B, Sq, Sk, H, Hkv, hd = _check_shapes(q, k, v)
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes head_dim 1..{MAX_HEAD_DIM}, "
                         f"got {hd}")
    if B * H > 65535:
        raise ValueError(f"flash_attention kernel takes B*H <= 65535, got {B * H}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    o = torch.empty_like(q)
    if B == 0:
        return o
    fn, err_str = _kernel()
    win = window if (causal and window is not None) else 0
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq, Sk, H, Hkv, hd,
            int(causal), win, hd ** -0.5, _DTYPES[q.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: {err_str(rc).decode()} "
                           f"(cudaError {rc})")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
