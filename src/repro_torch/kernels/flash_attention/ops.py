"""Public wrapper for the flash attention kernels, forward and backward.

``flash_attention(q, k, v, causal, window)`` in the (B, S, H, hd) layout of
``models/attention.py``, with the query and key lengths apart: q (B, Sq, H,
hd) against k, v (B, Sk, Hkv, hd), so one kernel serves self attention
(Sq = Sk) and cross attention onto an encoder's output (Sq != Sk). On CUDA tensors it launches a hand-written Hopper
kernel from ``csrc/flash_attention.cu`` (built by ``kernels/build.py``),
which replaces the TPU kernel
``src/repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas``.
The library's routing rule (``flash_attention_fwd_route``) picks the kernel
by type and layout: fp32 at any hd up to 256 in a layout TMA can take (hd
a multiple of 4; q, k, v, o 16-byte aligned) runs
``x3::flash_fwd_x3_kernel`` (both products on the tensor cores as three
TF32 products, big.big + big.small + small.big with x = big + small, which
holds the reference's 2e-5 where one TF32 product would not; route
``"tf32x3"``); bf16 in a layout TMA can take (hd a multiple of 8, q, k, v
16-byte aligned) runs ``flash_fwd_tc_kernel`` (both products on the tensor
cores with ``wgmma``, K/V fed by TMA, P as two bf16 terms so the output
stays within one bf16 ulp of fp32 probabilities; ``"tensor_core"``); the
other layouts run ``flash_fwd_kernel`` (fp32 FMA, either type; ``"fma"``).
This is a rule by layout, not a fallback: on CPU tensors it runs the plain
version (``ref.attention_ref``), and a CUDA tensor of the wrong type, shape
or layout, or a failed build or launch, raises.

Gradients: when grad mode is on and any of q, k, v requires a gradient,
``flash_attention`` goes through ``FlashAttention`` (a
``torch.autograd.Function``). On CUDA its forward launches the forward
kernel with the rows' log-sum-exp as a second output and saves (q, k, v,
o, lse); its backward launches the dq kernel (dq, and delta = Σ dO·O per
row into a scratch) and then the dk/dv kernel (dk, dv), the card's form of
the reference's ``_flash_bwd`` (there is no Pallas backward). The library's
routing rule picks each pair: bf16 at any hd up to 256 in a layout TMA can
take runs ``tc::flash_bwd_dq_tc_kernel`` and ``tc::flash_bwd_dkdv_tc_kernel``
(every product on the tensor cores with ``wgmma``, operands fed by TMA, p
and dS as three bf16 terms each, all 24 bits of the fp32 values, so the
gradients stay within one bf16 ulp of fp32 ones; above hd 128 a dq block's
two consumers share its rows and split dq's columns); fp32 at any hd up to
256 in such a layout (hd a multiple of 4, 16-byte aligned bases) runs
``x3::flash_bwd_dq_x3_kernel`` and ``x3::flash_bwd_dkdv_x3_kernel`` (every
product on the tensor cores as three TF32 products, big.big + big.small +
small.big with x = big + small, which holds the reference's 1e-4 where one
TF32 product would not); the layouts TMA cannot take run
``flash_bwd_dq_kernel`` and ``flash_bwd_dkdv_kernel`` (fp32 FMA).
On CPU tensors it runs the plain versions (``ref.attention_ref`` with
``return_lse``, ``ref.attention_bwd_dq_ref`` and
``ref.attention_bwd_dkdv_ref``). The dk/dv launch is skipped when neither k
nor v wants a gradient. Otherwise (serving, no gradient) it makes the
forward launch without ``lse``, as before.

GQA maps query head h to KV head ``h // (H // Hkv)`` inside the kernels,
where the ragged Sq, Sk and hd edges arrive zero-filled: nothing is
repeated, transposed or padded in device memory. Keys at or past Sk are
masked. ``causal`` keeps key j for query i when j <= i, both counted from
0 (the Pallas kernel's rule); the window applies only when ``causal``. A
query row with no live key comes out 0, its lse +inf, its dq 0, and it
adds nothing to dk or dv.

``flash_attention.launches`` counts forward launches, ``flash_bwd_dq.launches``
and ``flash_bwd_dkdv.launches`` the backward kernels', and
``flash_attention.routes``, ``flash_bwd_dq.routes`` and
``flash_bwd_dkdv.routes`` split those by route (``{"fma": l,
"tensor_core": m, "tf32x3": n}``, from the library's rules,
``flash_attention_fwd_route`` and ``flash_attention_bwd_route``;
``FWD_ROUTES`` and ``BWD_ROUTES`` name their codes). They are plain
integers; the CPU path never moves them, so a run can show that it went
through the kernels and which.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.flash_attention.ref import (attention_bwd_dkdv_ref,
                                                     attention_bwd_dq_ref, attention_ref)

MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_fns = None


def _kernel():
    """{entry point name: ctypes function}, and the error-string one."""
    global _fns
    if _fns is None:
        from repro_torch.kernels import build

        lib = build.load("flash_attention")
        shape = [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        # pointers, then B, Sq, Sk, H, Hkv, hd, causal, window; scale; dtype; stream
        pointers = {"flash_attention_fwd": 5, "flash_attention_bwd_dq": 8,
                    "flash_attention_bwd_dkdv": 8}
        fns = {}
        for name, n in pointers.items():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * n + shape
            fn.restype = ctypes.c_int
            fns[name] = fn
        lib.flash_attention_fwd_route.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
        lib.flash_attention_fwd_route.restype = ctypes.c_int
        fns["fwd_route"] = lib.flash_attention_fwd_route
        lib.flash_attention_bwd_route.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
        lib.flash_attention_bwd_route.restype = ctypes.c_int
        fns["bwd_route"] = lib.flash_attention_bwd_route
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        fns["error_string"] = lib.flash_attention_error_string
        _fns = fns
    return _fns


def _call(name: str, pointers: list, dims: tuple, causal: bool, window, hd: int, dtype,
          dev) -> None:
    """Launch one entry point on the current stream; raise on its error."""
    fns = _kernel()
    win = window if (causal and window is not None) else 0
    rc = fns[name](*pointers, *dims, int(causal), win, hd ** -0.5, _DTYPES[dtype],
                   torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {fns['error_string'](rc).decode()} "
                           f"(cudaError {rc})")


# the library's forward and backward routes, by the code
# flash_attention_fwd_route and flash_attention_bwd_route return
FWD_ROUTES = BWD_ROUTES = ("fma", "tensor_core", "tf32x3")


def _fwd_route(q, k, v, o) -> str:
    """Which forward kernel the entry point launches for these CUDA
    operands, as the library's own routing rule (``flash_attention_fwd_route``)
    says: ``"tf32x3"`` (fp32 on the tensor cores), ``"tensor_core"`` (bf16)
    or ``"fma"``."""
    code = _kernel()["fwd_route"](q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                  q.shape[-1], _DTYPES[q.dtype])
    return FWD_ROUTES[code]


def _bwd_route(q, k, v, o, do) -> str:
    """Which backward kernel the entry point launches for these CUDA
    operands (``o`` None for the dk/dv kernel), as the library's own
    routing rule (``flash_attention_bwd_route``) says: ``"tensor_core"``
    (bf16), ``"tf32x3"`` (fp32 on the tensor cores) or ``"fma"``."""
    code = _kernel()["bwd_route"](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  None if o is None else o.data_ptr(), do.data_ptr(),
                                  q.shape[-1], _DTYPES[q.dtype])
    return BWD_ROUTES[code]


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


def _check_cuda(q, k, v, window) -> tuple:
    """(B, Sq, Sk, H, Hkv, hd) of CUDA operands the kernels take, else raise."""
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"flash_attention: q on {q.device}, k on {k.device}, v on "
                         f"{v.device}; all must be on one CUDA device (or the CPU)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes one of fp32/bf16 for q, k, v, "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
    dims = _check_shapes(q, k, v)
    B, Sq, Sk, H, Hkv, hd = dims
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes head_dim 1..{MAX_HEAD_DIM}, "
                         f"got {hd}")
    if B * H > 65535:
        raise ValueError(f"flash_attention kernel takes B*H <= 65535, got {B * H}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    return dims


def _all_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _forward(q, k, v, causal, window, with_lse: bool):
    """The forward launch on checked CUDA operands: (o, lse or None)."""
    B, Sq, Sk, H, Hkv, hd = dims = _check_cuda(q, k, v, window)
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if B == 0:
        return o, lse
    route = _fwd_route(q, k, v, o)
    _call("flash_attention_fwd",
          [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
           lse.data_ptr() if with_lse else None], dims, causal, window, hd, q.dtype, q.device)
    flash_attention.launches += 1
    flash_attention.routes[route] += 1
    return o, lse


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None) -> tuple:
    """The forward with each query row's log-sum-exp: (o (B, Sq, H, hd),
    lse (B, H, Sq) fp32, +inf for a row with no live key). No gradient."""
    if _all_cpu(q, k, v):
        return attention_ref(q, k, v, causal=causal, window=window, return_lse=True)
    return _forward(q, k, v, causal, window, True)


def flash_bwd_dq(q, k, v, o, lse, do, *, causal: bool = True,
                 window: int | None = None) -> tuple:
    """The backward's first kernel: (dq in q's dtype, delta (B, H, Sq) fp32
    = Σ dO·O per row, for ``flash_bwd_dkdv``). On CPU operands the plain
    version (``ref.attention_bwd_dq_ref``)."""
    if _all_cpu(q, k, v, o, lse, do):
        return attention_bwd_dq_ref(q, k, v, o, lse, do, causal=causal, window=window)
    B, Sq, Sk, H, Hkv, hd = dims = _check_cuda(q, k, v, window)
    _check_grad_operands(q, o, lse, do, B, H, Sq)
    dq = torch.empty_like(q)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if B == 0:
        return dq, delta
    route = _bwd_route(q, k, v, o, do)
    _call("flash_attention_bwd_dq",
          [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
           do.data_ptr(), dq.data_ptr(), delta.data_ptr()], dims, causal, window, hd,
          q.dtype, q.device)
    flash_bwd_dq.launches += 1
    flash_bwd_dq.routes[route] += 1
    return dq, delta


def flash_bwd_dkdv(q, k, v, lse, delta, do, *, causal: bool = True,
                   window: int | None = None) -> tuple:
    """The backward's second kernel, after ``flash_bwd_dq`` gave ``delta``:
    (dk, dv) in k's dtype. On CPU operands the plain version
    (``ref.attention_bwd_dkdv_ref``)."""
    if _all_cpu(q, k, v, lse, delta, do):
        return attention_bwd_dkdv_ref(q, k, v, lse, delta, do, causal=causal, window=window)
    B, Sq, Sk, H, Hkv, hd = dims = _check_cuda(q, k, v, window)
    _check_grad_operands(q, None, lse, do, B, H, Sq)
    if delta.shape != lse.shape or delta.dtype != torch.float32 or not delta.is_contiguous():
        raise ValueError(f"flash_bwd_dkdv: delta must be contiguous fp32 {tuple(lse.shape)}")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if B == 0:
        return dk, dv
    route = _bwd_route(q, k, v, None, do)
    _call("flash_attention_bwd_dkdv",
          [q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(), delta.data_ptr(),
           do.data_ptr(), dk.data_ptr(), dv.data_ptr()], dims, causal, window, hd, q.dtype,
          q.device)
    flash_bwd_dkdv.launches += 1
    flash_bwd_dkdv.routes[route] += 1
    return dk, dv


def _check_grad_operands(q, o, lse, do, B, H, Sq) -> None:
    for name, t in (("o", o), ("do", do)):
        if t is None:
            continue
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"flash attention backward: {name} must be contiguous "
                             f"{tuple(q.shape)} {q.dtype} on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if (tuple(lse.shape) != (B, H, Sq) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"flash attention backward: lse must be contiguous fp32 "
                         f"{(B, H, Sq)} on {q.device}, got {tuple(lse.shape)} {lse.dtype}")


def flash_bwd(q, k, v, o, lse, do, *, causal: bool = True,
              window: int | None = None) -> tuple:
    """(dq, dk, dv): the two backward kernels on CUDA operands, their
    plain versions on CPU ones."""
    dq, delta = flash_bwd_dq(q, k, v, o, lse, do, causal=causal, window=window)
    dk, dv = flash_bwd_dkdv(q, k, v, lse, delta, do, causal=causal, window=window)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention with the kernels' backward: forward saves (q, k, v, o,
    lse); backward recomputes the probabilities tile by tile."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = flash_attention_lse(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        kw = {"causal": ctx.causal, "window": ctx.window}
        need_q, need_k, need_v = ctx.needs_input_grad[:3]
        # the dq kernel also writes delta, which the dk/dv kernel reads
        dq, delta = flash_bwd_dq(q, k, v, o, lse, do, **kw)
        dk = dv = None
        if need_k or need_v:
            dk, dv = flash_bwd_dkdv(q, k, v, lse, delta, do, **kw)
        return (dq if need_q else None, dk if need_k else None,
                dv if need_v else None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None) -> torch.Tensor:
    """q (B, Sq, H, hd); k, v (B, Sk, Hkv, hd), Sq >= 1 and Sk >= 1, one
    dtype (fp32 or bf16 on CUDA). Returns (B, Sq, H, hd) in q's dtype,
    differentiable in q, k and v (through ``FlashAttention`` when a
    gradient is wanted).

    On CUDA the output is allocated with ``torch.empty`` and the kernel
    runs on the current stream, without a synchronise.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window)
    if _all_cpu(q, k, v):
        return attention_ref(q, k, v, causal=causal, window=window)
    return _forward(q, k, v, causal, window, False)[0]


flash_attention.launches = 0
flash_attention.routes = dict.fromkeys(FWD_ROUTES, 0)
flash_bwd_dq.launches = 0
flash_bwd_dkdv.launches = 0
flash_bwd_dq.routes = dict.fromkeys(BWD_ROUTES, 0)
flash_bwd_dkdv.routes = dict.fromkeys(BWD_ROUTES, 0)
