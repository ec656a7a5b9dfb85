"""Plain PyTorch versions of the flash attention kernels' functions (GQA,
causal / sliding-window / unmasked, the query and key lengths apart), in
fp32: the forward (``attention_ref``, which can also return each query
row's log-sum-exp) and the backward (``attention_bwd_ref``, the formulas of
the reference's ``_flash_bwd``, ``src/repro/models/attention.py:212-264``,
applied densely).

The CPU tests run them, the autograd function of ``ops`` runs them on CPU
tensors, and ``chip_smoke.py`` holds the CUDA kernels against them on the
card. On CUDA tensors nothing on the main path calls them.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _live(Sq, Sk, causal, window, device):
    """(Sq, Sk) bool of the (query, key) pairs the mask keeps, or None
    when it keeps all."""
    if not causal:
        return None
    diff = (torch.arange(Sq, device=device)[:, None]
            - torch.arange(Sk, device=device)[None, :])
    ok = diff >= 0
    if window is not None:
        ok &= diff < window
    return ok


def _scores(q, k, H):
    """(B, H, Sq, Sk) fp32 scaled scores, K repeated to H heads."""
    if k.shape[2] != H:
        k = k.repeat_interleave(H // k.shape[2], dim=2)
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * q.shape[-1] ** -0.5


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  return_lse: bool = False):
    """q (B, Sq, H, hd); k, v (B, Sk, Hkv, hd). ``causal`` keeps key j for
    query i when j <= i, both counted from 0; the window applies only when
    causal; a query row with no live key comes out 0, as in the kernels.
    Scores, softmax and the product with V in fp32; the output in q's
    dtype. With ``return_lse`` also each query row's log-sum-exp of its
    scaled live scores, (B, H, Sq) fp32, +inf for a row with no live key
    (as the kernels write it)."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if Hkv != H:
        v = v.repeat_interleave(H // Hkv, dim=2)
    s = _scores(q, k, H)
    ok = _live(Sq, Sk, causal, window, q.device)
    if ok is not None:
        s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if causal and window is not None and Sq > Sk:
        # a row whose window lies wholly past Sk has no live key
        p = p * ok.any(-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.logsumexp(s, dim=-1)
    if ok is not None:
        lse = torch.where(ok.any(-1), lse, torch.inf)
    return o, lse


def _bwd_ds(q, k, v, lse, delta, do, causal, window):
    """(p, ds) (B, H, Sq, Sk) fp32 of the backward: p = exp(s − lse) on live
    pairs, 0 elsewhere; ds = p·(dp − delta)·scale with dp = dO·vᵀ."""
    H, hd = q.shape[2], q.shape[3]
    vf = v.float()
    if v.shape[2] != H:
        vf = vf.repeat_interleave(H // v.shape[2], dim=2)
    p = torch.exp(_scores(q, k, H) - lse[..., None])
    ok = _live(q.shape[1], k.shape[1], causal, window, q.device)
    if ok is not None:
        p = torch.where(ok, p, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vf)
    return p, p * (dp - delta[..., None]) * hd ** -0.5


def attention_bwd_dq_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                         lse: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
                         window: int | None = None) -> tuple:
    """The plain version of the backward's first kernel: (dq in q's dtype,
    delta (B, H, Sq) fp32 = Σ dO·O per row), dq = ds·k."""
    H = q.shape[2]
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    _, ds = _bwd_ds(q, k, v, lse, delta, do, causal, window)
    kf = k.float()
    if k.shape[2] != H:
        kf = kf.repeat_interleave(H // k.shape[2], dim=2)
    return torch.einsum("bhqk,bkhd->bqhd", ds, kf).to(q.dtype), delta


def attention_bwd_dkdv_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lse: torch.Tensor, delta: torch.Tensor, do: torch.Tensor, *,
                           causal: bool = True, window: int | None = None) -> tuple:
    """The plain version of the backward's second kernel, from the first's
    ``delta``: (dk, dv) in k's dtype, dk = dsᵀ·q and dv = pᵀ·dO, each summed
    over its KV head's query heads."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    p, ds = _bwd_ds(q, k, v, lse, delta, do, causal, window)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    if Hkv != H:
        dk = dk.reshape(B, Sk, Hkv, H // Hkv, hd).sum(3)
        dv = dv.reshape(B, Sk, Hkv, H // Hkv, hd).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                      lse: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
                      window: int | None = None) -> tuple:
    """(dq, dk, dv) of attention at (q, k, v), from the forward's output
    ``o`` and ``lse`` (B, H, Sq) and the output's gradient ``do``: delta =
    Σ dO·O per row; p = exp(s − lse) on live pairs, 0 elsewhere; ds =
    p·(dp − delta)·scale with dp = dO·vᵀ; dq = ds·k, dk = dsᵀ·q summed over
    each KV head's query heads, dv = pᵀ·dO likewise. In fp32; each
    gradient in its input's dtype. The two halves are the plain versions
    of the two backward kernels."""
    kw = {"causal": causal, "window": window}
    dq, delta = attention_bwd_dq_ref(q, k, v, o, lse, do, **kw)
    return (dq, *attention_bwd_dkdv_ref(q, k, v, lse, delta, do, **kw))
