"""Plain PyTorch version of the flash attention kernel's function (GQA,
causal / sliding-window / unmasked, the query and key lengths apart), in
fp32.

The CPU tests run it, and ``chip_smoke.py`` holds the CUDA kernel against
it on the card. On CUDA tensors nothing on the main path calls it.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None) -> torch.Tensor:
    """q (B, Sq, H, hd); k, v (B, Sk, Hkv, hd). ``causal`` keeps key j for
    query i when j <= i, both counted from 0; the window applies only when
    causal; a query row with no live key comes out 0, as in the kernels.
    Scores, softmax and the product with V in fp32; the output in q's
    dtype."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd ** -0.5
    if causal:
        diff = (torch.arange(Sq, device=q.device)[:, None]
                - torch.arange(Sk, device=q.device)[None, :])
        ok = diff >= 0
        if window is not None:
            ok &= diff < window
        s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if causal and window is not None and Sq > Sk:
        # a row whose window lies wholly past Sk has no live key
        p = p * ok.any(-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
