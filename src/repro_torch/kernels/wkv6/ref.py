"""Plain PyTorch version of the WKV6 recurrence kernel's function (same math
as ``models/rwkv.py::wkv_scan``).

The CPU tests run it, and ``chip_smoke.py`` holds the CUDA kernel against
it on the card. On CUDA tensors nothing on the main path calls it.
"""
from __future__ import annotations

import torch


def wkv6_ref(r, k, v, w, u, state0=None):
    """r,k,v,w: (B, T, H, N); u: (H, N). Returns (y (B,T,H,N) in r's dtype,
    S (B,H,N,N) fp32), one sequential step per t with the state in fp32:
    ``y_t = (Σ r·u·k)·v_t + r_tᵀS``, then ``S ← diag(w_t)·S + k_t v_tᵀ``."""
    B, T, H, N = r.shape
    S = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
         if state0 is None else state0.float())
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()
    ys = []
    for t in range(T):
        rt, kt, vt, wt = rf[:, t], kf[:, t], vf[:, t], wf[:, t]     # (B,H,N)
        coef = (rt * uf * kt).sum(-1, keepdim=True)                 # (B,H,1)
        ys.append(coef * vt + torch.einsum("bhn,bhnm->bhm", rt, S))
        S = wt[..., None] * S + kt[..., None] * vt[..., None, :]
    y = (torch.stack(ys, 1) if T else torch.zeros_like(rf)).to(r.dtype)
    return y, S
