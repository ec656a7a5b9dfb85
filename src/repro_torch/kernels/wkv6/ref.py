"""Plain PyTorch versions of the WKV6 recurrence kernels' functions (same
math as ``models/rwkv.py::wkv_scan`` and its gradient).

The CPU tests run them, ``WKV6`` (``ops.py``) runs them on CPU tensors,
and ``chip_smoke.py`` holds the CUDA kernels against them on the card. On
CUDA tensors nothing on the main path calls them.
"""
from __future__ import annotations

import torch

# steps between two saved states (the forward kernel's stage, kTS)
STAGE_STEPS = 32


def wkv6_ref(r, k, v, w, u, state0=None, stage_states: bool = False):
    """r,k,v,w: (B, T, H, N); u: (H, N). Returns (y (B,T,H,N) in r's dtype,
    S (B,H,N,N) fp32), one sequential step per t with the state in fp32:
    ``y_t = (Σ r·u·k)·v_t + r_tᵀS``, then ``S ← diag(w_t)·S + k_t v_tᵀ``.
    With ``stage_states`` it also returns the state at the start of each
    ``STAGE_STEPS``-step stage, (B, H, ceil(T / STAGE_STEPS), N, N) fp32:
    what the forward kernel saves for the backward."""
    B, T, H, N = r.shape
    S = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
         if state0 is None else state0.float())
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()
    ys, saved = [], []
    for t in range(T):
        if t % STAGE_STEPS == 0:
            saved.append(S)
        rt, kt, vt, wt = rf[:, t], kf[:, t], vf[:, t], wf[:, t]     # (B,H,N)
        coef = (rt * uf * kt).sum(-1, keepdim=True)                 # (B,H,1)
        ys.append(coef * vt + torch.einsum("bhn,bhnm->bhm", rt, S))
        S = wt[..., None] * S + kt[..., None] * vt[..., None, :]
    y = (torch.stack(ys, 1) if T else torch.zeros_like(rf)).to(r.dtype)
    if not stage_states:
        return y, S
    states = (torch.stack(saved, 2) if saved
              else torch.zeros((B, H, 0, N, N), dtype=torch.float32, device=r.device))
    return y, S, states


def wkv6_bwd_ref(r, k, v, w, u, dy, ds=None, states=None):
    """The gradient of ``wkv6_ref`` from a zero state: (dr, dk, dv in r's
    dtype, dw fp32, du in u's dtype) from dy (B, T, H, N) and ds, the
    gradient of the returned S (B, H, N, N; None for 0). With S_t the state
    after step t and G_t = dL/dS_t (G_T = ds), per (b, h):

        G_{t-1} = diag(w_t) G_t + r_tᵀ dy_t
        dr_t = S_{t-1} dy_t + u ⊙ k_t (v_t · dy_t)
        dk_t = G_t v_t + u ⊙ r_t (v_t · dy_t)
        dv_t = G_tᵀ k_t + coef_t dy_t
        dw_t = Σ_j S_{t-1}[:, j] ⊙ G_t[:, j]
        du = Σ_{b,t} r_t ⊙ k_t (v_t · dy_t)

    The state and every sum in fp32. The states inside a stage are
    recomputed from ``states`` (the forward's stage states, computed here
    when None), so no more than one stage of them is held at once."""
    B, T, H, N = r.shape
    rf, kf, vf, wf, dyf = (a.float() for a in (r, k, v, w, dy))
    uf = u.float()
    if states is None:
        states = wkv6_ref(r, k, v, w, u, stage_states=True)[2]
    G = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
         if ds is None else ds.float().clone())
    dr, dk, dv, dw = (torch.zeros((B, T, H, N), dtype=torch.float32, device=r.device)
                      for _ in range(4))
    for s in reversed(range(states.shape[2])):
        t0 = s * STAGE_STEPS
        S = states[:, :, s].float()
        before = []                                   # S_{t-1} of each step of the stage
        for t in range(t0, min(t0 + STAGE_STEPS, T)):
            before.append(S)
            S = wf[:, t, ..., None] * S + kf[:, t, ..., None] * vf[:, t, :, None, :]
        for t in reversed(range(t0, t0 + len(before))):
            Sp = before[t - t0]
            dr[:, t] = torch.einsum("bhnm,bhm->bhn", Sp, dyf[:, t])
            dw[:, t] = (Sp * G).sum(-1)
            dk[:, t] = torch.einsum("bhnm,bhm->bhn", G, vf[:, t])
            dv[:, t] = torch.einsum("bhnm,bhn->bhm", G, kf[:, t])
            G = wf[:, t, ..., None] * G + rf[:, t, ..., None] * dyf[:, t, :, None, :]
    vdy = (vf * dyf).sum(-1, keepdim=True)                          # (B,T,H,1)
    coef = (rf * uf * kf).sum(-1, keepdim=True)
    dr = dr + uf * kf * vdy
    dk = dk + uf * rf * vdy
    dv = dv + coef * dyf
    du = (rf * kf * vdy).sum((0, 1))
    return dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw, du.to(u.dtype)

