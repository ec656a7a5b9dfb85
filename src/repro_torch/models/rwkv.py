"""RWKV6 ("Finch") block: data-dependent-decay time-mix + channel-mix
(port of ``repro/models/rwkv.py``; arXiv:2404.05892).

The full-sequence block runs the WKV recurrence through the Hopper kernel
(``kernels.wkv6.ops.wkv6``: on CUDA tensors the kernel, on CPU tensors its
plain version); ``use_kernel=False`` takes the plain sequential scan
(``wkv_scan``) whatever the device, so a run on the card can be held
against the plain path. The single-token decode is plain PyTorch, as the
reference computes it in ``jnp``.

Training: on CUDA a block that runs the kernel and needs gradients trains
through ``wkv_ops.WKV6`` (the forward kernel saving its stage states, then
the hand-written backward kernels), ``cfg.rwkv_chunk`` or not:
``use_kernel`` wins over the chunk, as in the reference's
``rwkv_block_apply``. ``wkv_chunked_scan`` (plain PyTorch, checkpointed at
chunk boundaries) runs when ``cfg.rwkv_chunk`` is set and gradients are
wanted, with ``use_kernel=False`` or on CPU tensors, where the kernel's
wrapper would run the plain versions anyway.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.kernels.wkv6.ref import wkv6_ref
from repro_torch.models.layers import dense_init, groupnorm, normal_init, rmsnorm, rmsnorm_init

LORA_MIX = 32     # rank of the ddlerp lora
LORA_DECAY = 64   # rank of the decay lora


def rwkv_block_init(generator: torch.Generator, cfg) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    N = cfg.rwkv_head_dim
    H = d // N
    dt = cfg.torch_dtype
    dev = generator.device
    nx = lambda a, b: dense_init(generator, a, b, dt)
    small = lambda *shape: normal_init(generator, shape, 0.02, torch.float32)
    return {
        "ln1": rmsnorm_init(d, dt, dev),
        "ln2": rmsnorm_init(d, dt, dev),
        # --- time-mix ---
        "mu_x": small(d),
        "mu5": small(5, d),               # w, k, v, r, g
        "mix_w1": nx(d, 5 * LORA_MIX),
        "mix_w2": small(5, LORA_MIX, d),
        "w0": small(d),                   # decay base
        "decay_w1": nx(d, LORA_DECAY),
        "decay_w2": nx(LORA_DECAY, d),
        "u": small(H, N),                 # per-head bonus
        "wr": nx(d, d), "wk": nx(d, d), "wv": nx(d, d), "wg": nx(d, d), "wo": nx(d, d),
        # --- channel-mix ---
        "mu_ck": small(d),
        "mu_cr": small(d),
        "wck": nx(d, ff), "wcv": nx(ff, d), "wcr": nx(d, d),
    }


def _ddlerp(p, x, xx):
    """Data-dependent interpolation producing the 5 mixed inputs (B,T,5,d)."""
    xxx = x + xx * p["mu_x"].to(x.dtype)
    lora = torch.tanh(xxx @ p["mix_w1"]).reshape(*x.shape[:-1], 5, LORA_MIX)
    deltas = torch.einsum("...fr,frd->...fd", lora.float(), p["mix_w2"])
    mix = p["mu5"] + deltas                                    # (B,T,5,d) fp32
    return x[..., None, :] + xx[..., None, :] * mix.to(x.dtype)


def _time_mix_inputs(p, cfg, x, x_prev):
    """Compute (r, k, v, g, w_decay) from x and its shifted predecessor; w
    stays fp32 (decays near 1 would not survive bf16)."""
    d = cfg.d_model
    N = cfg.rwkv_head_dim
    H = d // N
    xx = x_prev - x
    mixed = _ddlerp(p, x, xx)
    xw, xk, xv, xr, xg = (mixed[..., i, :] for i in range(5))
    logw = p["w0"] + torch.tanh(xw.float() @ p["decay_w1"].float()) @ p["decay_w2"].float()
    w = torch.exp(-torch.exp(logw))                            # (B,T,d) in (0,1)
    lead = x.shape[:-1]
    r = (xr @ p["wr"]).reshape(*lead, H, N)
    k = (xk @ p["wk"]).reshape(*lead, H, N)
    v = (xv @ p["wv"]).reshape(*lead, H, N)
    g = F.silu(xg @ p["wg"])
    return r, k, v, g, w.reshape(*lead, H, N)


def wkv_scan(r, k, v, w, u, state0=None):
    """Sequential WKV recurrence (the plain path). r,k,v,w: (B, T, H, N);
    u: (H, N). Returns (y (B,T,H,N), final state (B,H,N,N) fp32)."""
    if r.device.type == "meta":
        return _wkv_scan_meta(r, k, v, w, u, state0)
    return wkv6_ref(r, k, v, w, u, state0)


def _wkv_scan_meta(r, k, v, w, u, state0=None):
    """``wkv_scan`` on meta tensors (the dry run's walk: shapes, no values).
    The sequential scan would dispatch some 16 ops a step; this runs its
    products for all steps at once: step 0 against ``state0`` (or zeros),
    steps 1..T-1 against a (B, T-1, H, N, N) fp32 state made elementwise from
    k, v and w. So a FLOP counter sees the scan's own products, forward and
    backward (step 0's state takes no gradient unless ``state0`` does), and
    autograd saves one state a step, as the scan does."""
    B, T, H, N = r.shape
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    S0 = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
          if state0 is None else state0.float())
    coef = (rf * u.float() * kf).sum(-1, keepdim=True)
    ys = [torch.einsum("bhn,bhnm->bhm", rf[:, 0], S0)[:, None]]
    if T > 1:
        prev = wf[:, 1:, ..., None] * kf[:, :-1, ..., None] * vf[:, :-1, ..., None, :]
        ys.append(torch.einsum("bthn,bthnm->bthm", rf[:, 1:], prev))
    y = coef * vf + torch.cat(ys, dim=1)
    S = wf[:, -1, ..., None] * S0 + kf[:, -1, ..., None] * vf[:, -1, ..., None, :]
    return y.to(r.dtype), S


def wkv_chunked_scan(r, k, v, w, u, chunk: int = 128, state0=None):
    """WKV over chunks of ``chunk`` steps, each chunk's scan under
    ``torch.utils.checkpoint`` (port of the reference's ``wkv_chunked_scan``,
    ``src/repro/models/rwkv.py:76``): the backward keeps only the
    chunk-boundary states (B, H, N, N) and recomputes the steps inside a
    chunk, instead of one state per step. T not a multiple of ``chunk``
    takes the plain ``wkv_scan``, as the reference does. Returns (y, final
    state)."""
    B, T, H, N = r.shape
    if T % chunk:
        return wkv_scan(r, k, v, w, u, state0)
    S = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
         if state0 is None else state0)
    ys = []
    for c in range(T // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        y, S = checkpoint(wkv_scan, r[:, sl], k[:, sl], v[:, sl], w[:, sl], u, S,
                          use_reentrant=False)
        ys.append(y)
    return torch.cat(ys, dim=1), S


def _time_mix_out(p, cfg, y, g, x_shape):
    d = cfg.d_model
    H = d // cfg.rwkv_head_dim
    y = groupnorm(y.reshape(*x_shape[:-1], d), H)
    return (y * g) @ p["wo"]


def _channel_mix(p, x, x_prev):
    xx = x_prev - x
    xk = x + xx * p["mu_ck"].to(x.dtype)
    xr = x + xx * p["mu_cr"].to(x.dtype)
    k = F.relu(xk @ p["wck"]).square()
    return torch.sigmoid(xr @ p["wcr"]) * (k @ p["wcv"])


def _shift(x):
    """Token shift: x_prev[t] = x[t-1], zeros at t=0."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def rwkv_block_apply(p, cfg, x, use_kernel: bool = True, collect_state: bool = False):
    """Full-sequence RWKV6 block. x: (B, T, d). With ``collect_state`` it
    also returns the decode state after the last token (S, ``x_tm``,
    ``x_cm``); the prefill uses that."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    r, k, v, g, w = _time_mix_inputs(p, cfg, h, _shift(h))
    wkv_in = (r, k, v, w, p["u"])
    wants_grad = torch.is_grad_enabled() and any(t.requires_grad for t in wkv_in)
    chunk = cfg.rwkv_chunk if wants_grad else 0
    if use_kernel and (r.device.type != "cpu" or not chunk):
        y, S = wkv_ops.wkv6(*wkv_in)          # through WKV6 when a gradient is wanted
    elif chunk:
        y, S = wkv_chunked_scan(*wkv_in, chunk=chunk)
    else:
        y, S = wkv_scan(*wkv_in)
    x = x + _time_mix_out(p, cfg, y, g, x.shape)
    h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
    x = x + _channel_mix(p, h2, _shift(h2))
    if collect_state:
        return x, {"S": S, "x_tm": h[:, -1], "x_cm": h2[:, -1]}
    return x


# ---------------------------------------------------------------------------
# decode (single token, O(1) state)
# ---------------------------------------------------------------------------

def rwkv_init_state(cfg, batch: int, device) -> dict:
    d = cfg.d_model
    N = cfg.rwkv_head_dim
    H = d // N
    dt = cfg.torch_dtype
    return {
        "S": torch.zeros((batch, H, N, N), dtype=torch.float32, device=device),
        "x_tm": torch.zeros((batch, d), dtype=dt, device=device),  # last time-mix input
        "x_cm": torch.zeros((batch, d), dtype=dt, device=device),  # last channel-mix input
    }


def rwkv_block_decode(p, cfg, x, state):
    """x: (B, 1, d) -> (out (B,1,d), new state)."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    r, k, v, g, w = _time_mix_inputs(p, cfg, h, state["x_tm"][:, None])
    rt, kt, vt, wt = (a[:, 0].float() for a in (r, k, v, w))
    S = state["S"]
    coef = (rt * p["u"] * kt).sum(-1, keepdim=True)
    y = coef * vt + torch.einsum("bhn,bhnm->bhm", rt, S)
    S = wt[..., None] * S + kt[..., None] * vt[..., None, :]
    y = y[:, None].to(x.dtype)                                  # (B,1,H,N)
    x = x + _time_mix_out(p, cfg, y, g, x.shape)
    h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
    out = x + _channel_mix(p, h2, state["x_cm"][:, None])
    return out, {"S": S, "x_tm": h[:, 0], "x_cm": h2[:, 0]}
