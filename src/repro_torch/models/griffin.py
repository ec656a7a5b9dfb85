"""Griffin / RecurrentGemma RG-LRU recurrent block (arXiv:2402.19427; port
of ``repro/models/griffin.py``).

Recurrence: a_t = a^(c*r_t) with a = sigmoid(Lambda) (diagonal, in (0,1)),
h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t). The full-sequence
path solves the diagonal linear recurrence with a log-depth doubling scan
in plain PyTorch (the reference's ``jax.lax.associative_scan``, which runs
outside any Pallas kernel); the decode takes one O(1)-state step.

The gates, the scan and the state are fp32 (``lam``, ``b_a`` and ``b_i``
are fp32 parameters whatever the model's dtype); the causal convolution
runs in the activation dtype, its K shifted copies summed in order, as the
reference sums them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _gelu_tanh, dense_init, rmsnorm, rmsnorm_init


def rglru_block_init(generator: torch.Generator, cfg) -> dict:
    d = cfg.d_model
    w = cfg.rglru_width or d
    dt = cfg.torch_dtype
    dev = generator.device
    nx = lambda a, b: dense_init(generator, a, b, dt)
    # Lambda so that a = sigmoid(Lambda) lies in (0.9, 0.999)
    lam_u = torch.rand((w,), generator=generator, device=dev) * (0.999 - 0.9) + 0.9
    conv_w = torch.randn((cfg.conv1d_width, w), generator=generator, device=dev) * 0.02
    return {
        "ln": rmsnorm_init(d, dt, dev),
        "w_rec_in": nx(d, w),          # recurrent branch input proj
        "w_gate_in": nx(d, w),         # multiplicative (gelu) branch
        "conv_w": conv_w.to(dt),
        "conv_b": torch.zeros((w,), dtype=dt, device=dev),
        "lam": torch.log(lam_u / (1 - lam_u)),
        "w_a": nx(w, w), "b_a": torch.zeros((w,), dtype=torch.float32, device=dev),
        "w_i": nx(w, w), "b_i": torch.zeros((w,), dtype=torch.float32, device=dev),
        "w_out": nx(w, d),
    }


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, T, W), w: (K, W)."""
    K, T = w.shape[0], x.shape[1]
    pads = [F.pad(x, (0, 0, K - 1 - i, 0))[:, :T] for i in range(K)]
    out = sum(p * w[i].to(x.dtype) for i, p in enumerate(pads))
    return out + b.to(x.dtype)


def _rglru_gates(p: dict, cfg, x: torch.Tensor):
    """x: (..., W) conv output -> (a, scaled input), both fp32."""
    x32 = x.float()
    r = torch.sigmoid(x32 @ p["w_a"].float() + p["b_a"])
    i = torch.sigmoid(x32 @ p["w_i"].float() + p["b_i"])
    softplus = torch.logaddexp(p["lam"], torch.zeros_like(p["lam"]))
    log_a = -cfg.rglru_c * r * softplus                       # log sigmoid(lam)^(c r)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * x32)
    return a, gated


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None = None):
    """Diagonal linear recurrence h_t = a_t h_{t-1} + b_t.

    a, b: (B, T, W) fp32; ``h0`` (B, W) is folded into the first step.
    Returns (h (B, T, W), final state (B, W)). A doubling scan: after the
    step of offset s each position holds the composition of the s·2
    elements ending there, combined as (a₂·a₁, a₂·b₁ + b₂); ⌈log₂ T⌉
    steps, each a new tensor (differentiable)."""
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    T = a.shape[1]
    s = 1
    while s < T:
        nb = torch.cat([b[:, :s], torch.addcmul(b[:, s:], a[:, s:], b[:, :-s])], dim=1)
        if 2 * s < T:       # the last step needs no new a
            a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        b = nb
        s *= 2
    return b, b[:, -1]


def rglru_block_apply(p: dict, cfg, x: torch.Tensor, collect_state: bool = False):
    """Full-sequence Griffin recurrent block. x: (B, T, d). With
    ``collect_state`` it also returns the decode state after the last token:
    ``h`` and the last K−1 rows of the convolution's input (zeros in front
    when T < K−1)."""
    h = rmsnorm(p["ln"], x, cfg.norm_eps)
    rec_in = h @ p["w_rec_in"]
    rec = _causal_conv1d(rec_in, p["conv_w"], p["conv_b"])
    a, b = _rglru_gates(p, cfg, rec)
    y, h_last = rglru_scan(a, b)
    gate = _gelu_tanh(h @ p["w_gate_in"])
    out = x + (y.to(x.dtype) * gate) @ p["w_out"]
    if not collect_state:
        return out
    K = cfg.conv1d_width
    pad = F.pad(rec_in, (0, 0, K - 1, 0))
    return out, {"h": h_last, "conv": pad[:, pad.shape[1] - (K - 1):]}


def rglru_init_state(cfg, batch: int, device) -> dict:
    w = cfg.rglru_width or cfg.d_model
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv1d_width - 1, w), dtype=cfg.torch_dtype,
                            device=device),
    }


def rglru_block_decode(p: dict, cfg, x: torch.Tensor, state: dict):
    """x: (B, 1, d) -> (out, new state)."""
    h = rmsnorm(p["ln"], x, cfg.norm_eps)
    rec = h @ p["w_rec_in"]                                     # (B,1,W)
    window = torch.cat([state["conv"], rec], dim=1)             # (B,K,W)
    conv_out = (torch.einsum("bkw,kw->bw", window.float(), p["conv_w"].float())
                + p["conv_b"].float())[:, None]
    a, b = _rglru_gates(p, cfg, conv_out)
    hnew = a[:, 0] * state["h"] + b[:, 0]
    gate = _gelu_tanh(h @ p["w_gate_in"])
    out = (hnew[:, None].to(x.dtype) * gate) @ p["w_out"]
    return x + out, {"h": hnew, "conv": window[:, 1:]}
