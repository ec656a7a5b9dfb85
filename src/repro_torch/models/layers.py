"""Common neural building blocks (port of ``repro/models/layers.py``).

Plain functions on tensors over parameter dicts, as the reference has.
Every draw comes from an explicit ``torch.Generator`` and is made on the
generator's device: a CUDA generator draws on the card (a full-width
model's billions of draws would take minutes on the host), a CPU
generator on the CPU. ``shard_activation`` is left out: without a mesh
it is the identity.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# initialisers
# ---------------------------------------------------------------------------

def normal_init(generator: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return w.mul_(scale).to(dtype)


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32) -> torch.Tensor:
    """(d_in, d_out) normal draws scaled by ``sqrt(2 / (d_in + d_out))``,
    on the generator's device."""
    return normal_init(generator, (d_in, d_out), (2.0 / (d_in + d_out)) ** 0.5, dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int, dtype) -> torch.Tensor:
    return normal_init(generator, (vocab, d), 0.02, dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * params["scale"].float()).to(x.dtype)


def groupnorm(x: torch.Tensor, n_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """Per-head group norm used by RWKV time-mix output; no learned affine,
    population variance (as ``jnp.var``)."""
    *lead, d = x.shape
    g = x.reshape(*lead, n_groups, d // n_groups).float()
    mean = g.mean(-1, keepdim=True)
    var = g.var(-1, keepdim=True, correction=0)
    g = (g - mean) * torch.rsqrt(var + eps)
    return g.reshape(*lead, d).to(x.dtype)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; torch to the erf form
    return F.gelu(x, approximate="tanh")


def _sqrelu(x: torch.Tensor) -> torch.Tensor:
    return F.relu(x).square()


_ACTIVATIONS = {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu, "sqrelu": _sqrelu}


def activation_fn(name: str):
    if name not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}")
    return _ACTIVATIONS[name]


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S). Rotates the
    two halves of hd (not interleaved pairs), angles in fp32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                      # (hd/2,)
    angles = positions[..., None].float() * freqs                # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                        # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x32 = x.float()
    x1, x2 = x32[..., : hd // 2], x32[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# dense MLP
# ---------------------------------------------------------------------------

def mlp_init(generator: torch.Generator, d: int, ff: int, gated: bool, dtype) -> dict:
    p = {"w_in": dense_init(generator, d, ff, dtype),
         "w_out": dense_init(generator, ff, d, dtype)}
    if gated:
        p["w_gate"] = dense_init(generator, d, ff, dtype)
    return p


def mlp_apply(params: dict, x: torch.Tensor, act_name: str) -> torch.Tensor:
    act = activation_fn(act_name)
    h = x @ params["w_in"]
    if "w_gate" in params:
        h = act(x @ params["w_gate"]) * h
    else:
        h = act(h)
    return h @ params["w_out"]


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, mask=None) -> torch.Tensor:
    """Next-token cross entropy. logits (..., V) of any float type, labels
    (...) int; in fp32. With ``mask`` (...), the masked mean (the sum over
    the mask, over at least 1)."""
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    gold = torch.take_along_dim(logits32, labels[..., None].long(), dim=-1)[..., 0]
    nll = lse - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
