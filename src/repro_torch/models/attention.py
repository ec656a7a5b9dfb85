"""Attention: GQA, causal / sliding-window / bidirectional self-attention
and cross attention over the full sequence, plus single-token decode
against a KV cache or a cross K/V (port of ``repro/models/attention.py``).

The full-sequence path runs through the Hopper flash attention kernel
(``kernels.flash_attention.ops.flash_attention``: on CUDA tensors the
kernel, on CPU tensors its plain version) whatever ``cfg.attn_impl`` says:
the reference's ``einsum`` and ``chunked`` implementations compute the same
function. ``use_kernel=False`` takes the kernel's plain version
(``attention_ref``) whatever the device, so a run on the card can be held
against it (in fp32 it computes what the reference's einsum path does;
in bf16 it keeps the probabilities in fp32, as the kernel does, where the
einsum path casts them to bf16 before p·v). ``kind="bidir"`` runs it
unmasked. Cross attention (``kv_source``) takes Q from the block's normed
input and K/V from the already-normed encoder output, without RoPE; the
kernel takes the two lengths apart (Sq != Sk).

The decode is plain PyTorch, as the reference computes it in ``jnp``. It
writes the new token's K/V into the cache in place (the reference returns
an updated copy); the cache is the caller's decode state, so nothing else
holds it. A cross decode (``cross_kv``) attends to the encoder's K/V
unmasked and writes nothing.

Shapes: hidden (B, S, d); q (B, S, H, hd); kv (B, S, Hkv, hd).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.layers import apply_rope, dense_init, rmsnorm, rmsnorm_init

NEG_INF = -1e30
_KINDS = ("causal", "local", "bidir")


def attn_init(generator: torch.Generator, cfg, cross: bool = False) -> dict:
    """The same leaves for self and cross attention (``cross`` is the
    reference's flag; it changes nothing)."""
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    dt = cfg.torch_dtype
    return {
        "ln": rmsnorm_init(d, dt, generator.device),
        "wq": dense_init(generator, d, qd, dt),
        "wk": dense_init(generator, d, kvd, dt),
        "wv": dense_init(generator, d, kvd, dt),
        "wo": dense_init(generator, qd, d, dt),
    }


def _split_heads(x, n_heads, head_dim):
    return x.reshape(*x.shape[:-1], n_heads, head_dim)


def _check_kind(kind: str):
    if kind not in _KINDS:
        raise ValueError(f"attention kind {kind!r}: one of {_KINDS}")


def multihead_attn(params: dict, cfg, x: torch.Tensor, *, kind: str = "causal",
                   positions: torch.Tensor | None = None,
                   kv_source: torch.Tensor | None = None, return_kv: bool = False,
                   use_kernel: bool = True):
    """Full-sequence attention (prefill). ``kv_source`` (B, Sk, d), the
    normed encoder output, makes it cross attention. Returns out (B, S, d),
    and with ``return_kv`` also (k, v): roped for the decode cache, or the
    cross K/V."""
    _check_kind(kind)
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    h = rmsnorm(params["ln"], x, cfg.norm_eps)
    q = _split_heads(h @ params["wq"], cfg.n_heads, hd)
    src = h if kv_source is None else kv_source
    k = _split_heads(src @ params["wk"], cfg.n_kv_heads, hd)
    v = _split_heads(src @ params["wv"], cfg.n_kv_heads, hd)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if cfg.pos_embedding == "rope" and kv_source is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    window = cfg.window_size if kind == "local" else None
    attend = flash_ops.flash_attention if use_kernel else attention_ref
    out = attend(q, k, v, causal=kind != "bidir", window=window)
    out = out.reshape(B, S, cfg.q_dim) @ params["wo"]
    if return_kv:
        return out, (k, v)
    return out


def _attend(q, k, v, bias=None):
    """softmax(q kᵀ · hd^-0.5 + bias) v for q (B,Sq,H,hd) and k, v
    (B,Sk,Hkv,hd), the bias broadcastable to (Sq, Sk) or None. GQA by
    grouping the query heads (no repeated K/V)."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, hd)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, k).float() * hd ** -0.5
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bgrqk,bkgd->bqgrd", probs, v).reshape(B, Sq, H, hd)


# ---------------------------------------------------------------------------
# decode (single new token against a KV cache)
# ---------------------------------------------------------------------------

def init_kv_cache(cfg, batch: int, max_len: int, device) -> dict:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}


def decode_attn(params: dict, cfg, x: torch.Tensor, cache: dict, pos: int, *,
                kind: str = "causal", cross_kv: tuple | None = None):
    """One-token attention, x (B, 1, d) at position ``pos``. Writes the
    token's K/V into ``cache`` at ``pos`` in place and returns (out
    (B, 1, d), cache). With ``cross_kv`` = (xk, xv), each (B, Sk, Hkv, hd),
    it attends to them unmasked, without RoPE, and leaves ``cache`` as it
    is."""
    _check_kind(kind)
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    h = rmsnorm(params["ln"], x, cfg.norm_eps)
    q = _split_heads(h @ params["wq"], cfg.n_heads, hd)           # (B,1,H,hd)
    if cross_kv is not None:
        out = _attend(q, *cross_kv)
        return out.reshape(B, 1, cfg.q_dim) @ params["wo"], cache
    k_new = _split_heads(h @ params["wk"], cfg.n_kv_heads, hd)
    v_new = _split_heads(h @ params["wv"], cfg.n_kv_heads, hd)
    if cfg.pos_embedding == "rope":
        posv = torch.full((B, 1), pos, device=x.device)
        q = apply_rope(q, posv, cfg.rope_theta)
        k_new = apply_rope(k_new, posv, cfg.rope_theta)
    cache["k"][:, pos] = k_new[:, 0]
    cache["v"][:, pos] = v_new[:, 0]
    S = cache["k"].shape[1]
    kpos = torch.arange(S, device=x.device)
    ok = kpos <= pos
    if kind == "local":
        ok &= kpos > pos - cfg.window_size
    mask = torch.where(ok, 0.0, NEG_INF)                           # (S,)
    out = _attend(q, cache["k"], cache["v"], mask)
    return out.reshape(B, 1, cfg.q_dim) @ params["wo"], cache
