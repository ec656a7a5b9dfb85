"""Mixture-of-Experts FFN with top-k routing and capacity dispatch (port of
``repro/models/moe.py``).

Tokens are packed into a dense (E, C, d) buffer so the expert products are
batched matmuls over the expert axis, as the reference computes them
(einsum, outside any Pallas kernel); the dispatch and combine are single
scatters. Two dispatches, as in the reference: ``sort`` (the default: a
stable sort by expert id, each token's rank within its expert's segment)
and ``einsum`` (group-wise one-hot dispatch). The load-balance aux loss
is the switch-transformer form. ``shard_activation`` is dropped: on one
device it is the identity.

Discrete decisions match the reference's exactly: ``top_k`` breaks ties
by the lower expert index (as ``jax.lax.top_k`` does; ``torch.topk``
promises no order), the sort is stable and ``searchsorted`` takes the left
side, and the capacity ``C = int(max(1, round(T·K/E·cf)))`` is computed on
the host with Python's ``round``. A token over capacity is dropped, also at
decode (dbrx-132b's capacity factor 1.25 gives C = 1 for a 4-token step).

The sort dispatch's combine puts each token's K weighted expert outputs
back in (token, k) order and sums them in fp32, rounding once to the
activation dtype. The reference scatter-adds them (``.at[st].add``, a
rounding per add in bf16); ``index_add_`` would do the same with atomics
on CUDA, whose order changes between runs. So two runs on the card give
the same bits, and a bf16 token differs from the reference's by its
rounding only (fp32: by the order of K additions).
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import activation_fn, dense_init, mlp_apply, mlp_init


def _expert_stack(generator: torch.Generator, E: int, d_in: int, d_out: int, dtype):
    """(E, d_in, d_out), each expert drawn as ``dense_init`` draws one
    matrix; filled expert by expert (one expert's fp32 draw at a time). On
    meta (shapes only) there is nothing to fill."""
    out = torch.empty((E, d_in, d_out), dtype=dtype, device=generator.device)
    if out.is_meta:
        return out
    for e in range(E):
        out[e] = dense_init(generator, d_in, d_out, dtype)
    return out


def moe_init(generator: torch.Generator, cfg) -> dict:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = cfg.torch_dtype
    p = {
        "router": dense_init(generator, d, E, torch.float32),
        "w_in": _expert_stack(generator, E, d, ff, dt),
        "w_out": _expert_stack(generator, E, ff, d, dt),
    }
    if cfg.gated_mlp:
        p["w_gate"] = _expert_stack(generator, E, d, ff, dt)
    if cfg.moe_dense_residual:  # arctic: parallel dense FFN
        p["dense"] = mlp_init(generator, d, cfg.dense_ff_dim or ff, cfg.gated_mlp, dt)
    return p


def capacity(n_tokens: int, cfg) -> int:
    """Slots per expert: ``int(max(1, round(T·K/E·cf)))`` (Python's round)."""
    return int(max(1, round(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)))


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index first (``jax.lax.top_k``'s order)."""
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(probs, -1, order), order


def route(params: dict, cfg, x: torch.Tensor):
    """x (..., d) -> (probs (..., E) fp32, top_w (..., K) renormalised,
    top_i (..., K), aux_loss)."""
    E, K = cfg.n_experts, cfg.top_k
    router_logits = x.float() @ params["router"]
    probs = torch.softmax(router_logits, dim=-1)
    top_w, top_i = top_k(probs, K)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    me = probs.reshape(-1, E).mean(0)
    # each expert's count of (token, k) pairs: bincount's values, by an op
    # that also runs on meta tensors (the dry run's)
    flat = top_i.reshape(-1)
    counts = torch.zeros(E, dtype=torch.int64, device=flat.device)
    ce = counts.scatter_add_(0, flat, torch.ones_like(flat)).float() / top_i.numel()
    return probs, top_w, top_i, E * torch.sum(me * ce)


def sort_dispatch(top_i: torch.Tensor, C: int, E: int):
    """The sort dispatch's discrete decisions for (T, K) expert ids:
    (order, rank, keep) over the T·K (token, k) pairs sorted stably by
    expert, ``rank`` the pair's slot within its expert, ``keep`` rank < C."""
    flat_e = top_i.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    se = flat_e[order]
    seg_start = torch.searchsorted(se, torch.arange(E, device=se.device), right=False)
    rank = torch.arange(se.numel(), device=se.device) - seg_start[se]
    return order, rank, rank < C


def _experts(params: dict, cfg, buf: torch.Tensor) -> torch.Tensor:
    """The expert MLPs on a (E, C, d) buffer, batched over E."""
    act = activation_fn(cfg.activation)
    h = torch.bmm(buf, params["w_in"])
    if cfg.gated_mlp:
        h = act(torch.bmm(buf, params["w_gate"])) * h
    else:
        h = act(h)
    return torch.bmm(h, params["w_out"])


def moe_apply(params: dict, cfg, x: torch.Tensor):
    """Dispatch on cfg.moe_impl: 'sort' (default) or 'einsum'."""
    if getattr(cfg, "moe_impl", "sort") == "einsum":
        return moe_apply_einsum(params, cfg, x)
    return moe_apply_sort(params, cfg, x)


def moe_apply_sort(params: dict, cfg, x: torch.Tensor):
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar)."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    xf = x.reshape(T, d)
    _, top_w, top_i, aux_loss = route(params, cfg, xf)

    C = capacity(T, cfg)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(K)
    order, rank, keep = sort_dispatch(top_i, C, E)
    se, st, sw = top_i.reshape(-1)[order], flat_t[order], top_w.reshape(-1)[order]

    # scatter token features into the expert buffer; dropped -> bucket E,
    # whose writes are all zeros
    idx_e = torch.where(keep, se, E)
    idx_c = torch.where(keep, rank, 0)
    buf = torch.zeros((E + 1, C, d), dtype=x.dtype, device=x.device)
    buf[idx_e, idx_c] = xf[st] * keep[:, None].to(x.dtype)
    y = _experts(params, cfg, buf[:E])                                # (E, C, d)

    # combine back, weighted: each token's K values back in (token, k)
    # order and summed over k (the reference scatter-adds them)
    y_pad = torch.cat([y, y.new_zeros((1, C, d))], dim=0)
    vals = y_pad[idx_e, idx_c] * (sw * keep).to(y.dtype)[:, None]
    per_token = torch.empty_like(vals)
    per_token[order] = vals
    out = per_token.reshape(B, S, K, d).sum(2, dtype=torch.float32).to(y.dtype)
    if "dense" in params:  # arctic dense residual path
        out = out + mlp_apply(params["dense"], x, cfg.activation)
    return out, aux_loss


def moe_apply_einsum(params: dict, cfg, x: torch.Tensor):
    """Group-wise one-hot dispatch, x: (B, S, d). Each group of
    ``cfg.moe_group_size`` tokens (one sequence when 0) routes on its own."""
    B0, S0, d = x.shape
    g = getattr(cfg, "moe_group_size", 0) or S0
    g = min(g, S0)
    if S0 % g:
        g = S0
    x = x.reshape(B0 * S0 // g, g, d)
    B, S, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(S, cfg)
    _, top_w, top_i, aux_loss = route(params, cfg, x)

    # position of each (token, k) within its expert, per group
    expert_onehot = torch.nn.functional.one_hot(top_i, E).float()     # (B, S, K, E)
    pos = torch.cumsum(expert_onehot.reshape(B, S * K, E), dim=1).reshape(B, S, K, E)
    pos = pos * expert_onehot - 1.0                                   # slot, -1 if unrouted
    keep = (pos >= 0) & (pos < C)
    slot = torch.where(keep, pos, -1.0).to(torch.int32).amax(-1)      # (B, S, K)
    slot_onehot = (slot[..., None] == torch.arange(C, device=x.device)).to(x.dtype)
    routed = expert_onehot * keep
    dispatch = torch.einsum("bske,bskc->bsec", routed.to(x.dtype), slot_onehot)
    weights = torch.einsum("bske,bsk->bse", routed, top_w)            # (B, S, E)

    buf = torch.einsum("bsec,bsd->ebcd", dispatch, x)                 # (E, B, C, d)
    y = _experts(params, cfg, buf.reshape(E, B * C, d)).reshape(E, B, C, d)
    out = torch.einsum("ebcd,bsec->bsd", y, dispatch * weights[..., None].to(x.dtype))
    if "dense" in params:
        out = out + mlp_apply(params["dense"], x, cfg.activation)
    return out.reshape(B0, S0, d), aux_loss
