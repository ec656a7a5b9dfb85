"""Language model for serving and training: embedding + blocks + final
norm + LM head (port of ``repro/models/lm.py`` for every block kind: ``rwkv`` (RWKV6),
``rec`` (Griffin's RG-LRU, ``models/griffin.py``), ``attn`` and ``local``,
each with a dense or a mixture-of-experts FFN (``models/moe.py``), and
whisper's ``enc`` (bidirectional) and ``dec`` (causal self attention, then
cross attention onto the encoder's output) blocks). An encoder
(``n_encoder_layers``) runs over ``enc_frames`` (B, Se, d), stub frame
embeddings with learned positions (``enc_pos``); image embeddings
(B, n_image_tokens, d) are prepended to the prompt; ``pos_emb`` adds
learned positions to the decoder's tokens, absolute in the decode step.

Parameters are plain dicts with the reference's keys. Where the reference
stacks the repeated unit on a leading axis and scans over it, the port
keeps ``params["units"]`` and ``params["enc_units"]`` (and the decode
state's ``"units"`` and ``"cross"``, the per-unit cross K/V) as Python
lists of per-unit dicts and loops over them; ``convert.lm_params_from_numpy``
unstacks the reference's tree and ``lm_params_to_numpy`` stacks it back.

The full-sequence blocks run the Hopper kernels (``wkv6`` in ``rwkv``
blocks, ``flash_attention`` in ``attn``/``local``/``enc`` blocks and twice
in a ``dec`` block: its self attention and its cross attention, Sq != Sk);
``use_kernel=False`` takes the plain paths instead, so a run on the card can be held
against them. ``rec`` blocks and the MoE FFN are plain PyTorch on both
paths, as the reference computes them outside Pallas. The decode step is
plain PyTorch and updates the KV caches of the state it is given in place.

``lm_prefill`` applies the LM head to the last position only (the
reference builds the full (B, S, V) logits and keeps the last row: the
same numbers, without gemma3-12b's 4 GB of logits at B=4, S=2048).

Training (``lm_loss``, ``make_train_step``) differentiates the same
forward with autograd: the flash attention kernel carries gradients
through its own backward kernels (``kernels/flash_attention/ops.py``), and
the WKV6 kernel through its own (``kernels/wkv6/ops.py::WKV6``), ``rwkv_chunk``
or not (``use_kernel=False`` trains RWKV through the plain scans). Under
``cfg.remat`` each repeated unit runs under
``torch.utils.checkpoint``, as the reference's ``jax.checkpoint`` does.

Entry points:
    init_lm(generator, cfg, device)             -> params
    lm_forward(params, cfg, tokens, ...)        -> (logits, aux_loss)
    lm_loss(params, cfg, batch)                 -> (loss, metrics)
    loss_and_grads(params, cfg, batch)          -> (loss, metrics, grads)
    make_train_step(cfg, lr_schedule)           -> train_step
    init_train_state(generator, cfg, ...)       -> (params, opt_state)
    lm_prefill(params, cfg, tokens, max_len, ...)
                                                -> (last_logits, decode_state)
    init_decode_state(params, cfg, B, max_len, enc_out=...) -> state
    decode_step(params, cfg, state, token, pos) -> (logits, state)

``...`` is ``image_embeds`` and ``enc_frames``, as the reference takes
them. The logits of ``lm_forward`` cover the image tokens too.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import griffin, rwkv
from repro_torch.models.attention import attn_init, decode_attn, init_kv_cache, multihead_attn
from repro_torch.models.layers import (
    dense_init,
    embed_init,
    mlp_apply,
    mlp_init,
    rmsnorm,
    rmsnorm_init,
    softmax_xent,
)
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.optim import AdamState, adamw_init, adamw_update
from repro_torch.utils.tree import global_norm_clip, tree_map

_ATTN_KINDS = {"attn": "causal", "local": "local", "enc": "bidir", "dec": "causal"}
_KINDS = ("rwkv", "rec", *_ATTN_KINDS)


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for a block kind the reference does
    not have either."""
    kinds = set(cfg.block_pattern) | set(cfg.remainder_pattern)
    if not kinds <= set(_KINDS):
        raise NotImplementedError(
            f"{cfg.arch_id}: unknown block kinds {sorted(kinds - set(_KINDS))}; the "
            f"reference and the port run {_KINDS}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _ffn_init(generator, cfg):
    p = {"ln": rmsnorm_init(cfg.d_model, cfg.torch_dtype, generator.device)}
    if cfg.n_experts:
        p["moe"] = moe_init(generator, cfg)
    else:
        p["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.gated_mlp, cfg.torch_dtype)
    return p


def init_block(generator, cfg, kind: str) -> dict:
    if kind == "rwkv":
        return rwkv.rwkv_block_init(generator, cfg)
    if kind == "rec":
        return {"rec": griffin.rglru_block_init(generator, cfg),
                "ffn": _ffn_init(generator, cfg)}
    p = {"attn": attn_init(generator, cfg), "ffn": _ffn_init(generator, cfg)}
    if kind == "dec":
        p["xattn"] = attn_init(generator, cfg, cross=True)
    return p


def _init_unit(generator, cfg, pattern) -> dict:
    return {f"b{i}": init_block(generator, cfg, kind) for i, kind in enumerate(pattern)}


def init_lm(generator: torch.Generator, cfg, device=None) -> dict:
    """Fresh params drawn from ``generator`` on ``device`` (``None`` is
    ``cuda:0``). The generator must live on that device: a CUDA generator
    draws a full-width model on the card. Same shapes and scales as the
    reference's ``init_lm``, not the same values. ``device="meta"`` with a
    ``device.MetaGenerator`` gives the shapes alone (the dry run's)."""
    check_supported(cfg)
    dev = resolve_device(device, allow_meta=True)
    if generator.device.type != dev.type:
        raise ValueError(f"init_lm: generator on {generator.device}, params on {dev}; "
                         "give a generator on the params' device")
    dt = cfg.torch_dtype
    params: dict = {"embed": embed_init(generator, cfg.vocab_size, cfg.d_model, dt)}
    params["units"] = [_init_unit(generator, cfg, cfg.block_pattern)
                       for _ in range(cfg.n_units)]
    if cfg.remainder_pattern:
        params["rem"] = _init_unit(generator, cfg, cfg.remainder_pattern)
    params["final_norm"] = rmsnorm_init(cfg.d_model, dt, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab_size, dt)
    if cfg.pos_embedding == "learned":
        params["pos_emb"] = embed_init(generator, cfg.max_seq_len, cfg.d_model, dt)
    if cfg.n_encoder_layers:
        params["enc_units"] = [_init_unit(generator, cfg, ("enc",))
                               for _ in range(cfg.n_encoder_layers)]
        params["enc_norm"] = rmsnorm_init(cfg.d_model, dt, dev)
        params["enc_pos"] = embed_init(generator, cfg.encoder_seq_len, cfg.d_model, dt)
    return params


# ---------------------------------------------------------------------------
# full-sequence application (prefill)
# ---------------------------------------------------------------------------

def _apply_ffn(p, cfg, x):
    """Returns (x, aux_loss): the dense MLP's aux is 0."""
    h = rmsnorm(p["ln"], x, cfg.norm_eps)
    if "moe" in p:
        y, aux = moe_apply(p["moe"], cfg, h)
        return x + y, aux
    return x + mlp_apply(p["mlp"], h, cfg.activation), 0.0


def apply_block_full(bp, cfg, kind, x, *, enc_out=None, collect_state=False,
                     use_kernel=True):
    """Returns (x, aux_loss, state_or_None). A ``dec`` block attends to
    ``enc_out`` (B, Se, d), the normed encoder output; an ``enc`` block
    keeps no state."""
    if kind == "rwkv":
        out = rwkv.rwkv_block_apply(bp, cfg, x, use_kernel=use_kernel,
                                    collect_state=collect_state)
        x, state = out if collect_state else (out, None)
        return x, 0.0, state
    if kind == "rec":
        out = griffin.rglru_block_apply(bp["rec"], cfg, x, collect_state=collect_state)
        x, state = out if collect_state else (out, None)
        x, aux = _apply_ffn(bp["ffn"], cfg, x)
        return x, aux, state
    akind = _ATTN_KINDS[kind]
    state = None
    if collect_state and kind != "enc":
        out, (k, v) = multihead_attn(bp["attn"], cfg, x, kind=akind, return_kv=True,
                                     use_kernel=use_kernel)
        state = {"k": k, "v": v}
    else:
        out = multihead_attn(bp["attn"], cfg, x, kind=akind, use_kernel=use_kernel)
    x = x + out
    if kind == "dec":
        x = x + multihead_attn(bp["xattn"], cfg, x, kind="bidir", kv_source=enc_out,
                               use_kernel=use_kernel)
    x, aux = _apply_ffn(bp["ffn"], cfg, x)
    return x, aux, state


def _lm_head(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _run_encoder(params, cfg, enc_frames, *, use_kernel=True):
    """Whisper's encoder over stub frame embeddings (B, Se, d): learned
    positions, the ``enc`` blocks, the encoder norm. Returns (enc_out,
    aux)."""
    h = enc_frames.to(cfg.torch_dtype) + params["enc_pos"][None, :enc_frames.shape[1]]
    aux = 0.0
    for up in params["enc_units"]:
        h, a, _ = apply_block_full(up["b0"], cfg, "enc", h, use_kernel=use_kernel)
        aux = aux + a
    return rmsnorm(params["enc_norm"], h, cfg.norm_eps), aux


def _embed_tokens(params, cfg, tokens, image_embeds=None, position_offset: int = 0):
    """tokens (B, S) -> (B, n_image + S, d): the image embeddings first,
    then learned positions from ``position_offset`` where the config has
    them."""
    h = params["embed"][tokens]
    if image_embeds is not None:
        h = torch.cat([image_embeds.to(h.dtype), h], dim=1)
    if cfg.pos_embedding == "learned":
        h = h + params["pos_emb"][None, position_offset:position_offset + h.shape[1]]
    return h


def _forward_hidden(params, cfg, tokens, *, image_embeds, enc_frames, collect_state,
                    use_kernel):
    """tokens (B, S) -> (final-normed hidden (B, S_total, d), aux, unit
    states, remainder states, encoder output or None)."""
    check_supported(cfg)
    aux, enc_out = 0.0, None
    if cfg.n_encoder_layers:
        if enc_frames is None:
            raise ValueError(f"{cfg.arch_id}: the encoder needs enc_frames (B, "
                             f"{cfg.encoder_seq_len}, {cfg.d_model})")
        enc_out, aux = _run_encoder(params, cfg, enc_frames, use_kernel=use_kernel)
    h = _embed_tokens(params, cfg, tokens, image_embeds)

    def blocks(h, aux, bps, pattern):
        states = {}
        for i, kind in enumerate(pattern):
            h, a, states[f"b{i}"] = apply_block_full(bps[f"b{i}"], cfg, kind, h,
                                                     enc_out=enc_out,
                                                     collect_state=collect_state,
                                                     use_kernel=use_kernel)
            aux = aux + a
        return h, aux, states

    remat = cfg.remat and torch.is_grad_enabled() and not collect_state
    unit_states = []
    for up in params["units"]:
        if remat:
            h, aux, st = checkpoint(blocks, h, aux, up, cfg.block_pattern,
                                    use_reentrant=False)
        else:
            h, aux, st = blocks(h, aux, up, cfg.block_pattern)
        unit_states.append(st)
    rem_states = {}
    if cfg.remainder_pattern:
        h, aux, rem_states = blocks(h, aux, params["rem"], cfg.remainder_pattern)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return h, aux, unit_states, rem_states, enc_out


def lm_forward(params, cfg, tokens, *, image_embeds=None, enc_frames=None,
               use_kernel=True):
    """tokens (B, S) -> (logits (B, S_total, V), aux_loss); S_total counts
    the image tokens."""
    h, aux, _, _, _ = _forward_hidden(params, cfg, tokens, image_embeds=image_embeds,
                                      enc_frames=enc_frames, collect_state=False,
                                      use_kernel=use_kernel)
    return h @ _lm_head(params, cfg), aux


# ---------------------------------------------------------------------------
# loss / train step
# ---------------------------------------------------------------------------

def lm_loss(params, cfg, batch, *, use_kernel=True):
    """(loss, {"xent", "aux"}): the next-token cross entropy over the text
    positions (the image tokens' logits sliced off) plus 0.01 x the MoE
    load-balancing aux. ``batch`` holds "tokens" and "labels" (B, S), and
    "image_embeds" / "enc_frames" where the config takes them."""
    logits, aux = lm_forward(params, cfg, batch["tokens"],
                             image_embeds=batch.get("image_embeds"),
                             enc_frames=batch.get("enc_frames"), use_kernel=use_kernel)
    if cfg.n_image_tokens:
        logits = logits[:, cfg.n_image_tokens:]
    loss = softmax_xent(logits, batch["labels"])
    aux = torch.as_tensor(aux, dtype=torch.float32, device=loss.device)
    return loss + 0.01 * aux, {"xent": loss, "aux": aux}


def loss_and_grads(params, cfg, batch, *, use_kernel=True):
    """(loss, metrics, grads): ``lm_loss`` and its gradient in every param,
    a tree of the params' structure and dtypes, by autograd. A param the
    loss does not reach (an expert no token chose) gets zeros, as the
    reference's ``jax.grad`` gives it. ``params`` is not changed."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = lm_loss(leaves, cfg, batch, use_kernel=use_kernel)
        loss.backward()
    grads = tree_map(lambda t: torch.zeros_like(t) if t.grad is None else t.grad, leaves)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg, lr_schedule, *, clip_norm: float = 1.0):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: ``loss_and_grads``, the gradient's global norm clipped to
    ``clip_norm``, then AdamW at ``lr_schedule(opt_state.step)``. Returns
    new trees; the ones given are not changed. ``metrics`` holds "loss",
    "xent", "aux", "grad_norm" (before clipping) and "lr"."""

    def train_step(params, opt_state: AdamState, batch):
        loss, metrics, grads = loss_and_grads(params, cfg, batch)
        grads, gnorm = global_norm_clip(grads, clip_norm)
        lr = lr_schedule(opt_state.step)
        new_params, new_state = adamw_update(grads, opt_state, params, lr)
        return new_params, new_state, dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)

    return train_step


def init_train_state(generator: torch.Generator, cfg, state_dtype=torch.float32,
                     device=None):
    """(params, AdamW state with its moments in ``state_dtype``)."""
    params = init_lm(generator, cfg, device)
    return params, adamw_init(params, state_dtype)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _init_block_state(cfg, kind, batch, max_len, device):
    if kind == "rwkv":
        return rwkv.rwkv_init_state(cfg, batch, device)
    if kind == "rec":
        return griffin.rglru_init_state(cfg, batch, device)
    return init_kv_cache(cfg, batch, max_len, device)


def init_decode_state(params, cfg, batch: int, max_len: int, *, enc_out=None) -> dict:
    """Zero-initialised decode state (pre-prefill), on the params' device.
    With an encoder and ``enc_out`` (B, Se, d), also each unit's cross K/V
    (``"cross"``: a list of {"xk", "xv"}, each (B, Se, Hkv, hd))."""
    check_supported(cfg)
    dev = params["embed"].device

    def one_unit(pattern):
        return {f"b{i}": _init_block_state(cfg, kind, batch, max_len, dev)
                for i, kind in enumerate(pattern)}

    state = {"units": [one_unit(cfg.block_pattern) for _ in range(cfg.n_units)]}
    if cfg.remainder_pattern:
        state["rem"] = one_unit(cfg.remainder_pattern)
    if cfg.n_encoder_layers and enc_out is not None:
        B, Se = enc_out.shape[:2]
        shape = (B, Se, cfg.n_kv_heads, cfg.resolved_head_dim)
        state["cross"] = [{"xk": (enc_out @ up["b0"]["xattn"]["wk"]).reshape(shape),
                           "xv": (enc_out @ up["b0"]["xattn"]["wv"]).reshape(shape)}
                          for up in params["units"]]
    return state


def apply_block_decode(bp, cfg, kind, x, st, pos, cross=None):
    """One block of the decode step; a ``dec`` block also attends to its
    unit's ``cross`` K/V."""
    if kind == "rwkv":
        return rwkv.rwkv_block_decode(bp, cfg, x, st)
    if kind == "rec":
        x, new = griffin.rglru_block_decode(bp["rec"], cfg, x, st)
    else:
        akind = "local" if kind == "local" else "causal"
        out, new = decode_attn(bp["attn"], cfg, x, st, pos, kind=akind)
        x = x + out
        if kind == "dec" and cross is not None:
            x = x + decode_attn(bp["xattn"], cfg, x, st, pos,
                                cross_kv=(cross["xk"], cross["xv"]))[0]
    return _apply_ffn(bp["ffn"], cfg, x)[0], new


def decode_step(params, cfg, state, tokens, pos: int):
    """One decode step. tokens (B, 1) int; pos the position of the token
    (counting the image tokens; learned positions take ``pos_emb[pos]``).

    Returns (logits (B, 1, V), new_state); the KV caches of ``state`` are
    updated in place and shared with the new state, as are its cross
    K/V."""
    h = params["embed"][tokens]
    if cfg.pos_embedding == "learned":
        h = h + params["pos_emb"][pos][None, None]
    cross = state.get("cross", [None] * len(state["units"]))
    new_units = []
    for up, uc, xc in zip(params["units"], state["units"], cross):
        new_uc = {}
        for i, kind in enumerate(cfg.block_pattern):
            h, new_uc[f"b{i}"] = apply_block_decode(up[f"b{i}"], cfg, kind, h,
                                                    uc[f"b{i}"], pos, cross=xc)
        new_units.append(new_uc)
    new_state = dict(state, units=new_units)
    if cfg.remainder_pattern:
        new_rem = {}
        for i, kind in enumerate(cfg.remainder_pattern):
            h, new_rem[f"b{i}"] = apply_block_decode(
                params["rem"][f"b{i}"], cfg, kind, h, state["rem"][f"b{i}"], pos)
        new_state["rem"] = new_rem
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return h @ _lm_head(params, cfg), new_state


def lm_prefill(params, cfg, tokens, max_len: int, *, image_embeds=None, enc_frames=None,
               use_kernel=True):
    """Run the full prompt (after its image tokens, with the encoder over
    ``enc_frames``), returning (last-token logits (B, V), decode state with
    the K/V of all S_total positions written into ``max_len`` caches and,
    with an encoder, the cross K/V)."""
    h, _aux, unit_states, rem_states, enc_out = _forward_hidden(
        params, cfg, tokens, image_embeds=image_embeds, enc_frames=enc_frames,
        collect_state=True, use_kernel=use_kernel)
    last_logits = h[:, -1] @ _lm_head(params, cfg)
    B, S = h.shape[:2]
    state = init_decode_state(params, cfg, B, max_len, enc_out=enc_out)

    def write_unit(init_st, got_st):
        out = {}
        for bkey, st in got_st.items():
            ini = init_st[bkey]
            if "k" in st:   # KV cache: the prompt's (B, S, Hkv, hd) into (B, max_len, ...)
                ini["k"][:, :S] = st["k"]
                ini["v"][:, :S] = st["v"]
                out[bkey] = ini
            else:
                out[bkey] = st
        return out

    state["units"] = [write_unit(i, g) for i, g in zip(state["units"], unit_states)]
    if cfg.remainder_pattern:
        state["rem"] = write_unit(state["rem"], rem_states)
    return last_logits, state


# ---------------------------------------------------------------------------
# serve step
# ---------------------------------------------------------------------------

def make_serve_step(cfg):
    """One-token decode step against a KV cache."""

    def serve_step(params, state, tokens, pos):
        return decode_step(params, cfg, state, tokens, pos)

    return serve_step
