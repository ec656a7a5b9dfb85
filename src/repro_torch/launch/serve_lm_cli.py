"""Batched LM serving: prefill a batch of prompts, then greedy decode
against the KV cache / recurrent state (port of
``repro/launch/serve_lm_cli.py``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.serve_lm_cli --arch mini \\
        --batch 4 --prompt-len 64 --gen 32 [--device cpu]

``--arch`` is ``mini`` or any registered architecture (its smoke
configuration). As in the reference, whisper-large-v3's encoder runs over
zero frame embeddings (B, ``encoder_seq_len``, d) and internvl2-2b's
prompt follows zero image embeddings (B, ``n_image_tokens``, d); the
decode positions count the image tokens. The prefill runs the Hopper
kernels (WKV6 in ``rwkv`` blocks, flash attention in ``attn``/``local``/
``enc`` blocks and twice in ``dec`` blocks, self and cross; ``rec`` blocks
and MoE FFNs are plain PyTorch); the decode is plain PyTorch. The device is
``cuda:0`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import list_archs
from repro_torch.device import resolve_device
from repro_torch.launch.train import get_train_config
from repro_torch.models import lm


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(args, cfg=None) -> dict:
    """Prefill ``args.batch`` random prompts of ``args.prompt_len`` tokens
    and decode ``args.gen`` tokens greedily, with weights and prompts drawn
    from ``args.seed`` on the device. ``cfg`` defaults to
    ``get_train_config(args.arch)`` (the smoke configuration, or ``mini``);
    pass a resolved one to serve a full-width model.

    Returns ``prefill_s``, ``decode_tok_s`` and ``tokens`` (B, gen), as the
    reference's ``serve`` does."""
    cfg = cfg or get_train_config(args.arch)
    dev = resolve_device(getattr(args, "device", None))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = lm.init_lm(gen, cfg, dev)
    B, P, G = args.batch, args.prompt_len, args.gen
    n_img = cfg.n_image_tokens or 0
    max_len = P + G + n_img
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device=dev)
    kw = {}
    if n_img:
        kw["image_embeds"] = torch.zeros((B, n_img, cfg.d_model), dtype=cfg.torch_dtype,
                                         device=dev)
    if cfg.n_encoder_layers:
        kw["enc_frames"] = torch.zeros((B, cfg.encoder_seq_len, cfg.d_model),
                                       dtype=cfg.torch_dtype, device=dev)

    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        last_logits, state = lm.lm_prefill(params, cfg, prompts, max_len, **kw)
        _sync(dev)
        prefill_s = time.perf_counter() - t0

        tok = last_logits.argmax(-1)[:, None]
        generated = [tok]
        t0 = time.perf_counter()
        for i in range(G - 1):
            logits, state = lm.decode_step(params, cfg, state, tok, P + n_img + i)
            tok = logits[:, -1].argmax(-1)[:, None]
            generated.append(tok)
        _sync(dev)
        decode_s = time.perf_counter() - t0

    tok_per_s = B * (G - 1) / max(decode_s, 1e-9)
    print(f"arch={cfg.arch_id} batch={B} prompt={P} gen={G} device={dev}")
    print(f"prefill: {prefill_s*1e3:.1f} ms   decode: {tok_per_s:,.0f} tok/s "
          f"({decode_s/max(G-1,1)*1e3:.2f} ms/step)")
    return {
        "prefill_s": prefill_s,
        "decode_tok_s": tok_per_s,
        "tokens": torch.cat(generated, dim=1),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mini", choices=["mini", *list_archs()])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    serve(args)


if __name__ == "__main__":
    main()
