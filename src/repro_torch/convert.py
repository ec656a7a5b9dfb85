"""Carry weights between numpy and the port's tensors.

GCN: the keys are the reference's (``w_self{l}``, ``w_nbr{l}``, ``b{l}``,
``w_cls``, ``b_cls``), so the reference's params, passed through
``np.asarray``, load into the port unchanged, and back.

LM: the reference stacks each repeated unit on a leading axis (``units``,
of length ``cfg.n_units``, and whisper's ``enc_units``, of length
``cfg.n_encoder_layers``); the port keeps a list of per-unit dicts.
``lm_params_from_numpy`` unstacks, ``lm_params_to_numpy`` stacks back. The
same two carry a decode state, which has the same layout (its ``cross``,
the per-unit cross K/V, stacked like ``units``). The other keys
(``embed``, ``rem``, ``final_norm``, ``lm_head``, ``pos_emb``,
``enc_norm``, ``enc_pos``; a tied head has no key of its own) map one to
one. Every block kind's tree maps leaf
by leaf: a ``rec`` block's ``{"rec": ..., "ffn": ...}``, an MoE FFN's
expert stacks (E, d_in, d_out). A leaf keeps its dtype: ``lam``, ``b_a``,
``b_i`` and ``router`` are fp32 in a bf16 model, as in the reference, and
bf16 leaves carry their bits, so the round trip is bit-equal.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def params_from_numpy(tree: dict, device=None) -> dict[str, torch.Tensor]:
    """``{name: array}`` -> ``{name: fp32 tensor on device}`` (copies;
    ``device=None`` is ``cuda:0``)."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(v, np.float32), device=dev)
            for k, v in tree.items()}


def params_to_numpy(params: dict) -> dict[str, np.ndarray]:
    """The inverse of ``params_from_numpy``."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def _tensor(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # numpy has no bf16 of its own: carry the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


# stacked on a leading axis in the reference, lists in the port
_STACKED = ("units", "enc_units", "cross")


def _n_stacked(key: str, cfg) -> int:
    return cfg.n_encoder_layers if key == "enc_units" else cfg.n_units


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def lm_params_from_numpy(tree: dict, cfg, device=None) -> dict:
    """The reference's ``init_lm`` params (or decode state), leaves passed
    through ``np.asarray``, -> the port's layout on ``device`` (copies;
    ``None`` is ``cuda:0``). bf16 leaves keep their bits."""
    dev = resolve_device(device)
    out = {}
    for key, sub in tree.items():
        if key in _STACKED:
            out[key] = [_map(sub, lambda a, u=u: _tensor(np.asarray(a)[u], dev))
                        for u in range(_n_stacked(key, cfg))]
        else:
            out[key] = _map(sub, lambda a: _tensor(a, dev))
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def lm_params_to_numpy(params: dict) -> dict:
    """The port's LM params (or decode state) -> the reference's layout as
    numpy, the units stacked on a leading axis again. bf16 leaves come back
    as fp32 (numpy has no bf16)."""
    out = {}
    for key, sub in params.items():
        if key in _STACKED:
            per_unit = [_map(u, _numpy) for u in sub]
            out[key] = _stack(per_unit)
        else:
            out[key] = _map(sub, _numpy)
    return out


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)
