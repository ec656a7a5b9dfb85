"""Carry GCN weights between numpy and the port's tensors.

The keys are the reference's (``w_self{l}``, ``w_nbr{l}``, ``b{l}``,
``w_cls``, ``b_cls``), so the reference's params, passed through
``np.asarray``, load into the port unchanged, and back.
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
