"""Explicit device choice for the port's entry points.

There is no "CUDA if available, else CPU": a caller that names no device
gets ``cuda:0`` or an error, so a run on a machine without a card never
passes quietly as a run on the card. The CPU is used only when the caller
asks for it (``device="cpu"``), as the CPU tests do.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda:0``; a CUDA device without CUDA raises
    ``RuntimeError``; ``"cpu"`` is returned as asked."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested (the default) but CUDA is not "
                "available; pass device='cpu' to run the plain versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda[:i]' or 'cpu'")
    return dev
