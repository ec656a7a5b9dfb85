"""Explicit device choice for the port's entry points.

There is no "CUDA if available, else CPU": a caller that names no device
gets ``cuda:0`` or an error, so a run on a machine without a card never
passes quietly as a run on the card. The CPU is used only when the caller
asks for it (``device="cpu"``), as the CPU tests do.

The dry run (``launch.dryrun``) builds models on ``"meta"`` tensors: shapes
and dtypes without storage, on which nothing computes. Only the callers
that build such shapes accept it (``allow_meta=True``); ``MetaGenerator``
is the generator their draws take.
"""
from __future__ import annotations

import torch


class MetaGenerator(torch.Generator):
    """A generator whose ``device`` is ``meta``: the initialisers draw on
    their generator's device, so with this one they make meta tensors (a
    CPU generator's state is all it holds; a draw on meta consumes none)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def resolve_device(device: str | torch.device | None = None, *,
                   allow_meta: bool = False) -> torch.device:
    """``None`` -> ``cuda:0``; a CUDA device without CUDA raises
    ``RuntimeError``; ``"cpu"`` is returned as asked, and ``"meta"`` too
    where the caller allows it."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "meta" and allow_meta:
        return dev
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
