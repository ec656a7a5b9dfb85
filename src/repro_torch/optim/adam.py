"""AdamW and SGD on a dict of tensors — a hand port of ``repro/optim/adam.py``.

Not ``torch.optim.AdamW``: the decay sits inside the lr product,
``p - lr·(m̂/(√v̂+ε) + wd·p)``, with wd 0.001, as in the reference. The
moments are fp32 and the update is done without autograd. The step count
is a host integer (the LocalUpdate re-initialises the state on every call,
so it never leaves the host).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.utils.tree import tree_map


class AdamState(NamedTuple):
    step: int                     # steps taken
    mu: dict                      # first moment, one fp32 tensor per param
    nu: dict                      # second moment


def adamw_init(params: dict) -> AdamState:
    return AdamState(
        step=0,
        mu={k: torch.zeros_like(v, dtype=torch.float32) for k, v in params.items()},
        nu={k: torch.zeros_like(v, dtype=torch.float32) for k, v in params.items()},
    )


@torch.no_grad()
def adamw_update(grads: dict, state: AdamState, params: dict, lr: float, *,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.001) -> tuple[dict, AdamState]:
    """One AdamW step. Returns (new_params, new_state); nothing is updated
    in place. Math in fp32."""
    step = state.step + 1
    # the bias corrections in fp32, as the reference computes them (in
    # float64 1 - 0.999 differs from fp32's by 1.3e-5 relative)
    one, t = np.float32(1.0), np.float32(step)
    b1c = float(one - np.float32(b1) ** t)
    b2c = float(one - np.float32(b2) ** t)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g32 = grads[k].to(torch.float32)
        m32 = state.mu[k] * b1 + g32 * (1.0 - b1)
        v32 = state.nu[k] * b2 + torch.square(g32) * (1.0 - b2)
        mhat = m32 / b1c
        vhat = v32 / b2c
        p32 = p.detach().to(torch.float32)
        new_p[k] = (p32 - lr * (mhat / (torch.sqrt(vhat) + eps)
                                + weight_decay * p32)).to(p.dtype)
        new_m[k], new_v[k] = m32, v32
    return new_p, AdamState(step=step, mu=new_m, nu=new_v)


@torch.no_grad()
def sgd_update(grads, params, lr):
    """Plain SGD step (the paper's client-side update, Algorithm 1 line
    18) over a tree of params: ``p - lr·g`` in fp32, cast back to each
    param's dtype."""
    return tree_map(
        lambda p, g: (p.detach().to(torch.float32) - lr * g.to(torch.float32)).to(p.dtype),
        params, grads)
