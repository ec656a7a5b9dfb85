"""AdamW and SGD on a tree of tensors — a hand port of ``repro/optim/adam.py``.

Not ``torch.optim.AdamW``: the decay sits inside the lr product,
``p - lr·(m̂/(√v̂+ε) + wd·p)``, with wd 0.001, as in the reference. A tree
is a nest of dicts and lists (the GCN's flat dict, the LM's dicts and unit
lists). The moments are stored in ``state_dtype`` (fp32 by default; bf16
keeps large models' moments at half the bytes), the math is fp32 whatever
the storage types, as the reference's ``m32.astype(m.dtype)`` does, and
the update is done without autograd. The step count is a host integer (the
LocalUpdate re-initialises the state on every call, the LM train step
reads it for the lr schedule, so it never leaves the host). A leaf of more
than ``UPDATE_CHUNK`` elements is updated a slice of its elements at a
time: the update's fp32 temporaries, about ten leaf-sized ones, would hold
some 40 GB for gemma3-12b's tied embedding (1.0 B elements); each element
takes the same arithmetic either way, so the bits are the same.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.utils.tree import tree_map

PyTree = Any

UPDATE_CHUNK = 1 << 26   # elements of a leaf updated at once


class AdamState(NamedTuple):
    step: int                     # steps taken
    mu: PyTree                    # first moment, the params' tree in state_dtype
    nu: PyTree                    # second moment


def adamw_init(params: PyTree, state_dtype=torch.float32) -> AdamState:
    zeros = lambda p: torch.zeros_like(p, dtype=state_dtype)
    return AdamState(step=0, mu=tree_map(zeros, params), nu=tree_map(zeros, params))


@torch.no_grad()
def adamw_update(grads: PyTree, state: AdamState, params: PyTree, lr: float, *,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.001) -> tuple[PyTree, AdamState]:
    """One AdamW step. Returns (new_params, new_state); nothing is updated
    in place. Math in fp32."""
    step = state.step + 1
    # the bias corrections in fp32, as the reference computes them (in
    # float64 1 - 0.999 differs from fp32's by 1.3e-5 relative)
    one, t = np.float32(1.0), np.float32(step)
    b1c = float(one - np.float32(b1) ** t)
    b2c = float(one - np.float32(b2) ** t)

    def upd_all(g, m, v, p):
        g32 = g.to(torch.float32)
        m32 = m.to(torch.float32) * b1 + g32 * (1.0 - b1)
        v32 = v.to(torch.float32) * b2 + torch.square(g32) * (1.0 - b2)
        mhat = m32 / b1c
        vhat = v32 / b2c
        p32 = p.detach().to(torch.float32)
        newp = p32 - lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * p32)
        return newp.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

    def upd(g, m, v, p):
        if p.numel() <= UPDATE_CHUNK:
            return upd_all(g, m, v, p)
        outs = tuple(torch.empty(p.shape, dtype=t.dtype, device=t.device) for t in (p, m, v))
        flat_in = [t.reshape(-1) for t in (g, m, v, p.detach())]
        flat_out = [t.view(-1) for t in outs]
        for i in range(0, p.numel(), UPDATE_CHUNK):
            part = upd_all(*(t[i:i + UPDATE_CHUNK] for t in flat_in))
            for dst, src in zip(flat_out, part):
                dst[i:i + UPDATE_CHUNK].copy_(src)
        return outs

    out = tree_map(upd, grads, state.mu, state.nu, params)
    new_p, new_m, new_v = (tree_map(lambda p, o: o[i], params, out) for i in range(3))
    return new_p, AdamState(step=step, mu=new_m, nu=new_v)


@torch.no_grad()
def sgd_update(grads, params, lr):
    """Plain SGD step (the paper's client-side update, Algorithm 1 line
    18) over a tree of params: ``p - lr·g`` in fp32, cast back to each
    param's dtype."""
    return tree_map(
        lambda p, g: (p.detach().to(torch.float32) - lr * g.to(torch.float32)).to(p.dtype),
        params, grads)
