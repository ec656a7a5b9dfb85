"""The paper's five comparison baselines + FedAIS ablations as MethodConfigs.

Port of ``repro/federated/baselines.py``. All methods share the same
LocalUpdate (``core/fedais.py``) with feature toggles:

    FedAll     all local samples, random neighbor selection, sync every epoch
    FedRandom  random sample batches + random neighbors, sync every epoch
    FedSage+   all samples; ghost features *generated* locally (no embed sync,
               generator params ride the model up/down-link)  [lite variant]
    FedPNS     all samples, fixed periodic sync (tau = 2)
    FedGraph   all samples, bandit-learned neighbor fanout    [lite variant]
    FedLocal   within-client neighbors only (Fig. 1 reference)
    FedAIS1    importance sampling only (fixed tau)
    FedAIS2    all samples + adaptive sync only
    FedAIS     the full method

The generator's products are dense ``torch.matmul`` on the engine's
device; its neighbourhood means are summed one neighbour slot at a time,
so no (rows, slots, F) gather is ever materialised (at Pubmed's size that
gather would be 43,700 × 32 × 500 fp32). ``ghost_reverse_map`` and
``FanoutBandit`` are host numpy, bit-equal to the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fedais import MethodConfig
from repro_torch.device import resolve_device

FANOUT_ACTIONS = (2, 5, 10, 32)
GEN_PARAM_KEYS = ("w1", "b1", "w2", "b2")


def method_config(name: str, **overrides) -> MethodConfig:
    """Resolve a method name to its MethodConfig via the api registry."""
    from repro_torch.api.registry import method_config as registry_method_config

    return registry_method_config(name, **overrides)


ALL_BASELINES = ("fedall", "fedrandom", "fedsage+", "fedpns", "fedgraph")


# ---------------------------------------------------------------------------
# FedSage+ lite: local ghost-feature generator
# ---------------------------------------------------------------------------

def ghost_reverse_map(fed, max_rev: int = 8):
    """(K, g_max, R) own-rows adjacent to each ghost + mask — the structural
    context the generator conditions on."""
    K, n_max, D = fed.nbr_idx.shape
    g_max = fed.g_max
    rev = np.zeros((K, g_max, max_rev), np.int32)
    rev_mask = np.zeros((K, g_max, max_rev), np.float32)
    fill = np.zeros((K, g_max), np.int32)
    for k in range(K):
        rows, slots = np.where(fed.nbr_idx[k] >= n_max)
        for r, s_col in zip(rows, slots):
            if fed.nbr_mask[k, r, s_col] == 0:
                continue
            s = fed.nbr_idx[k, r, s_col] - n_max
            if fill[k, s] < max_rev:
                rev[k, s, fill[k, s]] = r
                rev_mask[k, s, fill[k, s]] = 1.0
                fill[k, s] += 1
    return rev, rev_mask


def generator_init(generator: torch.Generator, n_feat: int, hidden: int = 64,
                   device=None) -> dict:
    """Fresh generator params drawn from ``generator`` (the reference's
    shapes and scales; torch's draws, not jax's). ``device=None`` is
    ``cuda:0``."""
    dev = resolve_device(device)
    s1 = (2.0 / (n_feat + hidden)) ** 0.5
    s2 = (2.0 / (hidden + n_feat)) ** 0.5
    params = {
        "w1": torch.randn((n_feat, hidden), generator=generator) * s1,
        "b1": torch.zeros((hidden,)),
        "w2": torch.randn((hidden, n_feat), generator=generator) * s2,
        "b2": torch.zeros((n_feat,)),
    }
    return {k: v.to(dev) for k, v in params.items()}


def generator_apply(gp: dict, ctx: torch.Tensor) -> torch.Tensor:
    """Refine a neighborhood-mean context vector into a feature estimate."""
    h = torch.relu(ctx @ gp["w1"] + gp["b1"])
    return ctx + h @ gp["w2"] + gp["b2"]      # residual refinement


def _masked_mean(feats: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis of ``idx`` of the rows ``feats[..., idx, :]``
    with ``mask`` > 0, one slot at a time. feats (..., n, F), idx and mask
    (..., g, S) -> (..., g, F)."""
    idx = idx.long()
    acc = torch.zeros(idx.shape[:-1] + feats.shape[-1:], dtype=feats.dtype,
                      device=feats.device)
    for s in range(idx.shape[-1]):
        rows = idx[..., s, None].expand(*idx.shape[:-1], feats.shape[-1])
        acc = acc + torch.gather(feats, -2, rows) * mask[..., s, None]
    return acc / torch.clamp(mask.sum(-1, keepdim=True), min=1.0)


def generator_context(feats: torch.Tensor, nbr_idx: torch.Tensor,
                      nbr_mask: torch.Tensor) -> torch.Tensor:
    """(N, F) own-neighbourhood means, the generator's training input. It
    does not depend on the generator's params: compute it once, outside
    autograd."""
    n = feats.shape[0]
    own = nbr_mask * (nbr_idx < n)
    return _masked_mean(feats, torch.clamp(nbr_idx, max=n - 1), own)


def generator_loss(gp: dict, ctx: torch.Tensor, feats: torch.Tensor,
                   node_mask: torch.Tensor) -> torch.Tensor:
    pred = generator_apply(gp, ctx)
    err = torch.square(pred - feats).sum(-1) * node_mask
    return err.sum() / torch.clamp(node_mask.sum(), min=1.0)


def generator_train_step(gp: dict, feats, nbr_idx, nbr_mask, node_mask, lr=1e-2,
                         ctx: torch.Tensor | None = None):
    """Self-supervised: reconstruct own features from own neighborhood mean
    (exactly the task the generator performs for ghosts); one SGD step.
    ``ctx`` is ``generator_context(feats, nbr_idx, nbr_mask)`` when the
    caller has it already. Returns ``(new params, loss)``."""
    if ctx is None:
        ctx = generator_context(feats, nbr_idx, nbr_mask)
    p = {k: gp[k].detach().requires_grad_(True) for k in GEN_PARAM_KEYS}
    loss = generator_loss(p, ctx, feats, node_mask)
    grads = torch.autograd.grad(loss, [p[k] for k in GEN_PARAM_KEYS])
    new = {k: (gp[k] - lr * g).detach() for k, g in zip(GEN_PARAM_KEYS, grads)}
    return new, loss.detach()


@torch.no_grad()
def generator_impute(gp: dict, feats, rev, rev_mask, ghost_mask) -> torch.Tensor:
    """Predict ghost features from reverse-neighborhood means: one client
    (feats (n_max, F), rev (g_max, R)) or every client at once (a leading
    K axis on all four)."""
    ctx = _masked_mean(feats, rev, rev_mask)
    return generator_apply(gp, ctx) * ghost_mask[..., None]


def generator_param_count(n_feat: int, hidden: int = 64) -> int:
    return n_feat * hidden + hidden + hidden * n_feat + n_feat


# ---------------------------------------------------------------------------
# FedGraph lite: epsilon-greedy fanout bandit
# ---------------------------------------------------------------------------

class FanoutBandit:
    """Per-client epsilon-greedy bandit over neighbor-fanout actions; reward
    is the per-round local-loss improvement (the DRL policy of FedGraph
    collapsed to its decision variable)."""

    def __init__(self, n_clients: int, seed: int = 0, eps: float = 0.2):
        self.q = np.zeros((n_clients, len(FANOUT_ACTIONS)), np.float64)
        self.n = np.zeros((n_clients, len(FANOUT_ACTIONS)), np.int64)
        self.rng = np.random.default_rng(seed)
        self.eps = eps
        self.last_action = np.zeros(n_clients, np.int64)

    def choose(self, k: int) -> int:
        if self.rng.random() < self.eps or self.n[k].sum() == 0:
            a = self.rng.integers(len(FANOUT_ACTIONS))
        else:
            a = int(np.argmax(self.q[k]))
        self.last_action[k] = a
        return FANOUT_ACTIONS[a]

    def update(self, k: int, reward: float) -> None:
        a = self.last_action[k]
        self.n[k, a] += 1
        self.q[k, a] += (reward - self.q[k, a]) / self.n[k, a]
