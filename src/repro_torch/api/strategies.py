"""Method strategies: the per-method round hooks.

Port of ``repro/api/strategies.py``. A MethodStrategy owns all
method-specific mutable state (FedSage+'s generator parameters, FedGraph's
bandit tables) and exposes four round hooks plus two cost hooks, so the
FedEngine round loop and the PaperCostModel stay branch-free. New methods
subclass MethodStrategy and register a kind with ``register_strategy_kind``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.federated import baselines as B
from repro_torch.federated.costs import model_bytes


class MethodStrategy:
    """Default (plain) strategy: fixed fanout, no extra state or cost."""

    def __init__(self, mcfg):
        self.mcfg = mcfg

    def setup(self, engine, state) -> None:
        """Allocate method-specific state before round 0."""

    def choose_fanouts(self, engine, sel: np.ndarray) -> np.ndarray:
        """Per-selected-client neighbor fanout for this round (host ints)."""
        return np.full((len(sel),), self.mcfg.neighbor_fanout, np.int32)

    def pre_round(self, engine, state, sel: np.ndarray) -> None:
        """Before the cohort's LocalUpdate."""

    def post_round(self, engine, state, sel: np.ndarray, stats: dict) -> None:
        """After the merge; ``stats`` are host arrays."""

    # ---- cost hooks (consumed by PaperCostModel) ----

    def round_model_bytes(self, engine) -> float:
        """Extra per-client model-channel bytes (rides the up/down-link)."""
        return 0.0

    def extra_flops(self, engine, client_size):
        """Extra per-client compute on top of the GCN fwd+bwd; elementwise
        in ``client_size`` (a scalar or the cohort's int array)."""
        return 0.0


class GeneratorStrategy(MethodStrategy):
    """FedSage+ lite: a locally trained generator imputes ghost features, so
    no embedding sync happens; generator params ride the model link.

    Its training context reproduces the reference's: the stacked
    ``features`` are flattened to (K·n_max, F) but indexed with each
    client's *local* neighbour ids masked to ``< n_max``, so every client's
    context is built from client 0's rows at those ids (ROADMAP C4, held on
    purpose). The context depends only on the static client arrays, so it
    is computed once, outside autograd, and kept."""

    def setup(self, engine, state):
        dev = engine.device
        self.gen_params = B.generator_init(
            torch.Generator().manual_seed(engine.seed + 2), engine.F, device=dev)
        rev, rev_mask = B.ghost_reverse_map(engine.fed)
        self.rev = torch.from_numpy(rev).to(dev)
        self.rev_mask = torch.from_numpy(rev_mask).to(dev)
        self._ctx = None

    def pre_round(self, engine, state, sel):
        arrays = state.arrays
        K, n_max, F = engine.fed.n_clients, engine.fed.n_max, engine.F
        feats = arrays["features"].reshape(K * n_max, F)
        node_mask = arrays["node_mask"].reshape(K * n_max)
        if self._ctx is None:
            idx = arrays["nbr_idx"].reshape(K * n_max, -1)
            mask = arrays["nbr_mask"].reshape(K * n_max, -1) * (idx < n_max)
            self._ctx = B.generator_context(feats, torch.clamp(idx, max=n_max * K - 1), mask)
        self.gen_params, _gen_loss = B.generator_train_step(
            self.gen_params, feats, None, None, node_mask, ctx=self._ctx)
        imputed = B.generator_impute(self.gen_params, arrays["features"], self.rev,
                                     self.rev_mask, arrays["ghost_mask"])
        state.hist = state.hist._replace(ghost_feat=imputed)

    def round_model_bytes(self, engine):
        return 2 * model_bytes(B.generator_param_count(engine.F))

    def extra_flops(self, engine, client_size):
        return 6.0 * engine.F * 64 * client_size


class BanditStrategy(MethodStrategy):
    """FedGraph lite: per-client epsilon-greedy bandit over fanout actions,
    rewarded by the round-over-round local-loss improvement.

    Rewards are attributed in dispatch order. An async merge restacks its
    buffer by (dispatch version, cohort position), so a client merged twice
    rewards oldest -> freshest; a straggler that arrives in a later merge
    than a fresher update from the same client is skipped (its improvement
    would be measured against a loss the bandit already moved past).
    ``state.last_staleness`` carries the merge's per-update staleness (None
    on the sync path, where the skip can never fire)."""

    def setup(self, engine, state):
        self.bandit = B.FanoutBandit(engine.fed.n_clients, seed=engine.seed)
        self.last_client_loss = np.zeros(engine.fed.n_clients)
        # dispatch version of each client's last rewarded update
        self.last_reward_version = np.full(engine.fed.n_clients, -1, np.int64)

    def choose_fanouts(self, engine, sel):
        return np.asarray([self.bandit.choose(int(k)) for k in sel], np.int32)

    def post_round(self, engine, state, sel, stats):
        mean_losses = np.asarray(stats["epoch_losses"]).mean(axis=1)
        staleness = state.last_staleness
        if staleness is None:               # sync: every update is this round's
            versions = np.full(len(sel), state.round, np.int64)
        else:
            versions = state.round - np.asarray(staleness, np.int64)
        for i, k in enumerate(sel):
            v = int(versions[i])
            if v < self.last_reward_version[k]:
                continue    # stale straggler ordered after a fresher update
            reward = (self.last_client_loss[k] - float(mean_losses[i])
                      if self.last_client_loss[k] else 0.0)
            self.bandit.update(int(k), reward)
            self.last_client_loss[k] = float(mean_losses[i])
            self.last_reward_version[k] = v


STRATEGY_KINDS: dict[str, type] = {
    "plain": MethodStrategy,
    "generator": GeneratorStrategy,
    "bandit": BanditStrategy,
}


def register_strategy_kind(kind: str, cls: type, *, overwrite: bool = False) -> type:
    """Register a MethodStrategy subclass under a string kind (idempotent
    for the same class; raises on silent overwrite unless ``overwrite``)."""
    existing = STRATEGY_KINDS.get(kind)
    if existing is not None and existing is not cls and not overwrite:
        raise KeyError(f"strategy kind {kind!r} already registered to {existing!r}")
    STRATEGY_KINDS[kind] = cls
    return cls


def strategy_kind_for(mcfg) -> str:
    """The explicit ``mcfg.strategy`` wins; ``'auto'`` infers from the
    feature flags."""
    kind = getattr(mcfg, "strategy", "auto") or "auto"
    if kind != "auto":
        return kind
    if mcfg.use_generator:
        return "generator"
    if mcfg.bandit_fanout:
        return "bandit"
    return "plain"


def build_strategy(mcfg) -> MethodStrategy:
    kind = strategy_kind_for(mcfg)
    try:
        cls = STRATEGY_KINDS[kind]
    except KeyError:
        raise KeyError(
            f"unknown strategy kind {kind!r}; known: {sorted(STRATEGY_KINDS)}"
        ) from None
    return cls(mcfg)
