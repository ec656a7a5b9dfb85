"""Method strategies: the per-method round hooks.

Port of ``repro/api/strategies.py``. A MethodStrategy owns all
method-specific mutable state and exposes four round hooks plus two cost
hooks, so the FedEngine round loop and the PaperCostModel stay
branch-free. New methods subclass MethodStrategy and register a kind with
``register_strategy_kind``.

Ported: the plain strategy. The ``generator`` (FedSage+) and ``bandit``
(FedGraph) kinds are still to port (ROADMAP A2) and raise.
"""
from __future__ import annotations

import numpy as np

_NOT_PORTED = {"generator": "FedSage+'s GeneratorStrategy",
               "bandit": "FedGraph's BanditStrategy"}


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


STRATEGY_KINDS: dict[str, type] = {"plain": MethodStrategy}


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
    if kind not in STRATEGY_KINDS and kind in _NOT_PORTED:
        raise NotImplementedError(
            f"strategy kind {kind!r} ({_NOT_PORTED[kind]}) is not ported yet "
            "(ROADMAP A2)")
    try:
        cls = STRATEGY_KINDS[kind]
    except KeyError:
        raise KeyError(
            f"unknown strategy kind {kind!r}; known: {sorted(STRATEGY_KINDS)}"
        ) from None
    return cls(mcfg)
