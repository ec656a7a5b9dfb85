"""FedAIS core: the paper's contribution as plain PyTorch functions.

    importance.py   adaptive importance-based sampling       (Eq. 7-8)
    historical.py   historical embedding store + staleness   (Eq. 6)
    sync.py         adaptive embedding synchronization       (Eq. 9-11)
    variance.py     variance decomposition diagnostics       (Eq. 3-5, Thm. 1)
    fedais.py       Algorithm 1 — the composed trainer
"""
from repro_torch.core.historical import (
    HistoricalState,
    init_historical,
    push_embeddings,
    staleness_metrics,
)
from repro_torch.core.importance import importance_probs, loss_delta_scores, sample_batch
from repro_torch.core.sync import adaptive_tau, delay_model, tau_theoretical

__all__ = [
    "importance_probs",
    "loss_delta_scores",
    "sample_batch",
    "adaptive_tau",
    "delay_model",
    "tau_theoretical",
    "HistoricalState",
    "init_historical",
    "push_embeddings",
    "staleness_metrics",
]
