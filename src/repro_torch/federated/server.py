"""FL server: client selection, FedAvg aggregation, global evaluation, and
the adaptive-tau update (Algorithm 1 lines 1-8).

Port of ``repro/federated/server.py``. The evaluation is also the eval path
served logits are held to.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sync import adaptive_tau
from repro_torch.device import resolve_device
from repro_torch.models.gcn import AGG_BACKENDS, gcn_full_forward, per_node_loss


def select_clients(rng: np.random.Generator, n_clients: int, m: int) -> np.ndarray:
    return rng.choice(n_clients, size=min(m, n_clients), replace=False)


def fedavg(stacked_params: dict) -> dict:
    """Mean over the leading (selected-client) axis — Algorithm 1 line 7."""
    return {k: v.mean(dim=0) for k, v in stacked_params.items()}


def fedavg_weighted(stacked_params: dict, weights: torch.Tensor) -> dict:
    w = weights / torch.clamp(weights.sum(), min=1e-12)
    return {k: (v * w.reshape((len(w),) + (1,) * (v.ndim - 1))).sum(dim=0)
            for k, v in stacked_params.items()}


def build_eval_graph(graph, max_deg: int = 32, seed: int = 0,
                     backend: str = "gather", device=None) -> dict:
    """Device tensors of the full graph for ``evaluate_global``.
    ``segment``/``spmm`` precompute their aggregation operands here (the
    bucketed CSR / the row-normalised (n, n) adjacency) so every layer
    reuses them. ``device=None`` is ``cuda:0``."""
    from repro_torch.graph.csr import build_padded_neighbors

    if backend not in AGG_BACKENDS:
        raise ValueError(f"unknown eval backend {backend!r}; known: {AGG_BACKENDS}")
    dev = resolve_device(device)
    idx, mask = build_padded_neighbors(graph.adjacency_lists(), max_deg, seed=seed)
    idx_t = torch.from_numpy(idx).to(dev)
    mask_t = torch.from_numpy(mask).to(dev)
    csr = adj = None
    if backend == "segment":
        from repro_torch.graph.csr import bucketed_csr_from_padded

        csr = bucketed_csr_from_padded(idx_t, mask_t)
    elif backend == "spmm":
        from repro_torch.kernels.spmm.ops import adjacency_from_neighbors

        adj = adjacency_from_neighbors(idx_t, mask_t, graph.n_nodes)
    return {
        "features": torch.from_numpy(graph.features).to(dev),
        "labels": graph.labels,
        "nbr_idx": idx_t,
        "nbr_mask": mask_t,
        "test_mask": graph.test_mask,
        "val_mask": graph.val_mask,
        "n_classes": graph.n_classes,
        "backend": backend,
        "csr": csr,
        "adj": adj,
    }


def eval_logits(params: dict, eval_graph: dict) -> torch.Tensor:
    """(n, C) logits of the full-graph forward on the eval graph's device."""
    return gcn_full_forward(params, eval_graph["features"],
                            eval_graph["nbr_idx"], eval_graph["nbr_mask"],
                            backend=eval_graph["backend"],
                            csr=eval_graph["csr"], adj=eval_graph["adj"])


def evaluate_global(params: dict, eval_graph: dict, split: str = "test") -> dict:
    logits = eval_logits(params, eval_graph)
    mask = np.asarray(eval_graph[f"{split}_mask"])
    labels = np.asarray(eval_graph["labels"])[mask]
    lg = logits.detach().cpu().numpy().astype(np.float32)[mask]
    nll = per_node_loss(torch.from_numpy(lg), torch.from_numpy(labels)).numpy()
    pred = lg.argmax(-1)
    acc = float((pred == labels).mean()) if len(labels) else 0.0
    return {
        "acc": acc,
        "loss": float(nll.mean()) if len(labels) else float("inf"),
        "f1": macro_f1(labels, pred, eval_graph["n_classes"]),
        "auc": macro_ovr_auc(labels, lg),
    }


def macro_f1(labels: np.ndarray, pred: np.ndarray, n_classes: int) -> float:
    f1s = []
    for c in range(n_classes):
        tp = float(((pred == c) & (labels == c)).sum())
        fp = float(((pred == c) & (labels != c)).sum())
        fn = float(((pred != c) & (labels == c)).sum())
        if tp + fp + fn == 0:
            continue
        f1s.append(2 * tp / max(2 * tp + fp + fn, 1e-12))
    return float(np.mean(f1s)) if f1s else 0.0


def macro_ovr_auc(labels: np.ndarray, logits: np.ndarray) -> float:
    """Macro one-vs-rest AUC via the rank statistic."""
    aucs = []
    for c in np.unique(labels):
        pos = logits[labels == c, c]
        neg = logits[labels != c, c]
        if len(pos) == 0 or len(neg) == 0:
            continue
        ranks = np.argsort(np.argsort(np.concatenate([pos, neg])))
        r_pos = ranks[: len(pos)].sum() + len(pos)  # 1-based
        auc = (r_pos - len(pos) * (len(pos) + 1) / 2) / (len(pos) * len(neg))
        aucs.append(auc)
    return float(np.mean(aucs)) if aucs else 0.5


def update_tau(mcfg, test_loss: float, initial_loss: float, tau0: int) -> int:
    """Algorithm 1 line 8: adaptive (Eq. 11) or fixed interval."""
    if mcfg.adaptive_sync:
        return adaptive_tau(test_loss, initial_loss, tau0)
    return tau0
