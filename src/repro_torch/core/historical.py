"""Historical embedding store (paper Eq. 6) — device-resident tables.

Port of ``repro/core/historical.py``. Per client: layer-0 ghost features
(synced cross-client raw inputs) and a layer-1 table over [own | ghost]
rows. In-batch rows are refreshed by the client itself after each local
step ("push"); ghost rows refresh only at synchronization epochs ("pull"
from the owners' round-start tables). Every function here returns new
tensors and leaves its inputs as they were.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class HistoricalState(NamedTuple):
    ghost_feat: torch.Tensor   # (K, g_max, F)   layer-0 cross-client features
    hist1: torch.Tensor        # (K, n_max + g_max, H1)
    age: torch.Tensor          # (K, n_max + g_max) int32 epochs since refresh


def init_historical(n_clients: int, n_max: int, g_max: int, n_feat: int, h1: int,
                    device: torch.device) -> HistoricalState:
    return HistoricalState(
        ghost_feat=torch.zeros((n_clients, g_max, n_feat), dtype=torch.float32,
                               device=device),
        hist1=torch.zeros((n_clients, n_max + g_max, h1), dtype=torch.float32,
                          device=device),
        age=torch.zeros((n_clients, n_max + g_max), dtype=torch.int32, device=device),
    )


def push_embeddings(hist1: torch.Tensor, age: torch.Tensor, batch_idx: torch.Tensor,
                    values: torch.Tensor, valid: torch.Tensor):
    """Client-side push of freshly computed in-batch embeddings (one client).

    hist1 (n_tot, H1); batch_idx (b,) distinct rows; values (b, H1); valid
    (b,) bool. Every row ages by one epoch, the pushed rows restart at 0.
    """
    vals = torch.where(valid[:, None], values, hist1[batch_idx])
    hist1 = hist1.index_put((batch_idx,), vals)
    age = (age + 1).index_put((batch_idx,), torch.where(valid, 0, age[batch_idx] + 1))
    return hist1, age


def pull_ghosts(hist1_all: torch.Tensor, feats_all: torch.Tensor,
                ghost_owner: torch.Tensor, ghost_row: torch.Tensor,
                ghost_mask: torch.Tensor):
    """Cross-client embedding synchronization for one client: the owners'
    layer-0 features and current layer-1 embeddings for every ghost, from
    the (K, n_max, F) / (K, n_tot, H1) round-start snapshots. Returns
    (ghost_feat (g, F), ghost_h1 (g, H1)), masked slots 0."""
    owner = torch.clamp(ghost_owner, min=0).long()
    row = ghost_row.long()
    gf = feats_all[owner, row] * ghost_mask[:, None]
    gh = hist1_all[owner, row] * ghost_mask[:, None]
    return gf, gh


def pull_ghosts_prefetched(ghost_src_feat: torch.Tensor, ghost_src_h1: torch.Tensor,
                           ghost_mask: torch.Tensor):
    """``pull_ghosts`` from sources the caller gathered already: for slots
    with ``ghost_mask > 0`` the same rows, masked slots 0."""
    return ghost_src_feat * ghost_mask[:, None], ghost_src_h1 * ghost_mask[:, None]


def staleness_metrics(age: torch.Tensor, node_mask: torch.Tensor) -> dict:
    m = node_mask > 0
    a = torch.where(m, age, 0)
    return {"mean_age": a.sum() / torch.clamp(m.sum(), min=1), "max_age": a.max()}
