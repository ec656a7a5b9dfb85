"""The plain version of the ghost pull kernel: the LocalUpdate's tau-gated
sync as the gather and mask of ``core.historical.pull_ghosts`` and the
select of ``merge_pulled`` (``torch.where``, ``torch.cat``), which
``ops.ghost_pull`` runs off CUDA and which the tests and ``chip_smoke.py``
hold the kernel against."""
from __future__ import annotations

import torch

from repro_torch.core.historical import merge_pulled, pull_ghosts


def ghost_pull_ref(feats_all: torch.Tensor, hist1_all: torch.Tensor,
                   ghost_owner: torch.Tensor, ghost_row: torch.Tensor,
                   ghost_mask: torch.Tensor, need: torch.Tensor, ghost_feat: torch.Tensor,
                   hist1: torch.Tensor, n_max: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(new ghost_feat, new hist1): the slots with ``need > 0`` take the
    owners' masked rows, the others keep theirs."""
    gf, gh = pull_ghosts(hist1_all, feats_all, ghost_owner, ghost_row, ghost_mask)
    return merge_pulled(need, gf, gh, ghost_feat, hist1, n_max)
