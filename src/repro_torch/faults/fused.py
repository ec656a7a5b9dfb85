"""The fused executor's fault-aware merge: the masked merge of a round.

Port of ``repro/faults/fused.py::build_faulty_chunk``. Under a non-empty
``FaultPlan`` the fused round (``api.fused``) runs the same LocalUpdate on
the real cohort and then this merge instead of the aggregator's, with
three per-member inputs the host fills from the plan before the round:

* ``keep``    1.0 where the upload arrived, 0.0 where the plan dropped it;
* ``cmult``   the corruption multiplier (NaN / inf / corrupt_scale on the
  corrupted members, 1.0 elsewhere), applied to the uploaded params;
* ``weights`` the members' client sizes, for WeightedFedAvg.

The guard runs inside the round with no host read: a member fails it when
an element of its upload is not finite or, under ``max_norm``, its update's
L2 distance from the round-start params (in float64, as the stepwise guard
compares it) exceeds the ceiling. Arrived members that fail are counted into
``n_quarantined``, streamed out with the round's light stats.

The merge gives the stepwise survivor-subset merge's bits. The survivors
are moved to the front in cohort order and the other rows zeroed, so each
sum over the cohort axis adds the stepwise sum's terms in its order and
then exact zeros. FedAvg divides that sum by the survivor count (as
``federated.server.fedavg`` divides by its row count); WeightedFedAvg
normalises the survivors' weights (client sizes: integers, whose sum is
exact in any order) and sums. With no survivor the params carry over, the
server's no-op round. Members that were dropped or quarantined keep their
tables' rows as they were; ``sync_dtype`` round-trips the rows written.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.faults.plan import guard_stats
from repro_torch.federated.quant import check_sync_dtype, quant_roundtrip

__all__ = ["build_faulty_merge"]


def _bcast(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return v.reshape((v.shape[0],) + (1,) * (x.ndim - 1))


def build_faulty_merge(*, uses_weights: bool, finite_guard: bool = True,
                       max_norm: Optional[float] = None, sync_dtype: str = "fp32"):
    """The fault-aware merge of one fused round.

    ``uses_weights`` picks the merge to reproduce: WeightedFedAvg's
    normalise-then-sum when True, FedAvg's sum-then-divide when False.
    ``finite_guard=False`` (an engine built with ``guard=False``) admits
    every arrived upload, poison included. Returns ``merge(params, rows,
    out, tables, weights, keep, cmult) -> (new params, n_quarantined)``:
    ``tables`` (hist1, age, ghost_feat, prev_loss) are written in place at
    ``rows``; ``params`` is read only."""
    check_sync_dtype(sync_dtype)

    def merge(params: dict, rows: torch.Tensor, out, tables, weights: torch.Tensor,
              keep: torch.Tensor, cmult: torch.Tensor):
        new_params, new_hist1, new_age, new_ghost_feat, stats = out
        # corruption poisons the upload, not the client's own state
        new_params = {k: x * _bcast(cmult, x).to(x.dtype) for k, x in new_params.items()}
        arrived = keep > 0
        if finite_guard:
            ok, sumsq = guard_stats(new_params, params, norms=max_norm is not None)
            if max_norm is not None:
                ok = ok & (sumsq.to(torch.float64).sqrt() <= float(max_norm))
            alive = arrived & ok
            n_quar = (arrived & ~ok).sum()
        else:
            alive = arrived
            n_quar = torch.zeros((), dtype=torch.int64, device=keep.device)

        # survivors first, in cohort order; the other rows zeroed before any
        # product (NaN * 0 is NaN)
        order = torch.sort((~alive).to(torch.uint8), stable=True).indices
        live = alive[order]
        count = alive.sum()
        if uses_weights:
            wa = torch.where(live, weights[order], 0.0)
            wn = wa / torch.clamp(wa.sum(), min=1e-12)
            merged = {k: (torch.where(_bcast(live, x), x[order], 0.0)
                          * _bcast(wn, x)).sum(dim=0)
                      for k, x in new_params.items()}
        else:
            n = torch.clamp(count, min=1).to(torch.float32)
            merged = {k: torch.where(_bcast(live, x), x[order], 0.0).sum(dim=0) / n.to(x.dtype)
                      for k, x in new_params.items()}
        any_alive = count > 0
        merged = {k: torch.where(any_alive, v, params[k]) for k, v in merged.items()}

        loss_wb = stats["loss_all"]
        if sync_dtype != "fp32":
            new_hist1 = quant_roundtrip(new_hist1, sync_dtype)
            new_ghost_feat = quant_roundtrip(new_ghost_feat, sync_dtype)
            loss_wb = quant_roundtrip(loss_wb, sync_dtype)
        for table, new in zip(tables, (new_hist1, new_age, new_ghost_feat, loss_wb)):
            table[rows] = torch.where(_bcast(alive, new), new, table[rows])
        return merged, n_quar

    return merge
