"""FedAIS Algorithm 1 — the client LocalUpdate and its method-space.

Port of ``repro/core/fedais.py``. One ``MethodConfig`` describes every
method in the paper (FedAIS, its ablations and the baselines) as feature
toggles over the same LocalUpdate.

``make_local_update`` returns the LocalUpdate of ONE client: a loss pass
and the selection probabilities (Eq. 7-8), then J local epochs of an
importance-sampled batch, a fanout subsample, a ghost pull every tau
epochs, a GraphSAGE forward/backward over historical embeddings (Eq. 6),
an AdamW step and a push of the fresh embeddings. ``make_cohort_update``
runs it for each client of a cohort in turn and stacks the outputs on a
leading axis, as the reference's vmap over ``VMAP_IN_AXES`` gives. A client
reads only the round-start snapshots and its own slice of the tables and
writes only its own slot of the outputs, so the clients' order changes
nothing.

Where the reference traces, the port branches on the host: the sync gate
``(epoch_offset + j) % tau == 0`` depends only on host integers, so only
the side taken runs; nothing is read back from the device inside the epoch
loop. Randomness comes from a draw provider (``TorchDraws`` on the device
in production; the tests pass one that replays the reference's key chain),
so the discrete decisions are exact against the reference given the same
uniforms.

Still to port: ``ghost_source="prefetched"`` (the pod-sharded executor,
ROADMAP A7) and a quantized ghost pull (``sync_dtype``, A3).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.historical import pull_ghosts, push_embeddings
from repro_torch.core.importance import (
    importance_probs,
    loss_delta_scores,
    sample_batch,
    stable_rank,
    uniform_probs,
)
from repro_torch.models.gcn import AGG_BACKENDS, gcn_batch_forward, per_node_loss
from repro_torch.optim import adamw_init, adamw_update


@dataclass(frozen=True)
class MethodConfig:
    name: str = "fedais"
    importance_sampling: bool = True     # FedAIS / FedAIS1 (off: uniform/all)
    adaptive_sync: bool = True           # FedAIS / FedAIS2 (off: fixed tau)
    use_all_samples: bool = False        # FedAll/FedPNS/FedGraph/FedSage+/FedAIS2
    sample_ratio: float = 0.7            # r: fraction of local nodes per epoch
    neighbor_fanout: int = 10            # max sampled neighbors per node
    tau0: int = 2                        # initial / fixed sync interval
    local_epochs: int = 4                # J
    lr: float = 0.01
    use_generator: bool = False          # FedSage+: impute ghosts, no sync
    bandit_fanout: bool = False          # FedGraph-lite: learned fanout
    use_ghosts: bool = True              # FedLocal ablation: ignore cross-client
    batch_cap: int = 256                 # padded batch size upper bound
    # api resolution hooks (string keys into the api registries):
    strategy: str = "auto"               # method-strategy kind; "auto" infers
    aggregator: str = "fedavg"           # server aggregation ("fedavg"|"weighted")
    scheduler: str = "sync"              # round scheduling


def batch_size_for(mcfg: MethodConfig, n_max: int) -> int:
    if mcfg.use_all_samples:
        return n_max
    return max(1, min(mcfg.batch_cap, int(round(n_max * mcfg.sample_ratio))))


class TorchDraws:
    """The production draw provider: one ``torch.Generator`` on the device,
    seeded from ``seed``. The cohort's clients draw from it in turn, so a
    seed fixes every draw of a run.

    A draw provider has ``clients(m)`` (one stream per cohort member, taken
    once per round); a stream has ``epoch()`` (once per local epoch), whose
    result gives ``batch_uniform(shape)`` (in [1e-20, 1), the Gumbel draws
    of ``sample_batch``) and ``fanout_uniform(shape)`` (in [0, 1), the
    fanout ranks)."""

    def __init__(self, seed: int, device: torch.device):
        self.device = device
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)

    def clients(self, m: int) -> list:
        return [self] * m

    def epoch(self) -> "TorchDraws":
        return self

    def batch_uniform(self, shape) -> torch.Tensor:
        u = torch.rand(shape, generator=self.gen, device=self.device)
        return u.clamp_(min=1e-20)

    def fanout_uniform(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.gen, device=self.device)


def ghost_need(nbr_rows: torch.Tensor, nbr_mask: torch.Tensor, keep: torch.Tensor,
               valid: torch.Tensor, ghost_mask: torch.Tensor, n_max: int) -> torch.Tensor:
    """(g_max,) 1.0 on the ghost slots the batch references through a kept,
    real neighbor slot of a valid row ("the selected cross-client neighbor
    embeddings", Algorithm 1 line 16), else 0. A scatter-max: every write
    to a slot agrees, so their order does not matter."""
    referenced = (nbr_rows >= n_max) & (nbr_mask * keep > 0) & valid[:, None]
    slot = torch.where(referenced, nbr_rows - n_max, 0).long().reshape(-1)
    need = torch.zeros_like(ghost_mask).scatter_reduce(
        0, slot, referenced.reshape(-1).to(ghost_mask.dtype), "amax")
    return need * ghost_mask


def make_local_update(mcfg: MethodConfig, n_max: int, *, train_backend: str = "gather"):
    """The LocalUpdate for one client (Algorithm 1 lines 10-19). The
    reference's ``g_max`` and ``h1_dim`` come from the tensors here.

    ``train_backend`` is the batch neighbor aggregation of both
    ``gcn_batch_forward`` calls (the loss pass and the training step):
    ``gather``, ``segment`` or ``spmm`` (the SpMM kernel, whose backward is
    its transposed launch).
    """
    if train_backend not in AGG_BACKENDS:
        raise ValueError(f"unknown train_backend {train_backend!r}; "
                         f"known: {AGG_BACKENDS}")
    bsz = batch_size_for(mcfg, n_max)
    syncs = mcfg.use_ghosts and not mcfg.use_generator

    def local_update(
        params: dict,               # global model from the server
        client: dict,               # this client's slice of the stacked arrays
        feats_all: torch.Tensor,    # (K, n_max, F) ghost pull source
        hist1_all: torch.Tensor,    # (K, n_tot, H1) ghost pull source (snapshot)
        hist1: torch.Tensor,        # (n_tot, H1) this client's table
        age: torch.Tensor,          # (n_tot,)
        ghost_feat: torch.Tensor,   # (g_max, F) current synced ghost features
        prev_loss: torch.Tensor,    # (n_max,) loss at previous round (-1 = never)
        tau: int,                   # current sync interval
        fanout: int,                # neighbor fanout
        epoch_offset: int,          # global batch-epoch counter (t * J)
        draws,                      # this client's draw stream
    ):
        dev = hist1.device
        train_mask = client["train_mask"] * client["node_mask"]
        all_idx = torch.arange(n_max, device=dev)

        # ---- lines 11-12: loss pass + selection probabilities ----
        with torch.no_grad():
            logits_all, _, _ = gcn_batch_forward(
                params, client["features"], ghost_feat, hist1,
                client["nbr_idx"], client["nbr_mask"], all_idx, backend=train_backend)
            loss_all = per_node_loss(logits_all, client["labels"]) * client["node_mask"]
            if mcfg.importance_sampling:
                scores = loss_delta_scores(loss_all, prev_loss, train_mask)
                probs = importance_probs(scores, train_mask)
            else:
                probs = uniform_probs(train_mask)

        opt_state = adamw_init(params)
        n_sync = 0
        n_pulled = torch.zeros((), dtype=torch.float32, device=dev)
        epoch_losses = []
        for j in range(mcfg.local_epochs):
            ed = draws.epoch()

            # ---- line 14: batch selection ----
            if mcfg.use_all_samples:
                batch_idx, valid = all_idx, train_mask > 0
            else:
                batch_idx, valid = sample_batch(ed.batch_uniform((n_max,)), probs, bsz,
                                                train_mask)

            # ---- neighbor fanout subsampling ----
            b_nbr_idx = client["nbr_idx"][batch_idx]
            b_nbr_mask = client["nbr_mask"][batch_idx]
            ranks = torch.where(b_nbr_mask > 0, ed.fanout_uniform(b_nbr_mask.shape), 2.0)
            keep = (stable_rank(ranks) < fanout).to(torch.float32)
            if not mcfg.use_ghosts:
                keep = keep * (b_nbr_idx < n_max)

            # ---- lines 15-17: sync every tau epochs (pull the ghosts the
            # batch references) — j runs over the global batch epochs, so
            # round 0 epoch 0 always syncs as the warm-up ----
            if syncs and (epoch_offset + j) % max(tau, 1) == 0:
                need = ghost_need(b_nbr_idx, b_nbr_mask, keep, valid,
                                  client["ghost_mask"], n_max)
                gf, gh = pull_ghosts(hist1_all, feats_all, client["ghost_owner"],
                                     client["ghost_row"], client["ghost_mask"])
                pulled = need[:, None] > 0
                ghost_feat = torch.where(pulled, gf, ghost_feat)
                hist1 = torch.cat([hist1[:n_max], torch.where(pulled, gh, hist1[n_max:])])
                n_sync += 1
                n_pulled = n_pulled + need.sum()

            # ---- line 18: batch forward/backward + local step ----
            p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            logits, h1, _ = gcn_batch_forward(
                p, client["features"], ghost_feat, hist1, client["nbr_idx"],
                client["nbr_mask"], batch_idx, nbr_keep=keep, backend=train_backend)
            w = valid.to(torch.float32) * train_mask[batch_idx]
            nll = per_node_loss(logits, client["labels"][batch_idx])
            loss = (nll * w).sum() / torch.clamp(w.sum(), min=1.0)
            grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
            params, opt_state = adamw_update(grads, opt_state, params, mcfg.lr)

            # ---- historical push of fresh in-batch embeddings ----
            hist1, age = push_embeddings(
                hist1, age, batch_idx, h1.detach(),
                valid & (client["node_mask"][batch_idx] > 0))
            epoch_losses.append(loss.detach())

        with torch.no_grad():
            entropy = -torch.sum(torch.where(
                probs > 0, probs * torch.log(torch.clamp(probs, min=1e-30)), 0.0))
        stats = {
            "loss_all": loss_all,                  # becomes prev_loss next round
            "epoch_losses": torch.stack(epoch_losses),
            "n_sync": n_sync,
            "n_ghost_pulled": n_pulled,
            "mean_importance_entropy": entropy,
        }
        return params, hist1, age, ghost_feat, stats

    return local_update


def make_cohort_update(mcfg: MethodConfig, n_max: int, *, train_backend: str = "gather"):
    """The cohort-stacked LocalUpdate (the reference's ``make_vmapped_update``
    with ``ghost_source="tables"``): per-client arguments carry a leading
    cohort axis, ``params``, ``feats_all``, ``hist1_all``, ``tau`` and
    ``epoch_offset`` are shared, ``fanouts`` and ``streams`` have one entry
    per client. Returns ``(params, hist1, age, ghost_feat, stats)``, each
    stacked over the cohort (``stats["n_sync"]`` a host int32 array)."""
    one = make_local_update(mcfg, n_max, train_backend=train_backend)

    def cohort_update(params, clients, feats_all, hist1_all, hist1, age, ghost_feat,
                      prev_loss, tau, fanouts, epoch_offset, streams):
        outs = [one(params, {k: v[i] for k, v in clients.items()}, feats_all, hist1_all,
                    hist1[i], age[i], ghost_feat[i], prev_loss[i], tau, int(fanouts[i]),
                    epoch_offset, streams[i])
                for i in range(len(streams))]
        new_params = {k: torch.stack([o[0][k] for o in outs]) for k in params}
        stats = {k: torch.stack([o[4][k] for o in outs])
                 for k in ("loss_all", "epoch_losses", "n_ghost_pulled",
                           "mean_importance_entropy")}
        stats["n_sync"] = np.asarray([o[4]["n_sync"] for o in outs], np.int32)
        return (new_params, torch.stack([o[1] for o in outs]),
                torch.stack([o[2] for o in outs]), torch.stack([o[3] for o in outs]),
                stats)

    return cohort_update
