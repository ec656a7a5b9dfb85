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

The LocalUpdate marks its device phases by the paper's lines
(``repro_torch.utils.spans``): ``loss_pass`` (lines 11-12, Eq. 7-8),
``sampling`` (line 14 and the fanout), ``ghost_pull`` (lines 15-17, where
the gate is open), ``train_step`` (line 18's forward and backward),
``optimizer`` (AdamW) and ``table_traffic`` (the push, and the cohort's
stacking); they are recorded only inside the fused executor's scope.

``ghost_source`` picks where the sync reads its ghost rows: ``"tables"``
(the default) gathers them from the round-start snapshots of every client's
features and layer-1 table; ``"prefetched"`` (the pod-sharded executor,
``sharding.tables``) takes each client's rows as the exchange delivered
them. ``sync_dtype`` is the ghost pull's wire format
(``repro_torch.federated.quant``): in ``"tables"`` mode the pulled rows
round-trip through the codec here, ``"fp32"`` takes no codec at all and
pulls in one pass (``kernels.ghost_pull``: on CUDA one kernel writes the new
ghost and layer-1 rows); in ``"prefetched"`` mode the rows arrive decoded
from the wire already.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.historical import (
    merge_pulled,
    pull_ghosts,
    pull_ghosts_prefetched,
    push_embeddings,
)
from repro_torch.core.importance import (
    importance_probs,
    loss_delta_scores,
    sample_batch,
    stable_rank,
    uniform_probs,
)
from repro_torch.federated.quant import check_sync_dtype, quant_roundtrip
from repro_torch.kernels.ghost_pull.ops import ghost_pull
from repro_torch.models.gcn import AGG_BACKENDS, gcn_batch_forward, per_node_loss
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.utils.spans import device_phase


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


class ReplayStream:
    """One cohort member's draw stream over uniforms drawn beforehand:
    ``epochs`` holds (batch uniforms or None, fanout uniforms) per local
    epoch, handed out in order; a shape other than the one drawn raises."""

    def __init__(self, epochs):
        self._epochs = iter(epochs)

    def epoch(self) -> "_ReplayEpoch":
        return _ReplayEpoch(*next(self._epochs))


class _ReplayEpoch:
    def __init__(self, batch, fanout):
        self._batch, self._fanout = batch, fanout

    def batch_uniform(self, shape) -> torch.Tensor:
        if self._batch is None or tuple(self._batch.shape) != tuple(shape):
            got = None if self._batch is None else tuple(self._batch.shape)
            raise ValueError(f"batch_uniform{tuple(shape)}: drew {got}")
        return self._batch

    def fanout_uniform(self, shape) -> torch.Tensor:
        if tuple(self._fanout.shape) != tuple(shape):
            raise ValueError(f"fanout_uniform{tuple(shape)}: drew "
                             f"{tuple(self._fanout.shape)}")
        return self._fanout


class RecordedDraws:
    """A draw provider replaying uniforms given as host arrays, one entry of
    ``rounds`` per ``clients(m)`` call: ``(batch, fanout)`` with ``batch``
    (m, J, n_max) or None (the methods that draw no batch) and ``fanout``
    (m, J, rows, max_deg). A process that cannot make another provider's
    draws (a rank of a sharded run replaying the reference's key chain) is
    given them this way."""

    def __init__(self, rounds, device):
        self.device = torch.device(device)
        self._rounds = iter(rounds)

    def clients(self, m: int) -> list:
        batch, fanout = next(self._rounds)
        if fanout.shape[0] != m:
            raise ValueError(f"recorded draws hold {fanout.shape[0]} members, asked for {m}")
        dev = self.device

        def t(x):
            return None if x is None else torch.as_tensor(np.asarray(x), device=dev)

        return [ReplayStream([(None if batch is None else t(batch[i, j]), t(fanout[i, j]))
                              for j in range(fanout.shape[1])]) for i in range(m)]


def sync_gates(mcfg: MethodConfig, tau: int, epoch_offset: int) -> tuple:
    """Which of a LocalUpdate's J epochs pull the ghosts: every ``tau``-th
    global batch epoch ``(epoch_offset + j) % tau == 0``, for the methods
    that sync at all. Host integers only, so a round's gates are known
    before it runs (the fused executor keys its captured rounds on them)."""
    syncs = mcfg.use_ghosts and not mcfg.use_generator
    return tuple(bool(syncs and (epoch_offset + j) % max(tau, 1) == 0)
                 for j in range(mcfg.local_epochs))


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


GHOST_SOURCES = ("tables", "prefetched")


def make_local_update(mcfg: MethodConfig, n_max: int, *, train_backend: str = "gather",
                      sync_dtype: str = "fp32", ghost_source: str = "tables",
                      spmm_route: str = "dense"):
    """The LocalUpdate for one client (Algorithm 1 lines 10-19). The
    reference's ``g_max`` and ``h1_dim`` come from the tensors here.

    ``train_backend`` is the batch neighbor aggregation of both
    ``gcn_batch_forward`` calls (the loss pass and the training step):
    ``gather``, ``segment`` or ``spmm`` (the SpMM kernel, whose backward is
    its transposed launch; ``spmm_route`` its dense or sparse operand, one
    for the run, ``kernels.spmm.ops.spmm_route``). ``sync_dtype`` is the
    ghost pull's wire format.
    With ``ghost_source="prefetched"`` the arguments ``feats_all`` and
    ``hist1_all`` carry this client's own (g_max, F) and (g_max, H1) ghost
    source rows, pre-gathered (the same round-start values), and the pull
    applies no second codec round-trip.
    """
    if ghost_source not in GHOST_SOURCES:
        raise ValueError(f"unknown ghost_source {ghost_source!r}; "
                         "known: tables | prefetched")
    if train_backend not in AGG_BACKENDS:
        raise ValueError(f"unknown train_backend {train_backend!r}; "
                         f"known: {AGG_BACKENDS}")
    check_sync_dtype(sync_dtype)
    bsz = batch_size_for(mcfg, n_max)
    # the fp32 pull from the tables is one kernel on CUDA (kernels.ghost_pull);
    # the wire codec's round trip acts on the gathered rows, and prefetched
    # rows arrive gathered, so those keep the gather, mask and select
    one_pass = ghost_source == "tables" and sync_dtype == "fp32"

    def local_update(
        params: dict,               # global model from the server
        client: dict,               # this client's slice of the stacked arrays
        feats_all: torch.Tensor,    # (K, n_max, F) ghost pull source
                                    #   [prefetched: (g_max, F) source rows]
        hist1_all: torch.Tensor,    # (K, n_tot, H1) ghost pull source (snapshot)
                                    #   [prefetched: (g_max, H1) source rows]
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

        # ---- lines 11-12: loss pass + selection probabilities ----
        with torch.no_grad(), device_phase("loss_pass"):
            train_mask = client["train_mask"] * client["node_mask"]
            all_idx = torch.arange(n_max, device=dev)
            logits_all, _, _ = gcn_batch_forward(
                params, client["features"], ghost_feat, hist1,
                client["nbr_idx"], client["nbr_mask"], all_idx, backend=train_backend,
                spmm_route=spmm_route)
            loss_all = per_node_loss(logits_all, client["labels"]) * client["node_mask"]
            if mcfg.importance_sampling:
                scores = loss_delta_scores(loss_all, prev_loss, train_mask)
                probs = importance_probs(scores, train_mask)
            else:
                probs = uniform_probs(train_mask)
            entropy = -torch.sum(torch.where(
                probs > 0, probs * torch.log(torch.clamp(probs, min=1e-30)), 0.0))

        gates = sync_gates(mcfg, tau, epoch_offset)
        n_sync = 0
        n_pulled = torch.zeros((), dtype=torch.float32, device=dev)
        epoch_losses = []
        for j in range(mcfg.local_epochs):
            ed = draws.epoch()

            with device_phase("sampling"):
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
            if gates[j]:
                with device_phase("ghost_pull"):
                    need = ghost_need(b_nbr_idx, b_nbr_mask, keep, valid,
                                      client["ghost_mask"], n_max)
                    if one_pass:
                        ghost_feat, hist1 = ghost_pull(
                            feats_all, hist1_all, client["ghost_owner"], client["ghost_row"],
                            client["ghost_mask"], need, ghost_feat, hist1, n_max)
                    else:
                        if ghost_source == "tables":
                            gf, gh = pull_ghosts(hist1_all, feats_all, client["ghost_owner"],
                                                 client["ghost_row"], client["ghost_mask"])
                            gf = quant_roundtrip(gf, sync_dtype)
                            gh = quant_roundtrip(gh, sync_dtype)
                        else:
                            gf, gh = pull_ghosts_prefetched(feats_all, hist1_all,
                                                            client["ghost_mask"])
                        ghost_feat, hist1 = merge_pulled(need, gf, gh, ghost_feat, hist1,
                                                         n_max)
                    n_sync += 1
                    n_pulled = n_pulled + need.sum()

            # ---- line 18: batch forward/backward + local step ----
            with device_phase("train_step"):
                p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
                logits, h1, _ = gcn_batch_forward(
                    p, client["features"], ghost_feat, hist1, client["nbr_idx"],
                    client["nbr_mask"], batch_idx, nbr_keep=keep, backend=train_backend,
                    spmm_route=spmm_route)
                w = valid.to(torch.float32) * train_mask[batch_idx]
                nll = per_node_loss(logits, client["labels"][batch_idx])
                loss = (nll * w).sum() / torch.clamp(w.sum(), min=1.0)
                grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
            with device_phase("optimizer"):
                if j == 0:
                    opt_state = adamw_init(params)
                params, opt_state = adamw_update(grads, opt_state, params, mcfg.lr)

            # ---- historical push of fresh in-batch embeddings ----
            with device_phase("table_traffic"):
                hist1, age = push_embeddings(
                    hist1, age, batch_idx, h1.detach(),
                    valid & (client["node_mask"][batch_idx] > 0))
            epoch_losses.append(loss.detach())

        stats = {
            "loss_all": loss_all,                  # becomes prev_loss next round
            "epoch_losses": torch.stack(epoch_losses),
            "n_sync": n_sync,
            "n_ghost_pulled": n_pulled,
            "mean_importance_entropy": entropy,
        }
        return params, hist1, age, ghost_feat, stats

    return local_update


def make_cohort_update(mcfg: MethodConfig, n_max: int, *, train_backend: str = "gather",
                       sync_dtype: str = "fp32", ghost_source: str = "tables",
                       spmm_route: str = "dense"):
    """The cohort-stacked LocalUpdate (the reference's ``make_vmapped_update``):
    per-client arguments carry a leading cohort axis, ``params``, ``tau``
    and ``epoch_offset`` are shared, ``fanouts`` and ``streams`` have one
    entry per client. ``feats_all`` and ``hist1_all`` are shared under
    ``ghost_source="tables"`` and per client (a leading cohort axis) under
    ``"prefetched"``. Returns ``(params, hist1, age, ghost_feat, stats)``,
    each stacked over the cohort (``stats["n_sync"]`` a host int32 array)."""
    one = make_local_update(mcfg, n_max, train_backend=train_backend, sync_dtype=sync_dtype,
                            ghost_source=ghost_source, spmm_route=spmm_route)
    per_client = ghost_source == "prefetched"

    def cohort_update(params, clients, feats_all, hist1_all, hist1, age, ghost_feat,
                      prev_loss, tau, fanouts, epoch_offset, streams):
        outs = [one(params, {k: v[i] for k, v in clients.items()},
                    feats_all[i] if per_client else feats_all,
                    hist1_all[i] if per_client else hist1_all,
                    hist1[i], age[i], ghost_feat[i], prev_loss[i], tau, int(fanouts[i]),
                    epoch_offset, streams[i])
                for i in range(len(streams))]
        with device_phase("table_traffic"):
            new_params = {k: torch.stack([o[0][k] for o in outs]) for k in params}
            stats = {k: torch.stack([o[4][k] for o in outs])
                     for k in ("loss_all", "epoch_losses", "n_ghost_pulled",
                               "mean_importance_entropy")}
            tables = tuple(torch.stack([o[i] for o in outs]) for i in (1, 2, 3))
        stats["n_sync"] = np.asarray([o[4]["n_sync"] for o in outs], np.int32)
        return (new_params, *tables, stats)

    return cohort_update
