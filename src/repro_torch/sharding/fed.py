"""Client-axis sharding of the fused round, on ``torch.distributed``.

Port of ``repro/sharding/fed.py``. The fused round runs the cohort's
LocalUpdate, the merge and the write-back. On a mesh the cohort is the
unit of scale-out: every rank trains its slice of the (padded) cohort
against replicated global state, the merge becomes a weighted all-reduce
(``weighted_merge``: WeightedFedAvg's sum(w·x)/sum(w), plain FedAvg when
the weights are uniform), and the write-back all-gathers the cohort's
fresh rows over the cohort axis, the embedding sync of the real
deployment.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh``; one process is
one rank (``sharding.ranks`` starts them on one machine, ``torchrun`` on
several). Every rank makes the host decisions from the same seed, as the
reference's single controller does, so the cohorts, fanouts and gates are
the same on every rank.

``build_sharded_chunk`` returns the body of one round over the executor's
static buffers (``api.fused.ShardedRounds`` replays it from a CUDA graph
per key on the card, and runs it eagerly on the CPU).

Ragged cohorts (m not divisible by the axis) are padded with dummy clients
built from three no-op guarantees, each made explicit here (torch neither
clamps a gather nor drops a scatter):

* the dummy id is ``n_clients``: its gathers read client ``n_clients - 1``
  (the clamp JAX applies), its write-back lands in a scratch row past the
  tables' last row, which nothing reads;
* aggregation weight 0: the merge adds nothing of it;
* the draws: every rank draws the real cohort's uniforms in the unsharded
  order and keeps its slice (``slice_streams``), dummies get constants, so
  every real member trains on what the unsharded run draws for it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.fedais import ReplayStream
from repro_torch.federated.quant import check_sync_dtype
from repro_torch.federated.quant import decode as quant_decode
from repro_torch.federated.quant import encode as quant_encode
from repro_torch.sharding import comm

__all__ = ["CLIENT_AXIS", "axis_index", "axis_size", "build_sharded_chunk", "client_axis_of",
           "client_round_inputs", "cohort_padding", "dryrun_chunk_args", "make_client_mesh",
           "pairwise_sum", "slice_streams", "weighted_merge"]

CLIENT_AXIS = "clients"
REDUCES = ("psum", "pairwise")


def make_client_mesh(n_devices: Optional[int] = None, *, axis: str = CLIENT_AXIS,
                     device=None):
    """A flat ``(n,)`` mesh with one client-sharding axis over the ranks of
    the default process group (started by ``sharding.ranks`` or
    ``torchrun``). ``n`` must be the world size. ``device=None`` is the
    card (NCCL); ``device="cpu"`` a gloo world's CPU ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.device import resolve_device

    if not dist.is_initialized():
        raise RuntimeError("make_client_mesh needs a process group: start the ranks "
                           "with repro_torch.sharding.ranks or torchrun")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"make_client_mesh spans the world's {world} ranks, asked for {n}")
    return init_device_mesh(resolve_device(device).type, (n,), mesh_dim_names=(axis,))


def axis_size(mesh, name: str) -> int:
    return int(mesh.shape[mesh.mesh_dim_names.index(name)])


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate along the mesh axis ``name``."""
    return int(mesh.get_local_rank(name))


def client_axis_of(mesh) -> Optional[str]:
    """The mesh axis the client cohort shards over: ``"clients"`` if
    present, else the sole axis of a 1-axis mesh, else None."""
    names = tuple(mesh.mesh_dim_names or ())
    if CLIENT_AXIS in names:
        return CLIENT_AXIS
    if len(names) == 1:
        return names[0]
    return None


def cohort_padding(m: int, n_shards: int) -> int:
    """Dummy clients appended so the cohort splits evenly across shards."""
    return (-m) % n_shards


def pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Deterministic binary-tree reduction over the leading axis: pairs sum
    left to right level by level, so the association order is fixed by the
    leading length alone (never by how a collective schedules its sum)."""
    while x.shape[0] > 1:
        n = x.shape[0]
        even = (n // 2) * 2
        y = x[0:even:2] + x[1:even:2]
        if n % 2:
            y = torch.cat([y, x[even:]], dim=0)
        x = y
    return x[0]


def weighted_merge(stack: dict, old: dict, w: torch.Tensor, wsum: torch.Tensor, group,
                   reduce: str) -> dict:
    """The sharded executors' aggregation rule: sum(w·x)/sum(w) over the
    ranks of ``group``. ``stack`` holds this rank's members' params on a
    leading axis with weights ``w``; ``wsum`` is the whole cohort's weight
    sum (a 0-d tensor). All leaves travel flat in one collective:
    ``"psum"`` sums the ranks' partial sums with an all-reduce (its order is
    the library's), ``"pairwise"`` all-gathers them and adds them in the
    fixed tree of ``pairwise_sum``. The quotient divides by a 0-d tensor,
    one formula on the card and on the CPU (``federated.server.fedavg``).
    When every weight is zero (a round whose whole cohort dropped out) the
    merge keeps ``old``; with any weight the guard passes the quotient
    through unchanged. A member of weight 0 adds an exact 0, whatever its
    params hold, and the members of positive weight are summed first, in
    cohort order (as the fault-aware fused merge, ``faults.fused``, sums its
    survivors): a dropped member's zero between two survivors would change
    the sum's association, and one rank's merge then gives the fused
    merge's bits."""
    if reduce not in REDUCES:
        raise ValueError(f"unknown reduce {reduce!r}; known: psum | pairwise")
    keys = list(stack)
    order = torch.sort((w <= 0).to(torch.uint8), stable=True).indices
    w = w[order]
    parts = []
    for k in keys:
        x = stack[k][order]
        wb = w.reshape((-1,) + (1,) * (x.ndim - 1))
        parts.append(torch.where(wb > 0, x * wb, 0.0).sum(dim=0).reshape(-1))
    flat = torch.cat(parts)
    if reduce == "psum":
        num = comm.all_reduce_sum(flat, group, "merge_allreduce")
    else:
        num = pairwise_sum(comm.all_gather(flat, group, "merge_all_gather"))
    merged = num / torch.clamp(wsum, min=1e-12)
    out, at = {}, 0
    for k in keys:
        n = old[k].numel()
        out[k] = torch.where(wsum > 0.0, merged[at:at + n].reshape(old[k].shape), old[k])
        at += n
    return out


def cohort_weight_sum(w_all: torch.Tensor, n_shards: int) -> torch.Tensor:
    """The weight sum of the whole padded cohort, as the reference's
    pairwise merge forms it: each shard's sum, then the fixed tree. Every
    rank holds the cohort's weights, so this needs no collective; the
    weights are client sizes or ones, integers, whose sum is exact in any
    order, so it also equals the reference's psum of the shards' sums."""
    return pairwise_sum(w_all.reshape(n_shards, -1).sum(dim=1))


def client_round_inputs(sel: np.ndarray, w: np.ndarray, *, n_shards: int, shard: int,
                        n_clients: int) -> dict:
    """The round inputs of cohort shard ``shard`` for a chunk's (rounds, m)
    padded cohorts ``sel`` (the dummy id is K) with weights ``w``, on the
    host: ``w`` / ``w_all`` (this slice's and the cohort's weights),
    ``rows`` (this slice's ids, clamped to K - 1 as JAX clamps a gather)
    and ``dest`` (the whole cohort's write-back rows, dummies at the
    scratch row K). Indices are int32."""
    mL = sel.shape[1] // n_shards
    lo, K = shard * mL, n_clients
    return {"w": w[:, lo:lo + mL], "w_all": w,
            "rows": np.minimum(sel[:, lo:lo + mL], K - 1).astype(np.int32),
            "dest": np.where(sel < K, sel, K).astype(np.int32)}


# -- draws -------------------------------------------------------------------

def slice_streams(draws, m_real: int, lo: int, hi: int, *, local_epochs: int,
                  batch_shape, fanout_shape, device) -> list:
    """Streams for cohort members ``lo .. hi - 1`` of a round: every real
    member's uniforms are drawn here, in the order the unsharded round draws
    them (member by member, epoch by epoch, the batch's then the fanout's),
    and this rank keeps its slice. ``batch_shape`` is None for the methods
    that train on every node (they draw no batch). Members past ``m_real``
    (dummies) get constant uniforms."""
    streams = draws.clients(m_real)
    kept = []
    for i in range(m_real):
        epochs = []
        for _ in range(local_epochs):
            ed = streams[i].epoch()
            b = None if batch_shape is None else ed.batch_uniform(batch_shape)
            epochs.append((b, ed.fanout_uniform(fanout_shape)))
        if lo <= i < hi:
            kept.append(ReplayStream(epochs))
    for _ in range(max(lo, m_real), hi):
        b = None if batch_shape is None else torch.full(batch_shape, 0.5, device=device)
        f = torch.full(fanout_shape, 0.5, device=device)
        kept.append(ReplayStream([(b, f)] * local_epochs))
    return kept


# -- the round ---------------------------------------------------------------

def wire_rows(parts, sync_dtype: str) -> tuple[list, list]:
    """Encode each part (a (n, ...) tensor) for the wire: float parts
    through the ``sync_dtype`` codec (payload, and at int8 a per-row
    scale), integer parts as they are. Returns (tensors, layout): the
    tensors to pack, and per part how ``unwire_rows`` rebuilds it."""
    tensors, layout = [], []
    for t in parts:
        if sync_dtype != "fp32" and t.is_floating_point():
            q, s = quant_encode(t, sync_dtype)
            tensors.append(q)
            layout.append((tuple(t.shape[1:]), q.dtype, True,
                           None if s is None else (tuple(s.shape[1:]), s.dtype)))
            if s is not None:
                tensors.append(s)
        else:
            tensors.append(t)
            layout.append((tuple(t.shape[1:]), t.dtype, False, None))
    return tensors, layout


def unwire_rows(buf: torch.Tensor, layout, sync_dtype: str) -> list:
    """Unpack a (n, bytes) buffer of ``wire_rows``' tensors and decode it."""
    like = []
    for shape, dtype, _, scale in layout:
        like.append((shape, dtype))
        if scale is not None:
            like.append(scale)
    flat = comm.unpack(buf, like)
    out, i = [], 0
    for _, _, encoded, scale in layout:
        if encoded:
            out.append(quant_decode(flat[i], None if scale is None else flat[i + 1],
                                    sync_dtype))
        else:
            out.append(flat[i])
        i += 1 if scale is None else 2
    return out


def _client_step(cohort, group, reduce: str):
    """The per-round client half: the cohort LocalUpdate on this rank's
    slice, then the weighted merge over ``group``."""

    def step(params, client, feats_all, hist1_all, h1s, ages, gfs, pls, tau, fanouts, eoff,
             streams, w, wsum):
        new_params, new_hist1, new_age, new_ghost, stats = cohort(
            params, client, feats_all, hist1_all, h1s, ages, gfs, pls, tau, fanouts, eoff,
            streams)
        agg = weighted_merge(new_params, params, w, wsum, group, reduce)
        return agg, new_hist1, new_age, new_ghost, stats

    return step


def build_sharded_chunk(cohort, mesh, axis: str, *, reduce: str = "psum",
                        sync_dtype: str = "fp32"):
    """The body of one client-sharded round (the reference's chunk scans it
    over the rounds of a chunk; here the executor calls it per round).

    ``body(params, tables, arrays, inp, tau, fanouts, eoff, streams)``:
    ``tables`` are the replicated (K + 1)-row hist1 / age / ghost_feat /
    prev_loss buffers (row K the scratch row), ``arrays`` the K-row client
    arrays, ``inp`` the round's static inputs: ``rows`` (this rank's slice
    of the padded cohort, clamped to K - 1), ``dest`` (the whole padded
    cohort's write-back rows, dummies at K), ``w`` / ``w_all`` (this
    slice's and the cohort's weights). ``fanouts`` and ``streams`` are this
    slice's. It writes the merged params into ``params`` and the cohort's
    fresh rows into the tables in place, and returns the slice's stats.
    ``sync_dtype`` encodes the write-back's float rows on the wire and
    decodes them at every rank."""
    if reduce not in REDUCES:
        raise ValueError(f"unknown reduce {reduce!r}; known: psum | pairwise")
    check_sync_dtype(sync_dtype)
    group = mesh.get_group(axis)
    n_shards = axis_size(mesh, axis)
    step = _client_step(cohort, group, reduce)

    def body(params, tables, arrays, inp, tau, fanouts, eoff, streams):
        hist1, age, ghost_feat, prev_loss = tables
        K = hist1.shape[0] - 1
        rows = inp["rows"]
        client = {k: v[rows] for k, v in arrays.items()}
        wsum = cohort_weight_sum(inp["w_all"], n_shards)
        agg, new_hist1, new_age, new_ghost, stats = step(
            params, client, arrays["features"], hist1[:K], hist1[rows], age[rows],
            ghost_feat[rows], prev_loss[rows], tau, fanouts, eoff, streams, inp["w"], wsum)
        # the write-back: every rank gathers the cohort's fresh rows (as
        # codec payloads) and writes them into its replicated tables
        tensors, layout = wire_rows([new_hist1, new_age, new_ghost, stats["loss_all"]],
                                    sync_dtype)
        rows_all = comm.all_gather(comm.pack(tensors), group, "wb_all_gather")
        fresh = unwire_rows(rows_all.reshape(-1, rows_all.shape[-1]), layout, sync_dtype)
        dest = inp["dest"]
        for table, new in zip(tables, fresh):
            table[dest] = new
        for k, buf in params.items():
            buf.copy_(agg[k])
        return stats

    return body


# -- dry-run arguments -------------------------------------------------------

class DryrunFill:
    """Makes a dry run's tensors on ``device``: on ``meta`` shapes only,
    elsewhere drawn from a ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, device, seed: int = 0):
        self.device = torch.device(device)
        self.meta = self.device.type == "meta"
        self.gen = None if self.meta else torch.Generator(device=self.device).manual_seed(seed)

    def normal(self, shape) -> torch.Tensor:
        if self.meta:
            return torch.empty(shape, device=self.device)
        return torch.randn(shape, generator=self.gen, device=self.device)

    def uniform(self, shape, low: float = 0.0) -> torch.Tensor:
        if self.meta:
            return torch.empty(shape, device=self.device)
        return torch.rand(shape, generator=self.gen, device=self.device).clamp_(min=low)

    def ints(self, high: int, shape) -> torch.Tensor:
        if self.meta:
            return torch.empty(shape, dtype=torch.int32, device=self.device)
        return torch.randint(0, high, shape, generator=self.gen, dtype=torch.int32,
                             device=self.device)

    def mask(self, p: float, shape) -> torch.Tensor:
        return self.uniform(shape) if self.meta else (self.uniform(shape) < p).float()

    def full(self, shape, value, dtype=torch.float32) -> torch.Tensor:
        return torch.full(shape, value, dtype=dtype, device=self.device)

    def host(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)


def dryrun_client_arrays(fill: DryrunFill, n_rows: int, *, n_max: int, g_max: int,
                         n_feat: int, n_classes: int, max_deg: int, n_clients: int,
                         keys=None) -> dict:
    """(``n_rows``, ...) client arrays of the dry run, by the partition's
    dtypes: every node real, 70% of them training nodes, neighbours among
    the n_max + g_max rows, half the slots live; ghosts point at uniform
    (owner, row) pairs. ``keys`` picks a subset (the pod mode's
    ``POD_ARRAY_KEYS``)."""
    n = n_rows
    make = {
        "features": lambda: fill.normal((n, n_max, n_feat)),
        "labels": lambda: fill.ints(n_classes, (n, n_max)),
        "node_mask": lambda: fill.full((n, n_max), 1.0),
        "train_mask": lambda: fill.mask(0.7, (n, n_max)),
        "nbr_idx": lambda: fill.ints(n_max + g_max, (n, n_max, max_deg)),
        "nbr_mask": lambda: fill.mask(0.5, (n, n_max, max_deg)),
        "ghost_owner": lambda: fill.ints(n_clients, (n, g_max)),
        "ghost_row": lambda: fill.ints(n_max, (n, g_max)),
        "ghost_mask": lambda: fill.mask(0.5, (n, g_max)),
    }
    return {k: make[k]() for k in (keys or make)}


def dryrun_round_draws(fill: DryrunFill, mcfg, n_members: int, n_max: int,
                       max_deg: int) -> list:
    """Per cohort member, its J epochs' (batch uniforms or None, fanout
    uniforms): what ``ReplayStream`` hands out (a stream is used up by one
    round, so a caller wraps these anew for each)."""
    from repro_torch.core.fedais import batch_size_for

    bsz = batch_size_for(mcfg, n_max)
    rows = n_max if mcfg.use_all_samples else bsz
    return [[(None if mcfg.use_all_samples else fill.uniform((n_max,), 1e-20),
              fill.uniform((rows, max_deg))) for _ in range(mcfg.local_epochs)]
            for _ in range(n_members)]


def dryrun_round_cohort(n_clients: int, cohort: int, n_shards: int, dummy: int,
                        seed: int) -> tuple[np.ndarray, np.ndarray]:
    """A (1, m_pad) cohort of ``cohort`` distinct clients drawn with numpy
    from ``seed``, padded with ``dummy`` ids to a multiple of ``n_shards``,
    and its FedAvg weights (1, dummies 0), as the executor pads them."""
    rng = np.random.default_rng(seed)
    sel = rng.choice(n_clients, size=cohort, replace=False).astype(np.int64)
    pad = cohort_padding(cohort, n_shards)
    sel = np.concatenate([sel, np.full(pad, dummy, np.int64)])[None]
    w = np.concatenate([np.ones(cohort, np.float32), np.zeros(pad, np.float32)])[None]
    return sel, w


def dryrun_params(fill: DryrunFill, n_feat: int, n_classes: int, seed: int) -> dict:
    """``gcn_init``'s params from ``seed``, on the fill's device (on meta:
    their shapes)."""
    from repro_torch.models.gcn import gcn_init

    params = gcn_init(torch.Generator().manual_seed(seed), n_feat, n_classes, device="cpu")
    return {k: v.to(fill.device) for k, v in params.items()}


def dryrun_chunk_args(mesh, *, n_clients: int, cohort: int, n_max: int, g_max: int,
                      n_feat: int, n_classes: int, mcfg, max_deg: int | None = None,
                      device="meta", seed: int = 0) -> dict:
    """This rank's arguments to ``build_sharded_chunk``'s body for one
    round of ``cohort`` clients of ``n_clients`` (the counterpart of the
    reference's ``abstract_chunk_args``): ``params``, ``tables`` (the
    replicated (K + 1)-row tables), ``arrays`` (the K-row client arrays),
    ``inp`` (``client_round_inputs`` of a seeded cohort, padded to the
    mesh's client axis), ``fanouts`` and ``draws`` (this slice's, one list
    of epochs per member, for ``ReplayStream``). On ``meta`` they are
    shapes; elsewhere they are drawn from ``seed``."""
    from repro_torch.models.gcn import HIDDEN
    from repro_torch.sharding.ledger import DRYRUN_MAX_DEG

    D = DRYRUN_MAX_DEG if max_deg is None else max_deg
    axis = client_axis_of(mesh)
    n_shards, shard = axis_size(mesh, axis), axis_index(mesh, axis)
    fill = DryrunFill(device, seed)
    K, n_tot = n_clients, n_max + g_max
    tables = (fill.normal((K + 1, n_tot, HIDDEN[0])), fill.full((K + 1, n_tot), 0, torch.int32),
              fill.normal((K + 1, g_max, n_feat)), fill.full((K + 1, n_max), -1.0))
    sel, w = dryrun_round_cohort(K, cohort, n_shards, K, seed)
    inp = client_round_inputs(sel, w, n_shards=n_shards, shard=shard, n_clients=K)
    mL = sel.shape[1] // n_shards
    return {
        "params": dryrun_params(fill, n_feat, n_classes, seed),
        "tables": tables,
        "arrays": dryrun_client_arrays(fill, K, n_max=n_max, g_max=g_max, n_feat=n_feat,
                                       n_classes=n_classes, max_deg=D, n_clients=K),
        "inp": {k: fill.host(v[0]) for k, v in inp.items()},
        "fanouts": np.full(mL, mcfg.neighbor_fanout, np.int64),
        "draws": dryrun_round_draws(fill, mcfg, mL, n_max, D),
        "sel": sel,
    }
