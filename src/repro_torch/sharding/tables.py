"""Pod-sharded placement: no per-rank resident or collective scales with K.

Port of ``repro/sharding/tables.py``. Client sharding (``sharding.fed``)
splits each round's cohort across ranks but replicates all global state.
Here every K-sized array — the ``hist1`` / ``age`` / ``ghost_feat`` /
``prev_loss`` tables and the static client arrays — is placed as pod
shards over a ``("pods", "clients")`` mesh: pod p keeps the rows of its
resident clients (``rows_per_pod`` of them, the K axis zero-padded to the
pod grid by ``pod_table_padding``), while each round's cohort splits over
all P×C ranks. Four exchanges replace the replicated dataflow, each sized
by what the round touches (``sharding.comm`` counts them under the names of
``sharding.ledger.pod_placement_ledger``):

* **owner-keyed cohort fetch** (``fetch_psum_tables``,
  ``fetch_psum_statics``): the m selected clients' table rows and static
  arrays, a masked all-reduce over all ranks in which exactly one rank
  contributes each row. The rows travel as int32 words, so the sum of one
  word and zeros is the word: bit for bit, whatever the table's type.
  Cohort dummies (id Kp) have no owner pod and fetch zeros.
* **gated ghost all-to-all** (``ghost_all_to_all``, ``ghost_fetch_psum``):
  the cross-pod layer-1 embedding sync over ``GhostBuckets``, on the pods
  sub-group, then the cohort fetch of the ghost sources. It runs only on a
  round whose sync gate is on (``sync_round_gates``: does any of the
  round's J epochs sync?); a round with the gate off does not run it at all
  (zero bytes, and on the card its CUDA graph holds no such collective).
  Its LocalUpdate never reads the sources then.
* **static ghost features**: the layer-0 ghost sources come from the
  partition-time bucketed owner exchange (``exchange_ghost_features``), a
  pod-sharded (Kp, g_max, F) table built once.
* **cohort-keyed write-back** (``wb_stage1_all_gather``,
  ``wb_stage2_all_to_all``): the fresh rows all-gather within the pod row
  (m/P rows, on the clients sub-group), then a host-routed bucket
  all-to-all on the pods sub-group (``writeback_routing``) delivers each
  row to its owner pod, which writes it into its shard.

``sync_dtype`` encodes both embedding wires (the ghost all-to-all and the
write-back) with the ``federated.quant`` codec and decodes at the receiver;
the int32 ``age`` rows always travel unquantized. The merge stays the
weighted all-reduce (``sharding.fed.weighted_merge``), or the fixed
pairwise tree.

Torch neither clamps a gather nor drops a scatter, so each of the
reference's out-of-range ids is explicit: a fetch row is clamped into the
shard and masked by ``own``; a write-back slot of a dummy (``dst == P``)
goes to a scratch slot of the send buffer. A receive slot the reference
drops (the sentinel ``rows_per_pod``) repeats a real slot of the same round,
the same row with the same value, or, on a pod that receives no row this
round, writes a row's own value back (``pod_round_inputs``): the shards
hold exactly ``rows_per_pod`` rows, as the ledger counts them. The shapes
stay static, so a CUDA graph can replay the round.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.federated.partition import GhostBuckets, pod_table_padding, writeback_routing
from repro_torch.federated.quant import check_sync_dtype
from repro_torch.federated.quant import decode as quant_decode
from repro_torch.federated.quant import encode as quant_encode
from repro_torch.sharding import comm
from repro_torch.sharding.fed import (
    CLIENT_AXIS,
    REDUCES,
    axis_index,
    axis_size,
    cohort_weight_sum,
    pairwise_sum,
    unwire_rows,
    weighted_merge,
    wire_rows,
)

__all__ = [
    "POD_ARRAY_KEYS", "POD_AXIS", "build_pod_sharded_chunk", "dryrun_pod_chunk_args",
    "gather_tables", "make_pod_mesh", "pad_tables_to_pods", "pairwise_sum", "pod_axes_of",
    "pod_round_inputs", "shard_tables_to_mesh", "sync_round_gates",
]

POD_AXIS = "pods"

# client-array keys the pod-sharded executor keeps on the device. The
# "prefetched" LocalUpdate never reads ghost_owner/ghost_row (the bucketed
# exchanges already routed by them on the host)
POD_ARRAY_KEYS = ("features", "labels", "node_mask", "train_mask",
                  "nbr_idx", "nbr_mask", "ghost_mask")


def make_pod_mesh(n_pods: int, n_client_shards: Optional[int] = None, *, device=None):
    """A ``(n_pods, n_client_shards)`` mesh with ``("pods", "clients")``
    axes over the ranks of the default process group: tables shard over the
    first, each round's cohort over both. With ``n_client_shards=None`` the
    world is split evenly; the mesh must span the world. ``device=None`` is
    the card (NCCL), ``device="cpu"`` a gloo world's CPU ranks. Rank
    ``p * C + c`` sits at pod p, client shard c."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.device import resolve_device

    if n_pods < 1:
        raise ValueError(f"need n_pods >= 1, got {n_pods}")
    if not dist.is_initialized():
        raise RuntimeError("make_pod_mesh needs a process group: start the ranks with "
                           "repro_torch.sharding.ranks or torchrun")
    world = dist.get_world_size()
    if n_client_shards is None:
        if world % n_pods:
            raise ValueError(f"{world} ranks do not split into {n_pods} pods; pass "
                             "n_client_shards explicitly")
        n_client_shards = world // n_pods
    if n_pods * n_client_shards != world:
        raise ValueError(f"make_pod_mesh spans the world's {world} ranks, asked for "
                         f"{n_pods}x{n_client_shards}")
    return init_device_mesh(resolve_device(device).type, (n_pods, n_client_shards),
                            mesh_dim_names=(POD_AXIS, CLIENT_AXIS))


def pod_axes_of(mesh) -> Optional[tuple[str, str]]:
    """The (table, cohort) axis pair of a pod mesh: ``("pods", "clients")``
    when both axes are present, else None (not a pod mesh)."""
    names = tuple(mesh.mesh_dim_names or ())
    if POD_AXIS in names and CLIENT_AXIS in names:
        return (POD_AXIS, CLIENT_AXIS)
    return None


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _first_leaf(tree):
    if isinstance(tree, dict):
        return _first_leaf(next(iter(tree.values())))
    if isinstance(tree, (tuple, list)):
        return _first_leaf(tree[0])
    return tree


def pad_tables_to_pods(tables, n_pods: int):
    """Pad every (K, ...) leaf of a tree (a tuple of tables, a dict of client
    arrays) with zero rows so K splits evenly over the pods. Returns the
    same structure, the same object when K already splits."""
    K = _first_leaf(tables).shape[0]
    pad = pod_table_padding(K, n_pods)      # the bucket builder's Kp rule
    if not pad:
        return tables
    return _tree_map(lambda t: torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))]),
                     tables)


def shard_tables_to_mesh(tables, mesh):
    """This rank's pod shard of every (Kp, ...) leaf: rows ``[p·rpp,
    (p+1)·rpp)`` of pod p, the same on every client shard of the pod, as a
    copy, so the Kp-row leaf can be freed."""
    P = axis_size(mesh, POD_AXIS)
    p = axis_index(mesh, POD_AXIS)

    def shard(t):
        rpp = t.shape[0] // P
        return t[p * rpp:(p + 1) * rpp].clone()

    return _tree_map(shard, tables)


def gather_tables(shards, mesh, n_clients: int):
    """The K-row tables from every pod's shard (an all-gather on the pods
    sub-group, ``table_gather``): for a check or a checkpoint after a
    pod-sharded run, never inside one."""
    group = mesh.get_group(POD_AXIS)

    def gather(t):
        full = comm.all_gather(t.contiguous(), group, "table_gather")
        return full.reshape((-1,) + tuple(t.shape[1:]))[:n_clients]

    return _tree_map(gather, shards)


def sync_round_gates(eoffs, tau: int, local_epochs: int, *,
                     enabled: bool = True) -> np.ndarray:
    """Host-derived per-round sync predicate: does ANY of the round's J
    local epochs hit the tau schedule? Epoch j of a round with epoch offset
    e syncs iff ``(e + j) % max(tau, 1) == 0`` (the LocalUpdate's gate,
    with ``enabled = use_ghosts and not use_generator`` folding in the
    method's toggles). Rounds where it is False skip the ghost exchange
    entirely and move zero bytes for it."""
    eoffs = np.asarray(eoffs, np.int64).reshape(-1)
    if not enabled:
        return np.zeros(eoffs.shape, bool)
    t = max(int(tau), 1)
    j = np.arange(int(local_epochs), dtype=np.int64)
    return (((eoffs[:, None] + j) % t) == 0).any(axis=1)


def bucket_shard(buckets: GhostBuckets, mesh, device) -> dict:
    """This rank's part of the ghost-exchange plan, on the device: its pod's
    row of the send buckets (P, B) and its residents' receive maps (rpp,
    g_max), int32 indices and float32 masks (12 bytes an entry, the
    ledger's ``send_buckets`` and ``recv_buckets``)."""
    p, rpp = axis_index(mesh, POD_AXIS), buckets.rows_per_pod
    sl = slice(p * rpp, (p + 1) * rpp)
    host = {"send_client": buckets.send_client[p], "send_row": buckets.send_row[p],
            "send_mask": buckets.send_mask[p], "recv_src": buckets.recv_src[sl],
            "recv_pos": buckets.recv_pos[sl], "recv_mask": buckets.recv_mask[sl]}
    return {k: torch.from_numpy(np.ascontiguousarray(
                v, np.int32 if v.dtype.kind == "i" else np.float32)).to(device)
            for k, v in host.items()}


def pod_round_inputs(sel: np.ndarray, w: np.ndarray, *, n_pods: int, n_client_shards: int,
                     pod: int, client: int, rows_per_pod: int,
                     cap: int | None = None) -> tuple[dict, int]:
    """The round inputs of the rank at (``pod``, ``client``) for a chunk's
    (rounds, m) padded cohorts ``sel`` (the dummy id is Kp) with weights
    ``w``, on the host, and the write-back's bucket capacity: ``w`` /
    ``w_all`` (this slice's and the cohort's weights), ``local`` / ``own``
    (each entry's row in its owner's shard, and whether this rank
    contributes it to the fetch), ``slot`` (this pod row's entries' send
    slots, P·cap for a dummy), and the receive side of the write-back:
    received slot ``src[i]`` is written to shard row ``tgt[i]``, or where
    ``fresh[i]`` is False that row's own value is written back. A slot the
    reference drops repeats the first real slot of its round (the same row,
    the same value), so no write needs a scratch row. Indices are int32."""
    P, C, rpp = n_pods, n_client_shards, rows_per_pod
    S, m = sel.shape
    mL, msl = m // (P * C), m // P
    lo = (pod * C + client) * mL
    owner = sel // rpp
    plan = writeback_routing(sel, P, C, rpp, cap=cap)
    dst = plan.dst[:, pod * msl:(pod + 1) * msl]
    pos = plan.pos[:, pod * msl:(pod + 1) * msl]
    recv = plan.recv[:, pod].reshape(S, -1)
    real = recv < rpp
    has = real.any(axis=1)
    first = real.argmax(axis=1)
    out = {
        "w": w[:, lo:lo + mL], "w_all": w,
        "local": np.clip(sel - owner * rpp, 0, rpp - 1),
        "own": (owner == pod) & (client == 0),
        "slot": np.where(dst < P, dst * plan.cap + pos, P * plan.cap),
        "src": np.where(real, np.arange(recv.shape[1]), first[:, None]),
        "tgt": np.where(real, recv, np.where(has, recv[np.arange(S), first], 0)[:, None]),
        "fresh": real | has[:, None],
    }
    for k in ("local", "slot", "src", "tgt"):
        out[k] = out[k].astype(np.int32)
    return out, plan.cap


def _pod_step(cohort, mesh, buckets: GhostBuckets, reduce: str, sync_dtype: str = "fp32"):
    """The per-round client half over a ``("pods", "clients")`` mesh: the
    owner-keyed fetch of the cohort's statics and table rows, the gated
    ghost exchange, the prefetched LocalUpdate on this rank's slice, the
    weighted merge and the bucket-routed write-back into this pod's shard.
    """
    import torch.distributed as dist

    check_sync_dtype(sync_dtype)
    P_, C = axis_size(mesh, POD_AXIS), axis_size(mesh, CLIENT_AXIS)
    d = axis_index(mesh, POD_AXIS) * C + axis_index(mesh, CLIENT_AXIS)
    every, pods, clients = dist.group.WORLD, mesh.get_group(POD_AXIS), mesh.get_group(CLIENT_AXIS)

    def fetch(tables, inp, mL, tag):
        """Each cohort entry's rows of ``tables`` from its owner pod: the
        (pod, client shard 0) rank that owns it contributes, every rank
        receives the sum, and this rank keeps its slice."""
        words = comm.pack([t[inp["local"]] for t in tables], torch.int32)
        words = comm.all_reduce_sum(torch.where(inp["own"][:, None], words, 0), every, tag)
        return comm.unpack(words[d * mL:(d + 1) * mL],
                           [(tuple(t.shape[1:]), t.dtype) for t in tables])

    def step(params, tables, statics, gsrc, bkt, inp, tau, fanouts, eoff, streams, gate):
        mL = len(streams)
        client = dict(zip(statics, fetch(list(statics.values()), inp, mL,
                                         "fetch_psum_statics")))
        hist_l, age_l, gfeat_l, pl_l = fetch(tables, inp, mL, "fetch_psum_tables")
        hist_sh = tables[0]

        if gate:
            # this pod's row of the (P, P, B) plan, as codec payloads
            sbuf = hist_sh[bkt["send_client"], bkt["send_row"]] * bkt["send_mask"][..., None]
            q, s = quant_encode(sbuf, sync_dtype)
            parts = [q] if s is None else [q, s]
            got = comm.unpack(comm.all_to_all(comm.pack(parts), pods, "ghost_all_to_all"),
                              [(tuple(t.shape[1:]), t.dtype) for t in parts])
            rbuf = quant_decode(got[0], got[1] if s is not None else None, sync_dtype)
            gh_res = rbuf[bkt["recv_src"], bkt["recv_pos"]] * bkt["recv_mask"][..., None]
            ghs_l, gfs_l = fetch([gh_res, gsrc], inp, mL, "ghost_fetch_psum")
        else:
            # the LocalUpdate reads no ghost source on a round whose gate is off
            ghs_l = hist_sh.new_zeros((mL, gsrc.shape[1], hist_sh.shape[-1]))
            gfs_l = gsrc.new_zeros((mL,) + tuple(gsrc.shape[1:]))

        new_params, new_hist1, new_age, new_gfeat, stats = cohort(
            params, client, gfs_l, ghs_l, hist_l, age_l, gfeat_l, pl_l, tau, fanouts, eoff,
            streams)
        wsum = cohort_weight_sum(inp["w_all"], P_ * C)
        agg = weighted_merge(new_params, params, inp["w"], wsum, every, reduce)

        # the write-back. Stage 1: the pod row's cohort slice (C·mL rows)
        # across the clients axis, in device order, so slice row i is
        # cohort entry p·C·mL + i as the host routed it. Stage 2: each row
        # into its (destination pod, position) send slot (a dummy's into the
        # scratch slot past them), one all-to-all on the pods axis, and each
        # received row into this pod's shard at its host-routed target (an
        # empty slot repeats a real one, or writes a row's own value back)
        tensors, layout = wire_rows([new_hist1, new_age, new_gfeat, stats["loss_all"]],
                                    sync_dtype)
        rows = comm.all_gather(comm.pack(tensors), clients, "wb_stage1_all_gather")
        rows = rows.reshape(-1, rows.shape[-1])
        n_slots, tgt = inp["tgt"].shape[0], inp["tgt"]       # P * cap
        sbuf = rows.new_zeros((n_slots + 1, rows.shape[-1]))
        sbuf[inp["slot"]] = rows
        rbuf = comm.all_to_all(sbuf[:n_slots].reshape(P_, -1), pods, "wb_stage2_all_to_all")
        fresh = unwire_rows(rbuf.reshape(n_slots, -1)[inp["src"]], layout, sync_dtype)
        for table, new in zip(tables, fresh):
            keep = inp["fresh"].reshape((-1,) + (1,) * (new.ndim - 1))
            table[tgt] = torch.where(keep, new, table[tgt])
        return agg, stats

    return step


def build_pod_sharded_chunk(cohort, mesh, buckets: GhostBuckets, *, device,
                            reduce: str = "psum", sync_dtype: str = "fp32"):
    """The body of one pod-sharded round (the reference's chunk scans it
    over a chunk's rounds; the executor calls it per round).

    ``body(params, tables, statics, gsrc, inp, tau, fanouts, eoff, streams,
    gate)``: ``tables`` are this pod's rpp-row shards of hist1 / age /
    ghost_feat / prev_loss, ``statics`` its shards of the
    ``POD_ARRAY_KEYS`` arrays, ``gsrc`` of the ghost source features;
    ``inp`` one round of ``pod_round_inputs``; ``gate`` the round's host
    sync gate. ``cohort`` must be the ``ghost_source="prefetched"`` cohort
    LocalUpdate, built with the same ``sync_dtype``. Cohort dummies have id
    Kp (no owner pod). It writes the merged params into ``params`` and the
    fresh rows into the shards in place, and returns the slice's stats.
    ``device`` holds the exchange's routing (``body.bucket_shard``)."""
    if reduce not in REDUCES:
        raise ValueError(f"unknown reduce {reduce!r}; known: psum | pairwise")
    step = _pod_step(cohort, mesh, buckets, reduce, sync_dtype)
    bkt = bucket_shard(buckets, mesh, device)

    def body(params, tables, statics, gsrc, inp, tau, fanouts, eoff, streams, gate):
        agg, stats = step(params, tables, statics, gsrc, bkt, inp, tau, fanouts, eoff,
                          streams, gate)
        for k, buf in params.items():
            buf.copy_(agg[k])
        return stats

    body.bucket_shard = bkt         # the routing it holds (a dry run counts it)
    return body


def dryrun_pod_chunk_args(mesh, buckets: GhostBuckets, *, n_clients: int, cohort: int,
                          n_max: int, g_max: int, n_feat: int, n_classes: int, mcfg,
                          max_deg: int | None = None, wb_cap: int | None = None,
                          device="meta", seed: int = 0) -> dict:
    """This rank's arguments to ``build_pod_sharded_chunk``'s body for one
    round of ``cohort`` clients of ``n_clients`` (the counterpart of the
    reference's ``abstract_pod_chunk_args``): ``params``, ``tables`` (this
    pod's rpp-row shards, the K axis padded to Kp as ``pad_tables_to_pods``
    pads it), ``statics`` (the ``POD_ARRAY_KEYS`` shards; ``ghost_mask`` is
    the buckets' receive mask), ``gsrc`` (the ghost-source shard), ``inp``
    (``pod_round_inputs`` of a seeded cohort padded to the mesh's P·C
    ranks), ``cap`` (its write-back capacity: ``wb_cap``, by default the
    reference's worst case pow2(m_pad / P), every slice row owned by one
    pod), ``fanouts`` and ``draws`` (this slice's, one list of epochs per
    member, for ``ReplayStream``). On ``meta`` they are shapes; elsewhere
    they are drawn from ``seed``, with the padding rows zero."""
    from repro_torch.models.gcn import HIDDEN
    from repro_torch.sharding.fed import (
        DryrunFill,
        dryrun_client_arrays,
        dryrun_params,
        dryrun_round_cohort,
        dryrun_round_draws,
    )
    from repro_torch.sharding.ledger import DRYRUN_MAX_DEG

    D = DRYRUN_MAX_DEG if max_deg is None else max_deg
    P, C = axis_size(mesh, POD_AXIS), axis_size(mesh, CLIENT_AXIS)
    p, c = axis_index(mesh, POD_AXIS), axis_index(mesh, CLIENT_AXIS)
    rpp, n_tot = buckets.rows_per_pod, n_max + g_max
    fill = DryrunFill(device, seed + p)     # a pod's shard: the same on its client shards
    tables = (fill.normal((rpp, n_tot, HIDDEN[0])), fill.full((rpp, n_tot), 0, torch.int32),
              fill.normal((rpp, g_max, n_feat)), fill.full((rpp, n_max), -1.0))
    statics = dryrun_client_arrays(fill, rpp, n_max=n_max, g_max=g_max, n_feat=n_feat,
                                   n_classes=n_classes, max_deg=D, n_clients=n_clients,
                                   keys=[k for k in POD_ARRAY_KEYS if k != "ghost_mask"])
    recv_mask = buckets.recv_mask[p * rpp:(p + 1) * rpp]
    statics["ghost_mask"] = fill.host(recv_mask.astype(np.float32))
    gsrc = fill.normal((rpp, g_max, n_feat))
    if not fill.meta:
        gsrc *= statics["ghost_mask"][..., None]
        real = max(0, min(rpp, n_clients - p * rpp))     # rows past K pad the shard
        for t in (*tables, *statics.values(), gsrc):
            t[real:] = 0
    sel, w = dryrun_round_cohort(n_clients, cohort, P * C, P * rpp, seed)
    if wb_cap is None:
        wb_cap = 1 << (max(1, sel.shape[1] // P) - 1).bit_length()
    inp, cap = pod_round_inputs(sel, w, n_pods=P, n_client_shards=C, pod=p, client=c,
                                rows_per_pod=rpp, cap=wb_cap)
    mL = sel.shape[1] // (P * C)
    rounds = DryrunFill(device, seed + P + p * C + c)
    return {
        "params": dryrun_params(fill, n_feat, n_classes, seed),
        "tables": tables,
        "statics": statics,
        "gsrc": gsrc,
        "inp": {k: fill.host(v[0]) for k, v in inp.items()},
        "cap": cap,
        "fanouts": np.full(mL, mcfg.neighbor_fanout, np.int64),
        "draws": dryrun_round_draws(rounds, mcfg, mL, n_max, D),
        "sel": sel,
    }
