"""The analytic byte ledger of the sharded executors.

``pod_placement_ledger`` is a copy of the analytic part of
``repro/launch/fed_dryrun.py::pod_placement_ledger``: every per-rank
resident array and per-round collective payload of the pod-sharded round,
in bytes, grouped by what it scales with. (The reference's dry run also
lowers the chunk and reads its collectives off XLA's HLO; the port's,
``launch.fed_dryrun``, counts them as one rank's round runs.)

``round_collectives`` turns a ledger into what one round moves through
``sharding.comm``: ``{tag: (calls, bytes)}``, one call per entry, the
ghost entries only on a round whose sync gate is on. ``sharded_round_
collectives`` does the same for the client-sharded round. The executors'
counted collectives are held to these, round by round (tests,
``chip_smoke.py`` phase 14 and ``launch.fed_dryrun``).

The ledger's residents are the pod-sharded body's, entry by entry, but for
one round's inputs: ``port_round_input_bytes`` says what the port holds of
them (``launch.fed_dryrun`` holds the rank's tensors to both).
"""
from __future__ import annotations

import numpy as np

from repro_torch.federated.quant import wire_bytes
from repro_torch.models.gcn import HIDDEN, gcn_param_count
from repro_torch.sharding.tables import sync_round_gates

__all__ = ["pod_placement_ledger", "port_round_input_bytes", "round_collectives",
           "sharded_round_collectives"]

DRYRUN_MAX_DEG = 16         # the reference dry run's padded degree
SYNC_PROBE_ROUNDS = 64      # rounds the sync fraction is probed over


def _table_row(n_max: int, g_max: int, n_feat: int, sync_dtype: str = "fp32") -> int:
    """Wire bytes of one client's write-back row: hist1, age (int32, never
    quantized), ghost_feat and prev_loss."""
    n_tot, H1 = n_max + g_max, HIDDEN[0]
    return (wire_bytes((n_tot, H1), sync_dtype) + n_tot * 4
            + wire_bytes((g_max, n_feat), sync_dtype) + wire_bytes((n_max,), sync_dtype))


def pod_placement_ledger(buckets, *, n_pods: int, cohort_pad: int,
                         wb_cap: int, n_max: int, g_max: int, n_feat: int,
                         n_classes: int, tau: int, local_epochs: int,
                         max_deg: int = DRYRUN_MAX_DEG,
                         rounds: int = 1, sync_dtype: str = "fp32") -> dict:
    """The analytic placement ledger for the pod-sharded round: every
    per-rank resident array and per-round collective payload, in bytes.
    ``k_sharded`` rows are exactly ``rows_per_pod`` (= Kp/P) table rows;
    ``replicated`` / ``cohort_scaled`` entries never mention K;
    ``sync_gated`` entries move bytes only on rounds where the tau schedule
    syncs (``sync_round_gates``), and exactly 0 on the others.

    The ``quant`` section prices the three embedding wires the codec
    quantizes at ``sync_dtype``: the ghost hist1 all-to-all and both
    write-back stages, where the float tables ride as payload + scale and
    the int32 ``age`` rows stay 4-byte. Every other entry is
    dtype-independent."""
    H1 = HIDDEN[0]
    n_tot = n_max + g_max
    P, B = n_pods, buckets.bucket_size
    rpp = buckets.rows_per_pod
    m, S = cohort_pad, rounds
    n_params = gcn_param_count(n_feat, n_classes)
    # bytes of one client's table + static rows (everything the owner-keyed
    # cohort fetch moves per selected client, and the write-back returns)
    table_row = (n_tot * H1 + n_tot + g_max * n_feat + n_max) * 4
    static_row = (n_max * (n_feat + 3 + 2 * max_deg) + g_max) * 4
    k_sharded = {
        "hist1": rpp * n_tot * H1 * 4,
        "age": rpp * n_tot * 4,
        "ghost_feat": rpp * g_max * n_feat * 4,
        "prev_loss": rpp * n_max * 4,
        "features": rpp * n_max * n_feat * 4,
        "labels": rpp * n_max * 4,
        "node_mask": rpp * n_max * 4,
        "train_mask": rpp * n_max * 4,
        "nbr_idx": rpp * n_max * max_deg * 4,
        "nbr_mask": rpp * n_max * max_deg * 4,
        "ghost_mask": rpp * g_max * 4,
        "ghost_src_feat": rpp * g_max * n_feat * 4,
        "recv_buckets": rpp * g_max * 12,
    }
    replicated = {
        "params": n_params * 4,
        "cohort_stacks": S * (m * 12 + 5),     # sel/fan/w + eoff/gate
        "wb_routing": S * (m * 8 + P * P * wb_cap * 4),
    }
    ghost_cut = {"send_buckets": P * B * 12}
    eoffs = np.arange(SYNC_PROBE_ROUNDS) * local_epochs
    frac = float(sync_round_gates(eoffs, tau, local_epochs).mean())
    a2a = P * B * H1 * 4
    gfetch = m * g_max * (H1 + n_feat) * 4

    def quant_wires(d):
        return {
            "ghost_all_to_all": wire_bytes((P, B, H1), d),
            "wb_stage1_all_gather": (m // P) * _table_row(n_max, g_max, n_feat, d),
            "wb_stage2_all_to_all": P * wb_cap * _table_row(n_max, g_max, n_feat, d),
        }

    wire, fp32w = quant_wires(sync_dtype), quant_wires("fp32")
    return {
        "schema_version": 2,
        "n_pods": P,
        "table_shard_rows_per_pod": rpp,
        "ghost_cut_entries": buckets.n_entries,
        "bucket_size": B,
        "wb_cap": int(wb_cap),
        "per_device_resident_bytes": {
            "k_sharded": k_sharded,
            "replicated": replicated,
            "ghost_cut_scaled": ghost_cut,
        },
        "per_round_collective_bytes": {
            "cohort_scaled": {
                "fetch_psum_tables": m * table_row,
                "fetch_psum_statics": m * static_row,
                "merge_allreduce": n_params * 4,
                "wb_stage1_all_gather": (m // P) * table_row,
                "wb_stage2_all_to_all": P * wb_cap * table_row,
            },
            "sync_gated": {
                "ghost_all_to_all": a2a,
                "ghost_fetch_psum": gfetch,
            },
        },
        "sync": {
            "tau": int(tau),
            "local_epochs": int(local_epochs),
            "rounds_probed": SYNC_PROBE_ROUNDS,
            "sync_fraction": frac,
            "ghost_all_to_all_effective_bytes": int(round(a2a * frac)),
            "ghost_fetch_effective_bytes": int(round(gfetch * frac)),
            "non_sync_round_ghost_bytes": 0,
        },
        "quant": {
            "sync_dtype": sync_dtype,
            "wire_collective_bytes": wire,
            "fp32_collective_bytes": fp32w,
            "reduction": {k: round(fp32w[k] / wire[k], 2) for k in wire},
        },
    }


def port_round_input_bytes(*, cohort_pad: int, n_pods: int, n_client_shards: int,
                           wb_cap: int) -> dict:
    """What one rank of the pod-sharded body holds of a round's inputs
    (``sharding.tables.pod_round_inputs``), under the ledger's two entries
    for them. The ledger prices the reference's: the cohort's ids, fanouts
    and weights plus the epoch offset and the gate (``cohort_stacks``,
    m·12 + 5) and every pod's write-back routing, (dst, pos) per entry and
    the whole (P, P, cap) receive table (``wb_routing``, m·8 + P²·cap·4).
    The port keeps the fanouts, the offset and the gate on the host, routes
    on the host and hands each rank its pod's slice: ``cohort_stacks`` is
    ``w`` (m/(P·C) float32), ``w_all`` (m float32), ``local`` (m int32) and
    ``own`` (m bool); ``wb_routing`` is ``slot`` (m/P int32) and ``tgt``,
    ``src`` (P·cap int32 each) and ``fresh`` (P·cap bool). Neither depends
    on K."""
    m, P = cohort_pad, n_pods
    return {"cohort_stacks": 4 * (m // (P * n_client_shards)) + 4 * m + 4 * m + m,
            "wb_routing": 4 * (m // P) + 9 * P * wb_cap}


def _merge_entry(n_params: int, merge_reduce: str, n_ranks: int) -> dict:
    """The merge's one collective: the flat partial sums all-reduced
    (``psum``), or all-gathered from every rank (``pairwise``)."""
    if merge_reduce == "pairwise":
        return {"merge_all_gather": (1, n_ranks * n_params * 4)}
    return {"merge_allreduce": (1, n_params * 4)}


def round_collectives(ledger: dict, *, gate: bool, merge_reduce: str = "psum",
                      n_ranks: int = 1) -> dict:
    """What one pod-sharded round moves, ``{tag: (calls, bytes)}``, from its
    ``ledger``: one call per entry, the wires at the ledger's
    ``sync_dtype``; the ghost entries only when the round's ``gate`` is
    on. ``merge_reduce="pairwise"`` all-gathers the merge's partial sums
    from the ``n_ranks`` ranks instead of all-reducing them."""
    cohort = ledger["per_round_collective_bytes"]["cohort_scaled"]
    gated = ledger["per_round_collective_bytes"]["sync_gated"]
    wire = ledger["quant"]["wire_collective_bytes"]
    out = {
        "fetch_psum_tables": (1, cohort["fetch_psum_tables"]),
        "fetch_psum_statics": (1, cohort["fetch_psum_statics"]),
        "wb_stage1_all_gather": (1, wire["wb_stage1_all_gather"]),
        "wb_stage2_all_to_all": (1, wire["wb_stage2_all_to_all"]),
    }
    out.update(_merge_entry(cohort["merge_allreduce"] // 4, merge_reduce, n_ranks))
    if gate:
        out["ghost_all_to_all"] = (1, wire["ghost_all_to_all"])
        out["ghost_fetch_psum"] = (1, gated["ghost_fetch_psum"])
    return out


def sharded_round_collectives(*, cohort_pad: int, n_shards: int, n_max: int, g_max: int,
                              n_feat: int, n_classes: int, merge_reduce: str = "psum",
                              sync_dtype: str = "fp32") -> dict:
    """What one client-sharded round moves, ``{tag: (calls, bytes)}``: the
    merge over the ``n_shards`` ranks of the cohort axis, and the
    write-back's all-gather of the padded cohort's fresh rows (as codec
    payloads at ``sync_dtype``)."""
    out = _merge_entry(gcn_param_count(n_feat, n_classes), merge_reduce, n_shards)
    out["wb_all_gather"] = (1, cohort_pad * _table_row(n_max, g_max, n_feat, sync_dtype))
    return out
