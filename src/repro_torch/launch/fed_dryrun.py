"""Dry run of the paper's own workload on the production mesh (port of
``repro/launch/fed_dryrun.py``): one FedAIS round with the client cohort
sharded over 256 or 512 ranks.

It is a thin caller of the engine's own sharded round bodies: it builds
``repro_torch.sharding.fed.build_sharded_chunk``'s body (or, with ``--pods
P``, ``sharding.tables.build_pod_sharded_chunk``'s, where every K-sized
array stays resident as pod shards) and runs it on one rank's arguments
(``dryrun_chunk_args`` / ``dryrun_pod_chunk_args``), so the dry run and a
real sharded run share one code path.

    PYTHONPATH=src python -m repro_torch.launch.fed_dryrun --mesh pod1
    PYTHONPATH=src python -m repro_torch.launch.fed_dryrun --mesh both --pods 16

Where the reference forces 256 or 512 placeholder XLA devices, lowers the
chunk and reads its collectives out of the HLO, the port starts torch's
fake process group of that many ranks (``launch.mesh.start_fake_world``)
and walks one rank's program on ``meta`` tensors, computing nothing: each
collective goes through ``sharding.comm``, which counts its calls and bytes
per tag and kind (``comm.collective_stats``), so the bytes are read off the
program that runs. The sync gate is a host bool in the port (the
reference's ``lax.cond``), so the walk runs one round with the gate on and
one with it off, under ``FlopCounterMode``, ``launch.dryrun.StepLedger``
and the counters, and holds what they count to the ledger:

* each round's ``{tag: (calls, bytes)}`` equals
  ``sharding.ledger.round_collectives(ledger, gate=...)`` (client-sharded:
  ``sharded_round_collectives``), so the gate-off round's 0 ghost bytes are
  measured;
* the bytes of the tensors the rank holds equal the ledger's
  ``per_device_resident_bytes``, entry by entry, except two entries whose
  layout differs: the round inputs ``cohort_stacks`` / ``wb_routing``, held
  to ``sharding.ledger.port_round_input_bytes``.

``validate_fed_dryrun``, ``assert_k_flat`` and ``assert_quant_bytes`` are
the reference's, with the same messages (their "HLO" column is the counted
``collectives`` here):

    PYTHONPATH=src python -m repro_torch.launch.fed_dryrun --mesh host \\
        --force-devices 8 --pods 8 --clients 100000 --assert-k-flat 10000 \\
        --cohort 64 --n-max 64 --g-max 8 --features 32
    PYTHONPATH=src python -m repro_torch.launch.fed_dryrun --mesh host \\
        --force-devices 8 --pods 8 --clients 1024 --assert-quant-bytes \\
        --cohort 64 --n-max 64 --g-max 8 --features 32

``--mesh host`` without ``--force-devices`` runs on the real world instead
(a running process group, e.g. ``torchrun``'s, or else one rank of its
own): real tensors on the card (``--device cpu``: a gloo rank), each round
also timed after a synchronise. Row keys that differ from the reference's:
``walk_s`` takes the place of ``compile_s``; ``collective_source`` is
``"counted"``; ``collectives`` holds the gate-on round's bytes by kind (the
reference's HLO holds both branches of the gate, so every collective once);
``memory`` holds the walk's peak of live bytes and the resident bytes;
``rounds``, ``residents``, ``checks`` (and ``timed`` on a real world) are
new. Importing this module starts no process group.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.api.registry import method_config
from repro_torch.core.fedais import ReplayStream, make_cohort_update
from repro_torch.federated.partition import ghost_exchange_buckets
from repro_torch.federated.quant import SYNC_DTYPES
from repro_torch.launch.dryrun import StepLedger
from repro_torch.launch.mesh import production_chip_count, start_fake_world, stop_world
from repro_torch.models.gcn import gcn_flops_per_node, gcn_param_count
from repro_torch.sharding import comm
from repro_torch.sharding.fed import (
    build_sharded_chunk,
    client_axis_of,
    cohort_padding,
    dryrun_chunk_args,
    make_client_mesh,
)
from repro_torch.sharding.ledger import (
    DRYRUN_MAX_DEG,
    SYNC_PROBE_ROUNDS,
    pod_placement_ledger,
    port_round_input_bytes,
    round_collectives,
    sharded_round_collectives,
)
from repro_torch.sharding.tables import (
    build_pod_sharded_chunk,
    dryrun_pod_chunk_args,
    make_pod_mesh,
    sync_round_gates,
)
from repro_torch.utils.roofline import RooflineReport

# chip counts come from the production mesh definition (launch/mesh.py)
MESH_CHIPS = {
    "pod1": production_chip_count(multi_pod=False),
    "pod2": production_chip_count(multi_pod=True),
}
COLLECTIVE_SOURCE = "counted"


def synthetic_ghost_buckets(n_clients: int, n_max: int, g_max: int,
                            n_pods: int, *, fill: float = 1.0, seed: int = 0):
    """A partition-shaped ghost topology for the pod round without real
    data: each client's ghost slots point at uniform random (owner, row)
    pairs, ``fill`` controlling the occupied fraction (the ghost-cut knob
    the write-back bytes should track). The reference's numpy draws."""
    rng = np.random.default_rng(seed)
    mask = (rng.random((n_clients, g_max)) < fill).astype(np.float32)
    owner = rng.integers(0, n_clients, size=(n_clients, g_max)).astype(np.int32)
    owner = np.where(mask > 0, owner, -1)
    row = rng.integers(0, n_max, size=(n_clients, g_max)).astype(np.int32)
    return ghost_exchange_buckets(owner, row, mask, n_pods)


_POD_LEDGER_KEYS = ("schema_version", "n_pods", "table_shard_rows_per_pod",
                    "ghost_cut_entries", "bucket_size", "wb_cap",
                    "per_device_resident_bytes",
                    "per_round_collective_bytes", "sync", "quant",
                    "all_to_all_bytes", "all_gather_bytes")
# the fp32 column of the quant section must restate these nominal entries
_QUANT_NOMINAL = {"ghost_all_to_all": ("sync_gated", "ghost_all_to_all"),
                  "wb_stage1_all_gather": ("cohort_scaled",
                                           "wb_stage1_all_gather"),
                  "wb_stage2_all_to_all": ("cohort_scaled",
                                           "wb_stage2_all_to_all")}
_TOP_KEYS = ("status", "arch", "mesh", "chips", "clients", "cohort",
             "collectives", "roofline")


def validate_fed_dryrun(result: dict) -> list[str]:
    """Schema-check a fed_dryrun result row before it is written. Returns a
    list of problems (empty = valid): required keys present and typed,
    every ledger class a dict of non-negative ints, the sync fraction in
    [0, 1], the non-sync-round ghost bytes pinned to 0, and the quant
    section's fp32 column restating the nominal collective entries (with
    the wire column never exceeding it, and equal to it at fp32)."""
    errs: list[str] = []
    if not isinstance(result, dict):
        return [f"result is {type(result).__name__}, expected dict"]
    for k in _TOP_KEYS:
        if k not in result:
            errs.append(f"missing key {k!r}")
    if errs:
        return errs
    if not isinstance(result["collectives"], dict):
        errs.append("collectives must be a dict of byte counts")
    if "pods" not in result:
        return errs
    pods = result["pods"]
    if not isinstance(pods, dict):
        return errs + ["pods must be a dict"]
    for k in _POD_LEDGER_KEYS:
        if k not in pods:
            errs.append(f"pods missing key {k!r}")
    if errs:
        return errs
    for section in ("per_device_resident_bytes",
                    "per_round_collective_bytes"):
        for cls, entries in pods[section].items():
            if not isinstance(entries, dict) or not entries:
                errs.append(f"pods.{section}.{cls} must be a non-empty dict")
                continue
            for name, v in entries.items():
                if not isinstance(v, int) or v < 0:
                    errs.append(f"pods.{section}.{cls}.{name} must be a "
                                f"non-negative int, got {v!r}")
    sync = pods["sync"]
    frac = sync.get("sync_fraction")
    if not isinstance(frac, (int, float)) or not 0.0 <= frac <= 1.0:
        errs.append(f"pods.sync.sync_fraction must be in [0, 1], got {frac!r}")
    if sync.get("non_sync_round_ghost_bytes") != 0:
        errs.append("pods.sync.non_sync_round_ghost_bytes must be 0 "
                    "(the ghost exchange is gated off entirely)")
    a2a = sync.get("ghost_all_to_all_effective_bytes")
    nominal = pods["per_round_collective_bytes"]["sync_gated"].get(
        "ghost_all_to_all", 0)
    if not isinstance(a2a, int) or a2a != int(round(nominal * frac)):
        errs.append("pods.sync.ghost_all_to_all_effective_bytes must equal "
                    "ghost_all_to_all x sync_fraction")
    quant = pods["quant"]
    dtype = quant.get("sync_dtype")
    if dtype not in SYNC_DTYPES:
        errs.append(f"pods.quant.sync_dtype must be one of {SYNC_DTYPES}, "
                    f"got {dtype!r}")
    wire = quant.get("wire_collective_bytes", {})
    fp32w = quant.get("fp32_collective_bytes", {})
    for name, (cls, nom_key) in _QUANT_NOMINAL.items():
        w, f = wire.get(name), fp32w.get(name)
        if not isinstance(w, int) or w <= 0:
            errs.append(f"pods.quant.wire_collective_bytes.{name} must be a "
                        f"positive int, got {w!r}")
            continue
        nom = pods["per_round_collective_bytes"][cls].get(nom_key)
        if f != nom:
            errs.append(f"pods.quant.fp32_collective_bytes.{name} must "
                        f"restate {cls}.{nom_key} ({nom}), got {f!r}")
        if w > f:
            errs.append(f"pods.quant.wire_collective_bytes.{name} ({w}) "
                        f"exceeds its fp32 nominal ({f})")
        if dtype == "fp32" and w != f:
            errs.append(f"pods.quant.{name}: fp32 wire must be bit-inert "
                        f"({w} != {f})")
    return errs


def assert_k_flat(res_a: dict, res_b: dict) -> list[str]:
    """The K-flatness contract between two dry runs that differ ONLY in
    ``--clients``: every replicated resident and every cohort-scaled
    collective must be byte-identical, the k_sharded residents must scale
    exactly with rows_per_pod (= Kp/P), and the counted all-gather /
    all-reduce byte totals (write-back stage 1 + cohort fetch all-reduces +
    merge, the only members of those kinds) must not move. Returns a list
    of violations (empty = the placement is K-flat)."""
    errs: list[str] = []
    pa, pb = res_a["pods"], res_b["pods"]
    ka, kb = res_a["clients"], res_b["clients"]
    for section, cls in (("per_device_resident_bytes", "replicated"),
                         ("per_round_collective_bytes", "cohort_scaled")):
        ea, eb = pa[section][cls], pb[section][cls]
        for name in sorted(set(ea) | set(eb)):
            if ea.get(name) != eb.get(name):
                errs.append(
                    f"{cls}.{name}: {ea.get(name)}B at K={ka} vs "
                    f"{eb.get(name)}B at K={kb} — scales with K")
    gf_a = pa["per_round_collective_bytes"]["sync_gated"]["ghost_fetch_psum"]
    gf_b = pb["per_round_collective_bytes"]["sync_gated"]["ghost_fetch_psum"]
    if gf_a != gf_b:
        errs.append(f"sync_gated.ghost_fetch_psum: {gf_a}B vs {gf_b}B — "
                    "scales with K")
    ra, rb = pa["table_shard_rows_per_pod"], pb["table_shard_rows_per_pod"]
    for name, va in pa["per_device_resident_bytes"]["k_sharded"].items():
        vb = pb["per_device_resident_bytes"]["k_sharded"].get(name, -1)
        if va * rb != vb * ra:
            errs.append(f"k_sharded.{name}: {va}B/{ra} rows vs {vb}B/{rb} "
                        "rows — not linear in K/P")
    for kind in ("all-gather", "all-reduce"):
        ba = res_a["collectives"].get(kind, 0)
        bb = res_b["collectives"].get(kind, 0)
        if ba != bb:
            errs.append(f"HLO {kind}: {ba}B at K={ka} vs {bb}B at K={kb} — "
                        "a lowered collective scales with K")
    return errs


def assert_quant_bytes(res_fp32: dict, res_int8: dict) -> list[str]:
    """The quantized-wire contract between two dry runs that differ ONLY in
    ``--sync-dtype`` (fp32 vs int8): every quantized embedding wire (the
    ghost all-to-all and both write-back stages) must cost at most half its
    fp32 bytes, by the ledger's quant section and by the counted
    all-to-all / all-gather totals, while the per-device resident ledger
    stays byte-identical (tables are stored fp32; only the wire narrows).
    Returns violations (empty = int8 halves the embedding sync)."""
    errs: list[str] = []
    pa, pb = res_fp32["pods"], res_int8["pods"]
    qa = pa["quant"]["wire_collective_bytes"]
    qb = pb["quant"]["wire_collective_bytes"]
    for name in sorted(qa):
        if qb[name] * 2 > qa[name]:
            errs.append(f"quant.{name}: int8 wire {qb[name]}B is not <= "
                        f"half of fp32 {qa[name]}B")
    for kind in ("all-to-all", "all-gather"):
        ba = res_fp32["collectives"].get(kind, 0)
        bb = res_int8["collectives"].get(kind, 0)
        if bb * 2 > ba:
            errs.append(f"HLO {kind}: int8 lowers to {bb}B, not <= half of "
                        f"fp32's {ba}B — the wire is not quantized")
    if pa["per_device_resident_bytes"] != pb["per_device_resident_bytes"]:
        errs.append("per_device_resident_bytes differ between fp32 and int8 "
                    "— residents must stay fp32 regardless of wire dtype")
    return errs


# -- the walk ------------------------------------------------------------------

def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def held_residents(args: dict, body) -> dict:
    """The bytes of the tensors one rank of the pod-sharded round holds,
    under the ledger's classes and entry names: its shards, its bucket
    routing (``body.bucket_shard``), the params and one round's inputs."""
    hist1, age, ghost_feat, prev_loss = args["tables"]
    bkt, inp = body.bucket_shard, args["inp"]
    return {
        "k_sharded": {
            "hist1": _nbytes([hist1]), "age": _nbytes([age]),
            "ghost_feat": _nbytes([ghost_feat]), "prev_loss": _nbytes([prev_loss]),
            **{k: _nbytes([v]) for k, v in args["statics"].items()},
            "ghost_src_feat": _nbytes([args["gsrc"]]),
            "recv_buckets": _nbytes([bkt[k] for k in ("recv_src", "recv_pos", "recv_mask")]),
        },
        "replicated": {
            "params": _nbytes(args["params"].values()),
            "cohort_stacks": _nbytes([inp[k] for k in ("w", "w_all", "local", "own")]),
            "wb_routing": _nbytes([inp[k] for k in ("slot", "tgt", "src", "fresh")]),
        },
        "ghost_cut_scaled": {
            "send_buckets": _nbytes([bkt[k] for k in ("send_client", "send_row",
                                                      "send_mask")]),
        },
    }


def resident_problems(held: dict, ledger: dict, port_inputs: dict) -> list[str]:
    """Each entry of ``held`` against the ledger's: equal, except the round
    inputs ``cohort_stacks`` / ``wb_routing``, held to ``port_inputs`` (the
    port routes on the host and hands each rank its pod's slice, where the
    ledger prices the reference's replicated stacks)."""
    errs = []
    for cls, entries in ledger["per_device_resident_bytes"].items():
        if set(entries) != set(held.get(cls, {})):
            errs.append(f"residents.{cls}: held {sorted(held.get(cls, {}))} vs ledger "
                        f"{sorted(entries)}")
            continue
        for name, want in entries.items():
            if cls == "replicated" and name in port_inputs:
                want = port_inputs[name]
            if held[cls][name] != want:
                errs.append(f"residents.{cls}.{name}: the rank holds {held[cls][name]}B, "
                            f"the ledger says {want}B")
    return errs


def _sync_eoffs(tau: int, local_epochs: int) -> tuple[int, int | None]:
    """The epoch offsets of the first round whose sync gate is on and of
    the first whose gate is off (None when every round syncs: tau <= J)."""
    eoffs = np.arange(SYNC_PROBE_ROUNDS) * local_epochs
    gates = sync_round_gates(eoffs, tau, local_epochs)
    off = eoffs[~gates]
    return int(eoffs[gates][0]), (int(off[0]) if off.size else None)


def walk_round(call) -> dict:
    """Run one round under ``FlopCounterMode``, a ``StepLedger`` and the
    collective counters: its counts, FLOPs, bytes, peak of live bytes and
    seconds."""
    from torch.utils.flop_counter import FlopCounterMode

    t0 = time.perf_counter()
    before = comm.snapshot()
    steps = StepLedger()
    with FlopCounterMode(display=False) as flops, steps:
        call()
    return {"counts": comm.diff(comm.snapshot(), before),
            "flops": float(flops.get_total_flops()), "bytes": float(steps.bytes),
            "activation_peak_bytes": steps.peak_bytes,
            "walk_s": time.perf_counter() - t0}


def time_round(call, device: torch.device) -> dict:
    """Run one round plainly, timed between two synchronises: its counts
    and milliseconds."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    before = comm.snapshot()
    sync()
    t0 = time.perf_counter()
    call()
    sync()
    return {"counts": comm.diff(comm.snapshot(), before),
            "ms": (time.perf_counter() - t0) * 1e3}


def _json_counts(counts: dict) -> dict:
    return {k: [int(c), int(b)] for k, (c, b) in sorted(counts.items())}


def dryrun_mesh(mesh_name: str, args, *, device="meta") -> dict:
    """One rank's sharded round on the running world (the production chip
    count for pod1 / pod2), walked on ``device``'s tensors: a gate-on and a
    gate-off round, counted and held to the ledger; on a real device each
    round is also run plainly and timed. Returns the result row (status
    "ok"; ``checks`` lists what disagreed with the ledger)."""
    import torch.distributed as dist

    device = torch.device(device)
    chips = dist.get_world_size()
    if MESH_CHIPS.get(mesh_name, chips) != chips:
        raise RuntimeError(f"{mesh_name} needs a world of {MESH_CHIPS[mesh_name]} ranks, "
                           f"{chips} running")
    K = args.clients or chips
    m = args.cohort or K
    pods = args.pods
    mcfg = method_config("fedais", local_epochs=4, batch_cap=args.n_max)
    pad = cohort_padding(m, chips)
    sync_dtype = getattr(args, "sync_dtype", "fp32")
    mesh_dev = "cpu" if device.type == "meta" else device
    shape = dict(n_clients=K, cohort=m, n_max=args.n_max, g_max=args.g_max,
                 n_feat=args.features, n_classes=args.classes, mcfg=mcfg,
                 max_deg=DRYRUN_MAX_DEG, device=device)
    ledger = None
    if pods:
        if chips % pods:
            raise ValueError(f"{chips} chips do not split into {pods} pods")
        mesh = make_pod_mesh(pods, chips // pods, device=mesh_dev)
        buckets = synthetic_ghost_buckets(K, args.n_max, args.g_max, pods,
                                          fill=args.ghost_fill)
        cohort = make_cohort_update(mcfg, args.n_max, sync_dtype=sync_dtype,
                                    ghost_source="prefetched")
        body = build_pod_sharded_chunk(cohort, mesh, buckets, device=device,
                                       sync_dtype=sync_dtype)
        a = dryrun_pod_chunk_args(mesh, buckets, **shape)
        ledger = pod_placement_ledger(
            buckets, n_pods=pods, cohort_pad=m + pad, wb_cap=a["cap"], n_max=args.n_max,
            g_max=args.g_max, n_feat=args.features, n_classes=args.classes, tau=args.tau,
            local_epochs=mcfg.local_epochs, sync_dtype=sync_dtype)

        def run(eoff, gate):
            streams = [ReplayStream(e) for e in a["draws"]]
            body(a["params"], a["tables"], a["statics"], a["gsrc"], a["inp"], args.tau,
                 a["fanouts"], eoff, streams, gate)
    else:
        mesh = make_client_mesh(chips, device=mesh_dev)
        cohort = make_cohort_update(mcfg, args.n_max, sync_dtype=sync_dtype)
        body = build_sharded_chunk(cohort, mesh, client_axis_of(mesh), sync_dtype=sync_dtype)
        a = dryrun_chunk_args(mesh, **shape)

        def run(eoff, gate):
            streams = [ReplayStream(e) for e in a["draws"]]
            body(a["params"], a["tables"], a["arrays"], a["inp"], args.tau, a["fanouts"],
                 eoff, streams)

    on, off = _sync_eoffs(args.tau, mcfg.local_epochs)
    rounds, checks = {}, []
    for name, eoff, gate in (("gate_on", on, True), ("gate_off", off, False)):
        if eoff is None:
            continue
        w = walk_round(lambda: run(eoff, gate))
        if pods:
            want = round_collectives(ledger, gate=gate)
        else:
            want = sharded_round_collectives(
                cohort_pad=m + pad, n_shards=chips, n_max=args.n_max, g_max=args.g_max,
                n_feat=args.features, n_classes=args.classes, sync_dtype=sync_dtype)
        if w["counts"] != want:
            checks.append(f"{name}: counted {w['counts']}, the ledger says {want}")
        rounds[name] = {**w, "eoff": eoff, "counts": _json_counts(w["counts"]),
                        "ledger": _json_counts(want)}
    walked = rounds["gate_on"]
    coll = comm.collective_stats({k: tuple(v) for k, v in walked["counts"].items()})

    n_params = gcn_param_count(args.features, args.classes)
    # per-round model flops: J epochs x batch fwd+bwd over the m-cohort
    flops_model = 3.0 * gcn_flops_per_node(args.features, args.classes, 8.0) \
        * args.n_max * mcfg.local_epochs * m
    rep = RooflineReport(
        arch="fedgcn-graphsage", shape=f"K{K}", mesh=mesh_name, chips=chips,
        hlo_flops=walked["flops"] * chips, hlo_bytes=walked["bytes"] * chips,
        collective_bytes=float(coll.total_bytes) * chips, model_flops=flops_model)
    result = {
        "status": "ok", "arch": "fedgcn-graphsage", "shape": f"K{K}",
        "mesh": mesh_name, "chips": chips, "clients": K, "cohort": m,
        "cohort_pad": pad, "sync_dtype": sync_dtype, "device": device.type,
        "gcn_params": n_params,
        "walk_s": sum(r["walk_s"] for r in rounds.values()),
        "collective_source": COLLECTIVE_SOURCE,
        "collectives": {k: int(v) for k, v in coll.bytes_by_kind.items()},
        "roofline": rep.row(),
        "memory": {"activation_peak_bytes": max(r["activation_peak_bytes"]
                                                for r in rounds.values())},
        "rounds": rounds,
    }
    if pods:
        held = held_residents(a, body)
        port_inputs = port_round_input_bytes(cohort_pad=m + pad, n_pods=pods,
                                             n_client_shards=chips // pods, wb_cap=a["cap"])
        checks += resident_problems(held, ledger, port_inputs)
        ledger["all_to_all_bytes"] = int(coll.bytes_by_kind.get("all-to-all", 0))
        ledger["all_gather_bytes"] = int(coll.bytes_by_kind.get("all-gather", 0))
        result["pods"] = ledger
        result["residents"] = {"held": held, "port_round_inputs": port_inputs}
        result["memory"]["resident_bytes"] = sum(sum(e.values()) for e in held.values())
    if device.type != "meta":
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        timed = {}
        for name, r in rounds.items():
            t = time_round(lambda: run(r["eoff"], name == "gate_on"), device)
            if _json_counts(t["counts"]) != r["counts"]:
                checks.append(f"{name}: the timed round counted {t['counts']}, its walk "
                              f"{r['counts']}")
            timed[name] = {"ms": t["ms"], "counts": _json_counts(t["counts"])}
        if device.type == "cuda":
            timed["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
            timed["device_name"] = torch.cuda.get_device_name(device)
        result["timed"] = timed
    result["checks"] = checks
    print(rep.pretty())
    print(f"    [{mesh_name}] K={K}" + (f" pods={pods}" if pods else "")
          + f" walk={result['walk_s']:.1f}s collectives: {coll.summary()}")
    if pods:
        p = result["pods"]
        resid = p["per_device_resident_bytes"]
        print(f"    [{mesh_name}] K/P={p['table_shard_rows_per_pod']} rows/pod "
              f"({sum(resid['k_sharded'].values()):,}B sharded, "
              f"{sum(resid['replicated'].values()):,}B replicated); "
              f"ghost a2a {p['sync']['ghost_all_to_all_effective_bytes']:,}B "
              f"effective at sync fraction {p['sync']['sync_fraction']:.2f} "
              f"(counted 0B on the gate-off round)")
        q = p["quant"]
        if q["sync_dtype"] != "fp32":
            cuts = ", ".join(
                f"{name} {q['wire_collective_bytes'][name]:,}B "
                f"({q['reduction'][name]}x)"
                for name in sorted(q["wire_collective_bytes"]))
            print(f"    [{mesh_name}] {q['sync_dtype']} wire: {cuts}")
    for name, t in result.get("timed", {}).items():
        if isinstance(t, dict):
            print(f"    [{mesh_name}] {name} round on {device}: {t['ms']:.1f} ms")
    return result


# -- worlds ------------------------------------------------------------------

class _World:
    """The process group one mesh's dry run runs in: a fake world of
    ``n`` ranks (walked on meta tensors), or the real world: a running
    group (``torchrun``), else one rank of its own (NCCL on the card, gloo
    on the CPU). Stops what it started."""

    def __init__(self, fake: int | None, device):
        self.fake, self.device, self.started = fake, device, False

    def __enter__(self):
        import torch.distributed as dist

        if self.fake:
            start_fake_world(self.fake)
            self.started = True
            return torch.device("meta")
        from repro_torch.device import resolve_device

        dev = resolve_device(self.device)
        if not dist.is_initialized():
            backend = "nccl" if dev.type == "cuda" else "gloo"
            if "WORLD_SIZE" in os.environ:
                dist.init_process_group(backend)
            else:
                dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                        world_size=1)
            self.started = True
        if dev.type == "cuda":
            dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        return dev

    def __exit__(self, *exc):
        if self.started:
            stop_world()
        return False


def _world_size(mesh_name: str, args) -> int | None:
    """The fake world's size, or None for the real world."""
    if mesh_name in MESH_CHIPS:
        return MESH_CHIPS[mesh_name]
    return args.force_devices or None


def build_parser() -> argparse.ArgumentParser:
    """The reference's CLI, with ``--force-devices`` for the fake world's
    size and ``--device`` for the real world's."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod1",
                    choices=["pod1", "pod2", "both", "host"],
                    help="pod chip counts (a fake world of 256 / 512 ranks), or 'host' = "
                         "the real world (or a fake one of --force-devices ranks)")
    ap.add_argument("--clients", type=int, default=0, help="default: one per chip")
    ap.add_argument("--cohort", type=int, default=0,
                    help="clients selected per round (default: all K) — fix "
                         "it while sweeping --clients to see which "
                         "collectives scale with the total client count")
    ap.add_argument("--pods", type=int, default=0,
                    help="shard the historical tables over this many pods "
                         "(a ('pods','clients') 2-D mesh; 0 = replicated "
                         "tables, cohort-only sharding)")
    ap.add_argument("--ghost-fill", type=float, default=0.5,
                    help="occupied fraction of ghost slots in the synthetic "
                         "pod topology — the ghost-cut knob the --pods "
                         "write-back bytes should track")
    ap.add_argument("--tau", type=int, default=8,
                    help="staleness threshold for the --pods ledger's sync "
                         "fraction (the tau schedule gates the ghost "
                         "all-to-all; with J=4 local epochs tau=8 syncs "
                         "every other round)")
    ap.add_argument("--assert-k-flat", type=int, default=0, metavar="K2",
                    help="with --pods: walk the round a second time at K2 "
                         "clients and fail unless every replicated resident "
                         "and cohort-scaled collective is byte-identical "
                         "(the proof that nothing scales with K)")
    ap.add_argument("--sync-dtype", default="fp32", choices=list(SYNC_DTYPES),
                    help="wire format for the embedding sync (repro_torch."
                         "federated.quant): ghost all-to-all + write-back "
                         "exchange payloads; fp32 is bit-inert")
    ap.add_argument("--assert-quant-bytes", action="store_true",
                    help="with --pods: walk the round at fp32 AND int8 and "
                         "fail unless int8 at least halves the ghost "
                         "all-to-all + write-back bytes (ledger and counted "
                         "collectives) with per-device residents byte-identical")
    ap.add_argument("--n-max", type=int, default=512)
    ap.add_argument("--g-max", type=int, default=256)
    ap.add_argument("--features", type=int, default=128)
    ap.add_argument("--classes", type=int, default=41)   # reddit-like
    ap.add_argument("--force-devices", type=int, default=None,
                    help="with --mesh host: walk on a fake world of N ranks "
                         "(0 or unset: the real world); the pod meshes always "
                         "walk on a fake world of their chip count")
    ap.add_argument("--device", default=None,
                    help="the real world's device (default: the card; 'cpu' for a "
                         "gloo rank)")
    ap.add_argument("--out", default=None)
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)

    if args.assert_k_flat and not (args.pods and args.clients):
        ap.error("--assert-k-flat needs --pods and an explicit --clients")
    if args.assert_quant_bytes and not args.pods:
        ap.error("--assert-quant-bytes needs --pods")

    meshes = ["pod1", "pod2"] if args.mesh == "both" else [args.mesh]
    rc = 0
    for mesh_name in meshes:
        with _World(_world_size(mesh_name, args), args.device) as device:
            rc |= _run_mesh(mesh_name, args, device)
    return rc


def _run_mesh(mesh_name: str, args, device) -> int:
    """One mesh's dry run and its contracts; 0 when all hold."""
    try:
        result = dryrun_mesh(mesh_name, args, device=device)
    except Exception as e:
        print(f"[{mesh_name}] ERROR: {type(e).__name__}: {e}")
        return 1
    problems = validate_fed_dryrun(result) + result["checks"]
    if problems:
        print(f"[{mesh_name}] INVALID result, not writing:")
        for p in problems:
            print(f"    - {p}")
        return 1
    if args.assert_k_flat:
        args2 = argparse.Namespace(**{**vars(args), "clients": args.assert_k_flat})
        try:
            result2 = dryrun_mesh(mesh_name, args2, device=device)
        except Exception as e:
            print(f"[{mesh_name}] ERROR at K={args.assert_k_flat}: "
                  f"{type(e).__name__}: {e}")
            return 1
        violations = validate_fed_dryrun(result2) + result2["checks"] \
            + assert_k_flat(result, result2)
        if violations:
            print(f"[{mesh_name}] K-FLATNESS VIOLATED "
                  f"(K={args.clients} vs K={args.assert_k_flat}):")
            for v in violations:
                print(f"    - {v}")
            return 1
        print(f"    [{mesh_name}] K-flat: replicated residents, "
              f"cohort-scaled collectives, and counted all-gather/"
              f"all-reduce bytes identical at K={args.clients} and "
              f"K={args.assert_k_flat}; k_sharded exactly linear in K/P")
    if args.assert_quant_bytes:
        variants = {args.sync_dtype: result}
        try:
            for d in ("fp32", "int8"):
                if d not in variants:
                    args_d = argparse.Namespace(**{**vars(args), "sync_dtype": d})
                    variants[d] = dryrun_mesh(mesh_name, args_d, device=device)
        except Exception as e:
            print(f"[{mesh_name}] ERROR walking a quant variant: "
                  f"{type(e).__name__}: {e}")
            return 1
        violations = [p for v in variants.values() for p in v["checks"]] \
            + assert_quant_bytes(variants["fp32"], variants["int8"])
        if variants["fp32"]["residents"]["held"] != variants["int8"]["residents"]["held"]:
            violations.append("the rank's held residents differ between fp32 and int8")
        if violations:
            print(f"[{mesh_name}] QUANT-BYTES CONTRACT VIOLATED "
                  f"(fp32 vs int8):")
            for v in violations:
                print(f"    - {v}")
            return 1
        c32, c8 = (variants[d]["collectives"] for d in ("fp32", "int8"))
        print(f"    [{mesh_name}] quant-bytes: int8 cuts the counted "
              f"all-to-all {c32.get('all-to-all', 0):,}B -> "
              f"{c8.get('all-to-all', 0):,}B and all-gather "
              f"{c32.get('all-gather', 0):,}B -> "
              f"{c8.get('all-gather', 0):,}B (>= 2x each); per-device "
              f"residents byte-identical")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        tag = f"_pods{args.pods}" if args.pods else ""
        with open(os.path.join(args.out, f"fedgcn_{mesh_name}{tag}.json"), "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
