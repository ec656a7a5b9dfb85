"""Chaos harness: seeded fault scenarios end to end, degradation proven.

Port of ``repro/launch/fed_chaos.py``. Runs the fault-tolerance story
against one small federation:

1. a fault-free baseline per scheduler (stepwise / fused / async);
2. a seeded scenario matrix (dropout x straggler x corruption) through
   every scheduler, checking that each run completes all rounds
   crash-free with finite merged params and bounded accuracy degradation
   (``--acc-bound`` against the scheduler's own baseline);
3. serve-side chaos: a torn newest checkpoint (``load_latest`` must fall
   back to the previous step), poisoned streaming features (the fresh
   path must fall back to the warm historical cache) and an over-capacity
   open loop (admission control must shed, not stall);

then writes the schema-checked ledger (``--out``, by default
``BENCH_faults_torch.json`` at the repo root; the reference's
``BENCH_faults.json`` is its own)::

    PYTHONPATH=src python -m repro_torch.launch.fed_chaos --quick --device cpu

When two or more ranks run it (``torchrun --nproc-per-node N -m
repro_torch.launch.fed_chaos``, or ``run_sharded_rows`` on the ranks of a
``sharding.ranks.RankPool``), it adds the reference's third step: a
baseline and a dropout scenario through the client-sharded executor
(``FedEngine(mesh=...)`` on a ``("clients",)`` mesh over every rank,
NCCL on the card and gloo with ``--device cpu``; rank 0 writes the
ledger). On one rank it says in one line that it skips them. The device is
``cuda:0`` (each rank's own card under ``torchrun``) unless ``--device``
names another; the poisoned features are written into the model's feature
buffer in place (and restored in place), since the query engine's CUDA
graphs read that buffer.

Exit status is non-zero on any crash, non-finite merged params, an
accuracy delta beyond the bound, an unrecovered torn checkpoint or a
poisoned fresh path that did not degrade.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import tempfile

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

# the faults ledger's schema (see validate_bench_faults)
_TOP_KEYS = ("bench", "devices", "quick", "seed", "dataset", "scale",
             "clients", "rounds", "cohort", "method", "acc_bound",
             "max_acc_delta", "crashes", "all_finite", "rows", "serve", "ckpt")
_ROW_KEYS = ("scenario", "scheduler", "executor", "dropout", "straggler_frac",
             "corrupt", "corrupt_mode", "baseline_acc", "final_acc",
             "acc_delta", "rounds_completed", "params_finite", "crashed",
             "faults")
_SERVE_KEYS = ("n_fallbacks", "n_degraded", "n_rejected", "n_shed",
               "fresh_fell_back", "fallback_finite", "fallback_matches_warm",
               "h1_finite_frac")
_CKPT_KEYS = ("torn_step", "recovered_step", "recovered")

# (dropout, straggler_frac, corrupt) per scenario; the quick matrix is the
# CI smoke, the full matrix adds harsher rates and finite ("scale") poison
_QUICK_SCENARIOS = [(0.3, 0.0, 0.0), (0.0, 0.25, 0.0), (0.0, 0.0, 0.2),
                    (0.3, 0.25, 0.2)]
_FULL_EXTRA = [(0.5, 0.0, 0.0), (0.5, 0.5, 0.3)]


def validate_bench_faults(payload) -> list[str]:
    """Schema-check a faults ledger payload. Returns a list of problems
    (empty = valid)."""
    errs: list[str] = []
    if not isinstance(payload, dict):
        return [f"payload is {type(payload).__name__}, expected dict"]
    for k in _TOP_KEYS:
        if k not in payload:
            errs.append(f"missing key {k!r}")
    if errs:
        return errs
    if payload["bench"] != "fault_tolerance":
        errs.append(f"bench is {payload['bench']!r}, expected 'fault_tolerance'")
    if not isinstance(payload["devices"], int) or payload["devices"] < 1:
        errs.append(f"devices must be a positive int, got {payload['devices']!r}")
    if not isinstance(payload["quick"], bool):
        errs.append(f"quick must be a bool, got {payload['quick']!r}")
    for k in ("seed", "scale", "clients", "rounds", "cohort"):
        if not isinstance(payload[k], int):
            errs.append(f"{k} must be an int, got {payload[k]!r}")
    if not isinstance(payload["acc_bound"], (int, float)) \
            or not payload["acc_bound"] > 0:
        errs.append(f"acc_bound must be positive, got {payload['acc_bound']!r}")
    if not isinstance(payload["max_acc_delta"], (int, float)):
        errs.append("max_acc_delta must be a number, "
                    f"got {payload['max_acc_delta']!r}")
    if not isinstance(payload["crashes"], int) or payload["crashes"] < 0:
        errs.append(f"crashes must be a non-negative int, "
                    f"got {payload['crashes']!r}")
    if not isinstance(payload["all_finite"], bool):
        errs.append(f"all_finite must be a bool, got {payload['all_finite']!r}")
    rows = payload["rows"]
    if not isinstance(rows, list) or not rows:
        return errs + ["rows must be a non-empty list"]
    n_crashed = 0
    for i, row in enumerate(rows):
        missing = [k for k in _ROW_KEYS
                   if not isinstance(row, dict) or k not in row]
        if missing:
            errs.append(f"rows[{i}] missing keys {missing}")
            continue
        for k in ("dropout", "straggler_frac", "corrupt"):
            v = row[k]
            if not isinstance(v, (int, float)) or not 0.0 <= v <= 1.0:
                errs.append(f"rows[{i}].{k} must be in [0, 1], got {v!r}")
        for k in ("params_finite", "crashed"):
            if not isinstance(row[k], bool):
                errs.append(f"rows[{i}].{k} must be a bool, got {row[k]!r}")
        n_crashed += bool(row["crashed"])
        if not isinstance(row["rounds_completed"], int) \
                or row["rounds_completed"] < 0:
            errs.append(f"rows[{i}].rounds_completed must be a "
                        f"non-negative int, got {row['rounds_completed']!r}")
        if not isinstance(row["faults"], dict):
            errs.append(f"rows[{i}].faults must be a dict (FaultCounters "
                        f"snapshot), got {row['faults']!r}")
        for k in ("baseline_acc", "final_acc", "acc_delta"):
            if not isinstance(row[k], (int, float)):
                errs.append(f"rows[{i}].{k} must be a number, got {row[k]!r}")
    if not errs and n_crashed != payload["crashes"]:
        errs.append(f"{n_crashed} crashed rows but crashes says "
                    f"{payload['crashes']}")
    deltas = [r["acc_delta"] for r in rows
              if isinstance(r, dict) and isinstance(r.get("acc_delta"),
                                                    (int, float))
              and math.isfinite(r["acc_delta"])]
    if not errs and deltas \
            and not math.isclose(max(deltas), payload["max_acc_delta"],
                                 rel_tol=1e-9, abs_tol=1e-12):
        errs.append(f"max_acc_delta {payload['max_acc_delta']!r} != max of "
                    f"row deltas {max(deltas)!r}")
    serve = payload["serve"]
    if not isinstance(serve, dict):
        errs.append("serve must be a dict")
    else:
        for k in _SERVE_KEYS:
            if k not in serve:
                errs.append(f"serve missing key {k!r}")
        hf = serve.get("h1_finite_frac")
        if hf is not None and (not isinstance(hf, (int, float))
                               or not 0.0 <= hf <= 1.0):
            errs.append(f"serve.h1_finite_frac must be in [0, 1], got {hf!r}")
    ckpt = payload["ckpt"]
    if not isinstance(ckpt, dict):
        errs.append("ckpt must be a dict")
    else:
        for k in _CKPT_KEYS:
            if k not in ckpt:
                errs.append(f"ckpt missing key {k!r}")
        if "recovered" in ckpt and not isinstance(ckpt["recovered"], bool):
            errs.append(f"ckpt.recovered must be a bool, "
                        f"got {ckpt['recovered']!r}")
    return errs


def build_args(argv=None) -> argparse.Namespace:
    from repro_torch.faults import CORRUPT_MODES

    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--quick", action="store_true",
                    help="tiny federation + the 4-scenario matrix")
    ap.add_argument("--dataset", default="pubmed")
    ap.add_argument("--scale", type=int, default=None,
                    help="synthetic dataset scale (default: 32 quick, 8 full)")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=None,
                    help="training rounds (default: 6 quick, 20 full)")
    ap.add_argument("--cohort", type=int, default=4)
    ap.add_argument("--method", default="fedais")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--corrupt-mode", default="nan", choices=CORRUPT_MODES,
                    help="poison flavor for the corruption scenarios")
    ap.add_argument("--acc-bound", type=float, default=0.30,
                    help="max tolerated final-accuracy drop vs the "
                         "scheduler's own fault-free baseline")
    ap.add_argument("--out", default=os.path.join(REPO_ROOT, "BENCH_faults_torch.json"))
    ap.add_argument("--device", default="cuda:0",
                    help="torch device of training and serving (cuda:0 or cpu)")
    args = ap.parse_args(argv)
    args.scale = args.scale if args.scale is not None else (32 if args.quick else 8)
    args.rounds = args.rounds if args.rounds is not None else (6 if args.quick else 20)
    return args


def _schedulers(args) -> dict:
    """Name -> scheduler factory. Async gets the bounded-retry knobs so
    dropped uploads time out and re-dispatch instead of leaking slots."""
    from repro_torch.api import AsyncScheduler, SyncScheduler

    return {
        "sync_stepwise": lambda: SyncScheduler(fused=False),
        "sync_fused": lambda: SyncScheduler(),
        "async": lambda: AsyncScheduler(timeout_s=5.0, max_retries=2,
                                        backoff=2.0, max_staleness=4),
    }


def _dataset(args):
    from repro_torch.federated.partition import partition_graph
    from repro_torch.graph.data import make_dataset

    g = make_dataset(args.dataset, scale=args.scale, seed=args.seed)
    return g, partition_graph(g, args.clients, alpha=0.5, seed=args.seed)


def run_one(g, fed, args, plan, make_sched, *,
            baseline_acc: float = float("nan"), mesh=None) -> dict:
    """One (scenario, scheduler) cell: train under the plan, report the
    degradation row. A crash is caught and reported, never propagated."""
    import torch

    from repro_torch.api import FedEngine
    from repro_torch.faults import UpdateGuard

    # the finite guard alone catches nan/inf poison; finite "scale"
    # blow-ups need the norm ceiling
    guard = (UpdateGuard(max_norm=1e4)
             if plan is not None and plan.corrupt_mode == "scale" else True)
    row = {
        "dropout": plan.dropout if plan else 0.0,
        "straggler_frac": plan.straggler_frac if plan else 0.0,
        "corrupt": plan.corrupt if plan else 0.0,
        "corrupt_mode": plan.corrupt_mode if plan else "nan",
        "baseline_acc": baseline_acc,
        "final_acc": float("nan"), "acc_delta": float("nan"),
        "rounds_completed": 0, "params_finite": False, "crashed": False,
        "executor": "", "faults": {},
    }
    try:
        engine = FedEngine(g, fed, args.method, rounds=args.rounds,
                           clients_per_round=args.cohort, seed=args.seed,
                           eval_every=args.rounds, scheduler=make_sched(),
                           faults=plan, guard=guard, device=args.device, mesh=mesh)
        state = engine.init_state()
        result = engine.run(state)
        row.update(
            executor=engine.last_executor or "",
            final_acc=float(result.final.get("acc", float("nan"))),
            rounds_completed=int(state.round) + 1,
            params_finite=all(bool(torch.isfinite(v).all()) for v in state.params.values()),
            faults=state.fault_events.snapshot(),
        )
        if math.isfinite(baseline_acc) and math.isfinite(row["final_acc"]):
            row["acc_delta"] = baseline_acc - row["final_acc"]
    except Exception as e:                                # noqa: BLE001
        # the harness's own measurement: a crashed row is reported and
        # counted (the exit status gates the count), never propagated
        row["crashed"] = True
        row["error"] = f"{type(e).__name__}: {e}"
    return row


def run_matrix(args) -> tuple[list, int]:
    """Baselines + the scenario matrix through every scheduler. Returns
    (rows, crashes)."""
    from repro_torch.faults import FaultPlan

    g, fed = _dataset(args)
    scenarios = list(_QUICK_SCENARIOS)
    if not args.quick:
        scenarios += _FULL_EXTRA
    rows, crashes = [], 0
    for name, make_sched in _schedulers(args).items():
        base = run_one(g, fed, args, None, make_sched)
        base.update(scenario="baseline", scheduler=name,
                    baseline_acc=base["final_acc"], acc_delta=0.0)
        print(f"# baseline[{name}] acc={base['final_acc']:.3f} "
              f"executor={base['executor']}")
        rows.append(base)
        crashes += base["crashed"]
        for drop, strag, corrupt in scenarios:
            plan = FaultPlan(seed=args.seed + 7, dropout=drop,
                             straggler_frac=strag, corrupt=corrupt,
                             corrupt_mode=args.corrupt_mode)
            row = run_one(g, fed, args, plan, make_sched,
                          baseline_acc=base["final_acc"])
            row.update(scenario=plan.describe(), scheduler=name)
            rows.append(row)
            crashes += row["crashed"]
            print(f"# {name:13s} {plan.describe():24s} "
                  f"acc={row['final_acc']:.3f} (delta {row['acc_delta']:+.3f}) "
                  f"rounds={row['rounds_completed']} "
                  f"executor={row['executor']} faults={row['faults']}")
    if _world_size() >= 2:
        shard_rows, shard_crashes = run_sharded_rows(g, fed, args)
        rows += shard_rows
        crashes += shard_crashes
    else:
        print("# sync_sharded: not run, one rank (the client-sharded executor needs two "
              "or more: torchrun --nproc-per-node N)")
    return rows, crashes


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def run_sharded_rows(g, fed, args) -> tuple[list, int]:
    """The client-sharded rows, on every rank of the default process group:
    a fault-free baseline and a dropout + straggler scenario (the sharded
    executors carry dropout as zero-weight dummies; corruption needs the
    guard, which they refuse) through ``FedEngine(mesh=...)`` on a
    ``("clients",)`` mesh over every rank (a cohort that does not split
    over the ranks is padded). Returns (rows, crashes)."""
    from repro_torch.faults import FaultPlan
    from repro_torch.sharding.fed import make_client_mesh

    mesh = make_client_mesh(device=args.device)
    sync_fused = _schedulers(args)["sync_fused"]
    base = run_one(g, fed, args, None, sync_fused, mesh=mesh)
    base.update(scenario="baseline", scheduler="sync_sharded",
                baseline_acc=base["final_acc"], acc_delta=0.0)
    plan = FaultPlan(seed=args.seed + 7, dropout=0.3, straggler_frac=0.25)
    row = run_one(g, fed, args, plan, sync_fused, mesh=mesh,
                  baseline_acc=base["final_acc"])
    row.update(scenario=plan.describe(), scheduler="sync_sharded")
    print(f"# sync_sharded  {plan.describe():24s} "
          f"acc={row['final_acc']:.3f} executor={row['executor']} "
          f"faults={row['faults']}")
    return [base, row], int(base["crashed"]) + int(row["crashed"])


def run_serve_chaos(args) -> tuple[dict, dict]:
    """Torn-checkpoint recovery + poisoned-feature fallback + shed load.
    Returns (serve_block, ckpt_block) for the payload."""
    import torch

    from repro_torch.api import FedEngine
    from repro_torch.checkpoint import latest_step
    from repro_torch.faults import tear_file
    from repro_torch.serve import LoadGenerator, QueryEngine, ServedModel, save_federation

    g, fed = _dataset(args)
    engine = FedEngine(g, fed, args.method, rounds=2, clients_per_round=args.cohort,
                       seed=args.seed, eval_every=2, device=args.device)
    state = engine.init_state()
    engine.run(state)
    ckpt_dir = tempfile.mkdtemp(prefix="fed_chaos_ckpt_")
    save_federation(ckpt_dir, 1, state)
    torn_path = save_federation(ckpt_dir, 2, state)
    tear_file(torn_path)                     # newest checkpoint is now torn
    torn_step = latest_step(ckpt_dir)
    model = ServedModel.restore(ckpt_dir, g, fed, seed=args.seed, device=args.device)
    ckpt = {"torn_step": int(torn_step), "recovered_step": model.restored_step,
            "recovered": model.restored_step == 1}
    print(f"# ckpt: step {torn_step} torn -> restored step {model.restored_step}")

    qe = QueryEngine(model, deadline_ms=50.0, max_queue=32)
    qe.warmup()
    ids = np.arange(min(16, model.n_active))
    warm, _ = qe.serve_batch([ids], policy="historical")
    # poison the streamed features in place (the serve graphs read this
    # buffer): the fresh path must degrade to the warm cache, never crash
    # or serve non-finite logits
    model.feat.fill_(float("nan"))
    fell, info = qe.serve_batch([ids], policy="fresh")
    model.feat.copy_(torch.from_numpy(model.store.features))      # recover
    fresh2, info2 = qe.serve_batch([ids], policy="fresh")
    gen = LoadGenerator(qe, seed=args.seed, n_queries=80, n_updates=4,
                        mode="open", rate=5000.0,
                        policy_mix={"historical": 0.7, "fresh": 0.3})
    ledger = gen.run()
    serve = {
        **qe.degraded_snapshot(),
        "n_shed": ledger.rejects,
        "fresh_fell_back": bool(info["fell_back"]),
        "fallback_finite": bool(np.isfinite(fell[0]).all()),
        "fallback_matches_warm": bool(np.array_equal(fell[0], warm[0])),
        "recovered_fresh_ok": bool(not info2["fell_back"]
                                   and np.isfinite(fresh2[0]).all()),
        "h1_finite_frac": model.summary()["h1_finite_frac"],
    }
    print(f"# serve: fell_back={serve['fresh_fell_back']} "
          f"finite={serve['fallback_finite']} shed={serve['n_shed']} "
          f"h1_finite_frac={serve['h1_finite_frac']:.3f}")
    return serve, ckpt


def _join_ranks(args) -> int:
    """Under ``torchrun`` (``WORLD_SIZE`` > 1) join its process group: NCCL
    on each rank's card, gloo with ``--device cpu``. Returns this rank."""
    import torch
    import torch.distributed as dist

    if int(os.environ.get("WORLD_SIZE", "1")) < 2 or dist.is_initialized():
        return dist.get_rank() if dist.is_initialized() else 0
    if args.device == "cpu":
        dist.init_process_group("gloo", init_method="env://")
    else:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        args.device = f"cuda:{torch.cuda.current_device()}"
        dist.init_process_group("nccl", init_method="env://")
    return dist.get_rank()


def main(argv=None) -> int:
    args = build_args(argv)
    if _join_ranks(args) != 0:
        run_matrix(args)            # the sharded rows need every rank
        return 0
    rows, crashes = run_matrix(args)
    serve, ckpt = run_serve_chaos(args)
    deltas = [r["acc_delta"] for r in rows if math.isfinite(r["acc_delta"])]
    payload = {
        "bench": "fault_tolerance",
        "devices": _world_size(),
        "quick": bool(args.quick),
        "seed": args.seed,
        "dataset": args.dataset,
        "scale": args.scale,
        "clients": args.clients,
        "rounds": args.rounds,
        "cohort": args.cohort,
        "method": args.method,
        "acc_bound": args.acc_bound,
        "max_acc_delta": max(deltas) if deltas else float("nan"),
        "crashes": int(crashes),
        "all_finite": all(r["params_finite"] for r in rows if not r["crashed"]),
        "rows": rows,
        "serve": serve,
        "ckpt": ckpt,
    }
    problems = validate_bench_faults(payload)
    if problems:
        raise SystemExit("refusing to write an invalid faults ledger:\n  "
                         + "\n  ".join(problems))
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    print(f"# wrote {args.out}")
    print(f"# {len(rows)} rows: crashes={crashes} "
          f"all_finite={payload['all_finite']} "
          f"max_acc_delta={payload['max_acc_delta']:.3f} "
          f"(bound {args.acc_bound})")
    failures = []
    if crashes:
        failures.append(f"{crashes} scenario runs crashed")
    if not payload["all_finite"]:
        failures.append("non-finite merged params survived a run")
    if payload["max_acc_delta"] > args.acc_bound:
        failures.append(f"accuracy degraded {payload['max_acc_delta']:.3f} "
                        f"> bound {args.acc_bound}")
    if not ckpt["recovered"]:
        failures.append("torn checkpoint was not recovered from")
    if not (serve["fresh_fell_back"] and serve["fallback_finite"]):
        failures.append("poisoned fresh path did not degrade to the warm cache")
    if failures:
        print("# FAIL: " + "; ".join(failures))
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
