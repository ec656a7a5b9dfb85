#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card and check it.

    python3 chip_smoke.py [--out FILE.json] [--profile]

Run from the root of a checkout, on a machine with one NVIDIA H100 (sm_90a)
and the CUDA toolkit (``nvcc``). It builds the port's kernels from the
sources in the checkout, holds each against its plain PyTorch version on
the card, then serves the pubmed configuration at the paper's widths
(19,717 nodes, 500 features, 3 classes, GraphSAGE 256/128, max degree 32,
25% node headroom: capacity 24,647 rows) through ``ServedModel`` →
``QueryEngine`` → ``LoadGenerator`` with random weights from a seed.

Phases, one or more lines each:
  1 device   the card (nvidia-smi name and power limit), torch and CUDA
             versions, the fp32 matmul flags (set to full fp32);
  2 build    nvcc time and the ptxas register report;
  3 kernels  each kernel against its plain version at the serving path's
             shapes (atol = rtol = 1e-5), with its time, the plain
             version's, the library call's and the bound; for the SpMM
             also the times at the contraction splits ``block_spmm`` did
             not pick (held to the same tolerance);
  4 serve    warm fill + warmup + a few hundred ids under both policies;
             historical and fresh logits agree at 1e-4;
  5 traffic  a closed-loop LoadGenerator run (200 queries, 20 updates,
             90/10 historical/fresh, Zipf ids): p50, p99, queries/s;
             no fallback, and the SpMM launch count moved;
  6 check    the served logits against the port's eval path on the card
             and against the port's plain path on the CPU (1e-4); then,
             on the graph the traffic mutated, one more edge insert and a
             refresh, and the refreshed rows' historical logits against
             their fresh logits and the plain CPU path on that graph.
The launch counters are set to 0 just before phase 4 and read just after
phase 5. Before the last line it prints a ``{"kernels": [...]}`` line. The
last line is ``{"ok": true, "device": {...}}``. Any failure raises and the
exit code is not 0; without CUDA, or outside a checkout, it prints no
result and exits 2.
"""
from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet): fp32 on the FMA pipes and
# HBM3 bandwidth. The bound of a kernel is the larger of its bytes over the
# one and its operations over the other.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
TOL_KERNEL = 1e-5
TOL_LOGITS = 1e-4
N_IDS = 256


def log(*parts) -> None:
    print(*parts, flush=True)


class Timer:
    """Median device time of a callable over ``reps`` launches with CUDA
    events, the 50 MB L2 flushed before each (the serving path meets its
    operands cold)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")

    def __call__(self, fn, reps: int) -> float:
        torch = self.torch
        fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        times.sort()
        return times[len(times) // 2]


def spmm_bound(torch, n, m, d, mask, bm, bk):
    """(bound_ms, bound_by, live_fraction): the bytes the
    block-sparse product must move over HBM bandwidth, against its fp32 FMA
    operations (2·D per live element of A) over the fp32 peak, for this
    run's mask. The bytes are the live A tiles, the rows of X under a
    column tile that some row tile has live (no other row of X is needed),
    Y and the mask, each once."""
    rows = torch.clamp(n - torch.arange(mask.shape[0], device=mask.device) * bm, max=bm)
    cols = torch.clamp(m - torch.arange(mask.shape[1], device=mask.device) * bk, max=bk)
    live = float((mask.double() * rows[:, None].double() * cols[None, :].double()).sum())
    x_rows = float((mask.any(0).double() * cols.double()).sum())
    frac = float(mask.double().mean()) if mask.numel() else 0.0
    nbytes = 4 * (live + x_rows * d + n * d + mask.numel())
    flops = 2.0 * live * d
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            frac)


def check_spmm(torch, ops, ref, timer, name, a, x, mask, reps):
    """One SpMM shape: kernel vs plain version on the card, then times.
    The contraction splits ``block_spmm`` did not pick (none, half and
    twice its own) are checked and timed too."""
    y = ops.block_spmm(a, x, mask)
    want = ref.spmm_ref(a, x)
    torch.cuda.synchronize()
    if y.shape != want.shape or not torch.isfinite(y).all():
        raise AssertionError(f"spmm {name}: shape {tuple(y.shape)} or non-finite output")
    err = float((y - want).abs().max()) if y.numel() else 0.0
    if not torch.allclose(y, want, atol=TOL_KERNEL, rtol=TOL_KERNEL):
        raise AssertionError(f"spmm {name}: max abs err {err} beyond {TOL_KERNEL}")
    n, m = a.shape
    d = x.shape[1]
    bound_ms, bound_by, frac = spmm_bound(torch, n, m, d, mask, ops.TILE_M, ops.TILE_K)
    splits = ops.split_count(n, m, d, torch.cuda.get_device_properties(
        a.device).multi_processor_count)
    row = {
        "shape": name, "n": n, "m": m, "d": d, "tile": [ops.TILE_M, ops.TILE_K],
        "splits": splits, "live_fraction": frac, "max_abs_err": err,
        "ms": timer(lambda: ops.block_spmm(a, x, mask), reps),
        "plain_ms": timer(lambda: ref.spmm_ref(a, x), reps),
        "library_ms": timer(lambda: torch.matmul(a, x), reps),
        "bound_ms": bound_ms, "bound_by": bound_by, "other_splits": {},
    }
    others = {1, max(1, splits // 2), min(2 * splits, -(-m // ops.TILE_K))} - {splits}
    for s in sorted(others):
        y2 = ops.launch(a, x, mask, s)
        if not torch.allclose(y2, want, atol=TOL_KERNEL, rtol=TOL_KERNEL):
            raise AssertionError(f"spmm {name} at {s} splits: max abs err "
                                 f"{float((y2 - want).abs().max())}")
        row["other_splits"][s] = timer(lambda: ops.launch(a, x, mask, s), reps)
    log(f"phase 3 kernels: spmm {name} ({n} x {m}) @ ({m} x {d}) splits {splits} live "
        f"{frac:.4f} max_abs_err {err} kernel {row['ms']} ms plain {row['plain_ms']} ms "
        f"torch.matmul {row['library_ms']} ms bound {bound_ms} ms ({bound_by}); at "
        f"other splits {json.dumps(row['other_splits'])}")
    return row


def profile_traffic(torch, engine, load_cls, top: int = 8) -> dict:
    """A second closed-loop run (seed 1) under ``torch.profiler``: wall
    time, the device's busy time (the sum over the device-side events:
    kernels, copies, memsets, all on one stream) and its busy share, and
    the events that take most of the device and of the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = load_cls(engine, seed=1, n_queries=200, n_updates=20, mode="closed",
                   concurrency=8, policy_mix={"historical": 0.9, "fresh": 0.1})
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gen.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()

    def dev_us(e):
        t = getattr(e, "device_time_total", None)
        return getattr(e, "cuda_time_total", 0) if t is None else t

    on_dev = [e for e in events if e.device_type == DeviceType.CUDA]
    on_host = [e for e in events if e.device_type == DeviceType.CPU]
    busy_ms = sum(dev_us(e) for e in on_dev) / 1e3
    by_dev = sorted(on_dev, key=dev_us, reverse=True)[:top]
    by_cpu = sorted(on_host, key=lambda e: e.self_cpu_time_total, reverse=True)[:top]
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
        "top_device": [{"name": e.key, "count": e.count, "device_ms": dev_us(e) / 1e3}
                       for e in by_dev],
        "top_host": [{"name": e.key, "count": e.count,
                      "self_cpu_ms": e.self_cpu_time_total / 1e3} for e in by_cpu],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the record as JSON here")
    ap.add_argument("--profile", action="store_true",
                    help="after phase 6, trace a second traffic run with "
                         "torch.profiler and print where its time goes")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from "
              "a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    import numpy as np

    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.federated.server import build_eval_graph, eval_logits, evaluate_global
    from repro_torch.graph.csr import build_padded_neighbors
    from repro_torch.graph.data import make_dataset
    from repro_torch.kernels import build
    from repro_torch.kernels.spmm import ops, ref
    from repro_torch.models.gcn import HIDDEN, gcn_init
    from repro_torch.serve import GraphStore, LoadGenerator, QueryEngine, ServedModel

    t_start = time.perf_counter()
    dev = torch.device("cuda:0")
    record: dict = {}

    # -- phase 1: device ----------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log(f"phase 1 device: {kind} | nvidia-smi: {smi} | cards {torch.cuda.device_count()} "
        f"| torch {torch.__version__} cuda {torch.version.cuda} | "
        f"float32_matmul_precision {torch.get_float32_matmul_precision()} "
        f"matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}")
    record["device"] = {"name": kind, "nvidia_smi": smi, "torch": torch.__version__,
                        "cuda": torch.version.cuda}

    # -- phase 2: build -------------------------------------------------------
    t0 = time.perf_counter()
    build.build()
    log(f"phase 2 build: {json.dumps(build.build_seconds)} s of nvcc "
        f"({time.perf_counter() - t0:.2f} s wall) into {build.BUILD_DIR}")
    for name, text in build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"phase 2 build: {name}: {line.strip()}")
    record["build_s"] = dict(build.build_seconds)

    # -- the configuration ------------------------------------------------------
    g = make_dataset("pubmed", scale=1, max_features=500, seed=0)
    idx, mask = build_padded_neighbors(g.adjacency_lists(), 32, seed=0)
    store = GraphStore(g.features, idx, mask)
    cap, n_nodes = store.capacity, g.n_nodes
    log(f"config: pubmed scale 1: {n_nodes} nodes, {len(g.edges)} edges, "
        f"{g.n_features} features, {g.n_classes} classes, hidden {HIDDEN}, "
        f"max_deg 32, capacity {cap}")

    # -- phase 3: kernels against their plain versions --------------------------
    timer = Timer(torch)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    feat = torch.tensor(store.features, device=dev)
    table1 = torch.randn((cap, HIDDEN[0]), generator=gen, device=dev)
    rows_all = rng.permutation(n_nodes)
    shapes = []

    def adj_case(rows: np.ndarray):
        i = torch.tensor(store.nbr_idx[rows], device=dev)
        mk = torch.tensor(store.nbr_mask[rows], device=dev)
        a = ops.adjacency_from_neighbors(i, mk, cap)
        return a, ops.adjacency_block_mask(i, mk, cap, ops.TILE_M, ops.TILE_K)

    a, mk = adj_case(np.arange(cap))
    shapes.append(check_spmm(torch, ops, ref, timer, "warm_fill", a, feat, mk, 5))
    del a, mk
    for b in (8, 32, 128):
        a, mk = adj_case(rows_all[:b])
        shapes.append(check_spmm(torch, ops, ref, timer, f"historical_b{b}", a, table1,
                                 mk, 20))
        shapes.append(check_spmm(torch, ops, ref, timer, f"refresh_b{b}", a, feat, mk, 20))
    for b in (8, 32, 128):
        q = rows_all[:b]
        r = np.unique(np.concatenate([q, store.nbr_idx[q][store.nbr_mask[q] > 0]]))
        rows = np.zeros(b * 33, np.int64)
        rows[: len(r)] = r
        a, mk = adj_case(rows)
        shapes.append(check_spmm(torch, ops, ref, timer, f"fresh_b{b}", a, feat, mk, 10))
    del a, mk
    a = torch.rand((1000, 3001), generator=gen, device=dev)
    a = torch.where(torch.rand(a.shape, generator=gen, device=dev) < 0.01, a, 0.0)
    x = torch.randn((3001, 77), generator=gen, device=dev)
    shapes.append(check_spmm(torch, ops, ref, timer, "ragged", a, x,
                             ops.block_mask_from_dense(a, ops.TILE_M, ops.TILE_K), 20))
    a = torch.zeros((300, 500), device=dev)
    x = torch.randn((500, 64), generator=gen, device=dev)
    dead = torch.zeros((10, 16), dtype=torch.int32, device=dev)
    row = check_spmm(torch, ops, ref, timer, "all_dead", a, x, dead, 20)
    if ops.block_spmm(a, x, dead).abs().max() != 0:
        raise AssertionError("spmm all_dead: output is not exactly zero")
    shapes.append(row)
    del a, x, dead, table1
    record["spmm_shapes"] = shapes

    # -- phase 4: serve (the main path; counts from 0) --------------------------
    params = gcn_init(torch.Generator().manual_seed(0), g.n_features, g.n_classes,
                      device=dev)
    ids = np.sort(rng.choice(n_nodes, size=N_IDS, replace=False))
    ops.block_spmm.launches = 0
    t0 = time.perf_counter()
    model = ServedModel(params, store, backend="spmm", warm="refresh", device=dev)
    engine = QueryEngine(model, fallback=False)
    warm_launches = engine.warmup()
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    hist = np.concatenate([engine.query(ids[i: i + 128], policy="historical")
                           for i in range(0, N_IDS, 128)])
    fresh = np.concatenate([engine.query(ids[i: i + 128], policy="fresh")
                            for i in range(0, N_IDS, 128)])
    if hist.shape != (N_IDS, g.n_classes) or not np.isfinite(hist).all():
        raise AssertionError(f"serve: logits {hist.shape} or non-finite")
    if not np.allclose(hist, fresh, atol=TOL_LOGITS, rtol=TOL_LOGITS):
        raise AssertionError(f"serve: historical vs fresh max abs diff "
                             f"{np.abs(hist - fresh).max()}")
    log(f"phase 4 serve: warm fill + warmup {t_setup:.3f} s ({warm_launches} warmup "
        f"launches); {N_IDS} ids: historical vs fresh max abs diff "
        f"{float(np.abs(hist - fresh).max())}")

    # -- phase 5: traffic ------------------------------------------------------
    before = ops.block_spmm.launches
    gen_load = LoadGenerator(engine, seed=0, n_queries=200, n_updates=20, mode="closed",
                             concurrency=8, policy_mix={"historical": 0.9, "fresh": 0.1})
    ledger = gen_load.run()
    torch.cuda.synchronize()
    launches = ops.block_spmm.launches
    summ = ledger.summary(backend="spmm", devices=1, quick=False, mode="closed",
                          policy_mix=gen_load.policy_mix,
                          degraded=engine.degraded_snapshot())
    log(f"phase 5 traffic: {kind}, {smi}: closed loop 8 clients, {summ['n_queries']} "
        f"queries + {summ['n_updates']} updates: p50 {summ['p50_ms']} ms p99 "
        f"{summ['p99_ms']} ms {summ['queries_per_s']} queries/s; per policy "
        f"{json.dumps(summ['policies'])}; fallbacks {engine.n_fallbacks}; spmm "
        f"launches {launches - before} in traffic, {launches} on the main path")
    record["traffic"] = summ
    if engine.n_fallbacks != 0:
        raise AssertionError(f"traffic: {engine.n_fallbacks} fallbacks")
    if launches - before <= 0:
        raise AssertionError("traffic: the SpMM kernel was not launched")

    # -- phase 6: served logits against the eval path and the CPU path ---------
    eg = build_eval_graph(g, max_deg=32, seed=0, backend="spmm", device=dev)
    want = eval_logits(params, eg)[torch.from_numpy(ids).to(dev)].cpu().numpy()
    metrics = evaluate_global(params, eg)
    del eg
    err_eval = float(np.abs(hist - want).max())
    if not np.allclose(hist, want, atol=TOL_LOGITS, rtol=TOL_LOGITS):
        raise AssertionError(f"check: served vs eval path max abs diff {err_eval}")
    cpu_store = GraphStore(g.features, idx, mask)
    cpu_model = ServedModel(params_from_numpy(params_to_numpy(params), "cpu"), cpu_store,
                            backend="spmm", warm="cold", device="cpu")
    cpu_engine = QueryEngine(cpu_model, buckets=(32,), fallback=False)
    cpu = np.concatenate([cpu_engine.query(ids[i: i + 32], policy="fresh")
                          for i in range(0, N_IDS, 32)])
    err_cpu = float(np.abs(hist - cpu).max())
    if not np.allclose(hist, cpu, atol=TOL_LOGITS, rtol=TOL_LOGITS):
        raise AssertionError(f"check: served vs CPU plain path max abs diff {err_cpu}")
    log(f"phase 6 check: {N_IDS} served ids vs eval path on the card max abs diff "
        f"{err_eval}, vs plain path on the CPU {err_cpu}; eval metrics (random "
        f"weights) {json.dumps(metrics)}")

    # refreshed rows on the graph the traffic mutated: invalidate a few more
    # rows, refresh the cache, and hold what the refresh wrote
    engine.add_edges(np.stack([ids[:16], rng.choice(n_nodes, 16, replace=False)], 1))
    stale = model.invalid_rows()
    n_ref = engine.refresh()
    if n_ref != len(stale) or len(model.invalid_rows()) or not len(stale):
        raise AssertionError(f"check: refresh wrote {n_ref} of {len(stale)} stale rows, "
                             f"{len(model.invalid_rows())} still stale")
    ids2 = np.union1d(stale[:192], ids[:64])
    hist2 = np.concatenate([engine.query(ids2[i: i + 128], policy="historical")
                            for i in range(0, len(ids2), 128)])
    fresh2 = np.concatenate([engine.query(ids2[i: i + 128], policy="fresh")
                             for i in range(0, len(ids2), 128)])
    cpu_model = ServedModel(cpu_model.params, copy.deepcopy(store), backend="spmm",
                            warm="cold", device="cpu")
    cpu_engine = QueryEngine(cpu_model, buckets=(32,), fallback=False)
    cpu2 = np.concatenate([cpu_engine.query(ids2[i: i + 32], policy="fresh")
                           for i in range(0, len(ids2), 32)])
    err_fresh2 = float(np.abs(hist2 - fresh2).max())
    err_cpu2 = float(np.abs(hist2 - cpu2).max())
    if (not np.isfinite(hist2).all()
            or not np.allclose(hist2, fresh2, atol=TOL_LOGITS, rtol=TOL_LOGITS)
            or not np.allclose(hist2, cpu2, atol=TOL_LOGITS, rtol=TOL_LOGITS)):
        raise AssertionError(f"check: after refresh, historical vs fresh max abs diff "
                             f"{err_fresh2}, vs plain path on the CPU {err_cpu2}")
    log(f"phase 6 check: mutated graph ({store.n_active} nodes), {n_ref} rows "
        f"refreshed; {len(ids2)} ids ({min(len(stale), 192)} refreshed): historical vs "
        f"fresh max abs diff {err_fresh2}, vs plain path on the CPU {err_cpu2}")

    if args.profile:
        prof = profile_traffic(torch, engine, LoadGenerator)
        record["profile"] = prof
        log(f"profile: {kind}, {smi}: traffic wall {prof['wall_ms']} ms, device busy "
            f"{prof['device_busy_ms']} ms (share {prof['device_busy_share']})")
        for e in prof["top_device"]:
            log(f"profile: device {e['device_ms']} ms x{e['count']} {e['name']}")
        for e in prof["top_host"]:
            log(f"profile: host {e['self_cpu_ms']} ms x{e['count']} {e['name']}")

    # -- the kernels line --------------------------------------------------------
    warm = shapes[0]
    kernels = [{
        "name": "spmm_block_f32", "route": "cuda",
        "source": "src/repro_torch/kernels/spmm/csrc/spmm.cu",
        "replaces": "src/repro/kernels/spmm/spmm.py:45",
        "launches": launches,
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "ms": warm["ms"], "plain_ms": warm["plain_ms"], "bound_ms": warm["bound_ms"],
        "bound_by": warm["bound_by"], "library_ms": warm["library_ms"],
        "timed_shape": "warm_fill", "shapes": shapes,
    }]
    record["kernels"] = kernels
    record["seconds"] = time.perf_counter() - t_start
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
