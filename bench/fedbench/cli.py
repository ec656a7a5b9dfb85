"""The command line of the benchmark: one run of one cell.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration in the file the entry names, its
traffic in ``bench/traffic/<traffic>.json``, its limits in
``bench/limits/<cell>.json``, and each per-layer metric's reader in
``bench/metrics/<metric>.py`` (a function ``read(run) -> float | None``).

The last line of standard output is the result, a JSON object; the numbers
compared, each beside its limit, are the last lines of standard error and
the result's last key. ``--control tf32`` puts the reference in TF32 in the
program's place and prints the numbers it reads (the control of the
comparison); ``--control half_batch`` and ``--control altered_loss`` do the
same with the reference in fp32 and that fault planted. The benchmark's own
runs never take them.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

BENCH_DIR = Path(__file__).resolve().parents[1]
_T0 = [time.perf_counter()]


def log(msg: str) -> None:
    print(f"[bench {time.perf_counter() - _T0[0]:8.3f}] {msg}", file=sys.stderr, flush=True)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("tf32", "half_batch", "altered_loss"), default=None,
                   help="put the reference in the program's place: in TF32, or in fp32 "
                        "with this fault planted")
    return p


class Spec:
    """The benchmark's entries, and the files each names."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self.bench_dir = self.root / self.bench["paths"][0]

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise SystemExit(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench_dir / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads((self.bench_dir / "limits" / f"{cell}.json").read_text())

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.bench["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        return [m for m in self.bench["per_layer"] if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        path = self.bench_dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def check_lines(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {value, limit}}): every number within its limit. A
    limit of null marks a number the cell reports but does not compare (one
    with no upper reading to set a limit below, PERF.md §2)."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = limits[name]
        if limit is not None:
            ok = ok and math.isfinite(value) and value <= limit
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def main(argv=None, *, t_start=None, root=None, require_chip: bool = True,
         device=None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    _T0[0] = t_start
    args = parser().parse_args(argv)
    spec = Spec(root or BENCH_DIR.parent)
    cell_entry = spec.workload(args.workload)
    cfg = spec.config(cell_entry["config"])
    if cfg.get("kind") != "fedais":
        raise SystemExit(f"configuration {cell_entry['config']!r} is of kind "
                         f"{cfg.get('kind')!r}; this harness runs FedAIS training cells")
    traffic = spec.traffic(cell_entry["traffic"])
    limits = spec.limits(args.workload)
    os.environ.setdefault("TRITON_CACHE_DIR", str(spec.root / "build" / "triton"))
    os.environ.setdefault("USE_FLAX", "0")

    import torch

    from fedbench import cell, judge, work

    if require_chip:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell_entry["chips"]:
            log(f"needs {cell_entry['chips']} CUDA device(s); found "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 3
        device = torch.device("cuda", 0)
    device = torch.device(device or "cpu")
    torch.set_num_threads(4)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if args.control:
        tf32 = args.control == "tf32"
        obs = judge.control(cfg, traffic, args.seed, device, "tf32" if tf32 else "fp32", log,
                            fault=None if tf32 else args.control)
        numbers = judge.judge(obs, cfg, device, log)
        _, checks = check_lines(numbers, limits)
        for name, c in checks.items():
            log(f"check {name}: {c['value']} (limit {c['limit']})")
        print(json.dumps({"control": args.control, "seed": args.seed, "checks": checks}))
        return 0

    run = cell.run(torch, cfg, traffic, args.seed, args.seconds, bool(args.trace), device,
                   t_start, log)
    result = {"correct": False, "attempted": run.rounds, "failed": run.failed, "metrics": {}}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": run.peak_bytes}
    if args.trace:
        w = cell.replay_work(torch, cfg, run, device)
        log(f"replayed the traced rounds' SpMM work: {len(w.launches)} launches")
        tr = run.trace
        part = run.part
        F, C = part["features"].shape[2], part["n_classes"]
        bsz = judge.reference.batch_size(run.method, part["n_max"])
        dense = (tr["rounds"] * work.round_dense_flops(run.cohort, part["n_max"], bsz,
                                                       run.method.local_epochs, F, C)
                 + tr["evals"] * work.eval_dense_flops(len(run.graph["labels"]), F, C))
        ctx = SimpleNamespace(**tr, step_ms=run.step_ms, spmm_work=w.launches,
                              flops_per_round=(dense + sum(x["flops"] for x in w.launches))
                              / tr["rounds"],
                              captures_in_window=run.captures_in_window)
        log(f"traced SpMM launches {len(tr['spmm_durations_s'])}, replayed {len(w.launches)}")
        for m in spec.per_layer(args.workload):
            value = spec.reader(m["name"])(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = tr["breakdown"]
        del w
    else:
        e2e = {"setup_s": run.setup_s, "step_ms": run.step_ms,
               "peak_mem_gb": run.peak_bytes / 1e9}
        for m in spec.end_to_end(args.workload):
            result["metrics"][m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    result["device"] = dev
    log(f"SpMM launches in the window {run.spmm_launches}, expected {run.spmm_expected}")

    forbidden = cell.loaded_forbidden()
    if forbidden:
        log(f"the run loaded modules it must not: {forbidden}")
        return 4
    gc.collect()
    log("judging")
    numbers = judge.judge(run, cfg, device, log)
    result["correct"], result["checks"] = check_lines(numbers, limits)
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0
