"""A ``--trace 1`` run of one cell with the program's spans on, and what
they read in the traced window, per round.

    python3 bench/traced_spans.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout. It is ``bench/run.py --trace 1`` with
``repro_torch.utils.spans`` switched on before the engine is built, so that
every captured round graph carries its device phases; the difference of
the spans' totals across the traced window is taken around the profiler's
window. After the run's own result line it prints one JSON line: the
measured window's ``step_ms`` (with the spans on), the traced window's
rounds, busy and window seconds, its idle gaps by span, each device
phase's and span's milliseconds a round, and the readings that the
per-layer metrics of the spans take (``readings``).

A phase's reading is the stream's time from its stamp to the next, so it
holds whatever the device waited for inside it (the host's submission of
a graph, where the host is the slower). ``phase_busy_ms_per_step`` splits
the device trace's busy time instead: the union of the device's
intervals between each phase's two stamp kernels, the stamps matched in
stream order to the phase scopes the window opened (null where the trace
has no stamps to match, as on the CPU).
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))

from fedbench import cell, cli, trace  # noqa: E402

from repro_torch.utils import spans  # noqa: E402

PHASES = ("loss_pass", "sampling", "ghost_pull", "train_step", "optimizer",
          "table_traffic", "merge")
STAMP = "stamp_kernel"


def covered(busy: list, t0: int, t1: int) -> int:
    """How much of [t0, t1] the sorted disjoint intervals ``busy`` cover."""
    i = max(0, bisect.bisect_right(busy, [t0]) - 1)
    out = 0
    while i < len(busy) and busy[i][0] < t1:
        out += max(0, min(busy[i][1], t1) - max(busy[i][0], t0))
        i += 1
    return out


def phase_busy(tr: dict, scopes: list) -> dict | None:
    """Each device phase's busy ms over a traced window: the union of the
    device's intervals between the phase's stamp and the next, the trace's
    stamp kernels taken in order for the phase scopes ``scopes`` (each a
    list of phase names) opened in the window. None where the stamps and
    the scopes do not match."""
    stamps = [s for s, _, name in tr["device"] if STAMP in name]
    if not stamps or len(stamps) != sum(len(names) + 1 for names in scopes):
        return None
    busy = trace.merge([(s, e) for s, e, _ in tr["device"]])
    out: dict = {}
    at = 0
    for names in scopes:
        b = stamps[at:at + len(names) + 1]
        at += len(names) + 1
        for name, t0, t1 in zip(names, b, b[1:]):
            out[name] = out.get(name, 0) + covered(busy, t0, t1)
    return {k: v / 1e6 for k, v in out.items()}


def readings(program: dict, rounds: int) -> dict:
    """The per-round readings of the spans' metrics from a ``spans.diff``
    over the traced window."""
    ph, sp, c = program["phases"], program["spans"], program["counters"]
    phase = lambda name: ph.get(name, {}).get("ms", 0.0) / rounds
    ms = lambda name, kind: 1e3 * sp.get(name, {}).get(kind, 0.0) / rounds
    out = {f"{p}_ms_per_step": phase(p) for p in PHASES}
    out.update(
        graph_launch_host_ms_per_step=ms("fedais.chunk.replay", "total_s"),
        host_tail_ms_per_step=(ms("fedais.chunk.select", "self_s")
                               + ms("fedais.chunk.host_tail", "self_s")),
        eval_device_ms_per_step=phase("eval"),
        eval_host_ms_per_step=ms("fedais.eval.metrics", "total_s"),
        device_allocs_per_step=c.get("device_allocs", 0) / rounds)
    return out


def main(argv=None, **kw) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    got: dict = {"scopes": None}
    real_trace, real_summarize, real_run = trace.trace, trace.summarize, cell.run
    real_scope = spans.phase_scope

    def scope(marks):
        if got["scopes"] is not None and marks is not None:
            got["scopes"].append(marks)
        return real_scope(marks)

    def traced(torch, fn):
        before = spans.totals()
        got["scopes"] = []
        try:
            tr = real_trace(torch, fn)
        finally:
            got["scopes"], scopes = None, got["scopes"]
        got["program"] = spans.diff(spans.totals(), before)
        got["phase_busy"] = phase_busy(tr, [m.names for m in scopes])
        return tr

    def summarize(tr):
        got["summary"] = real_summarize(tr)
        return got["summary"]

    def run(*a, **k):
        out = real_run(*a, **k)
        got["step_ms"], got["rounds"] = out.step_ms, out.trace["rounds"]
        return out

    trace.trace, trace.summarize, cell.run = traced, summarize, run
    spans.phase_scope = scope
    spans.enable()
    try:
        rc = cli.main(["--workload", args.workload, "--seed", str(args.seed),
                       "--seconds", str(args.seconds), "--trace", "1"], **kw)
    finally:
        spans.enable(False)
        trace.trace, trace.summarize, cell.run = real_trace, real_summarize, real_run
        spans.phase_scope = real_scope
    if rc:
        return rc
    prog, summ, rounds = got["program"], got["summary"], got["rounds"]
    read = readings(prog, rounds)
    in_graph = sum(read[f"{p}_ms_per_step"] for p in PHASES)
    busy = 1e3 * summ["busy_s"] / rounds
    pb = got["phase_busy"]
    pb = None if pb is None else {k: v / rounds for k, v in pb.items()}
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "step_ms": got["step_ms"],
        "rounds": rounds, "busy_s": summ["busy_s"], "window_s": summ["window_s"],
        "busy_ms_per_step": busy,
        "phases_ms_per_step": in_graph + read["eval_device_ms_per_step"],
        "phases_over_busy": ((in_graph + read["eval_device_ms_per_step"]) / busy
                             if busy else None),
        "phase_busy_ms_per_step": pb,
        "phase_busy_over_busy": None if pb is None or not busy else sum(pb.values()) / busy,
        "idle_gaps": summ["breakdown"]["idle_gaps"],
        "span_ms_per_step": {k: {"total": 1e3 * v["total_s"] / rounds,
                                 "self": 1e3 * v["self_s"] / rounds, "count": v["count"]}
                             for k, v in prog["spans"].items()},
        "phase_counts": {k: v["count"] for k, v in prog["phases"].items()},
        "counters": prog["counters"], "readings": read}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
