"""Reading a ``torch.profiler`` trace of the card into what the per-layer
metrics need.

The device's busy time is the union of its kernel, copy and memset
intervals, so work that overlaps is counted once (a sum of event times
counts it twice); annotations the profiler mirrors onto the device
timeline are not work and are left out. The window leaves out the device's
idle time under the profiler's own bookkeeping on the host (its activity
buffers), which an untraced run does not have. Idle gaps are named by what the
host was doing: the innermost host operation running at the gap's
midpoint, under the innermost benchmark span around it.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync")
GEMM_MARKS = ("gemm", "gemv", "cutlass", "xmma", "splitkreduce")
# the profiler's own bookkeeping on the host (CUPTI's activity buffers): the
# device idles through it in a traced run only, so it leaves the window
PROFILER_OPS = ("Activity Buffer Request", "Buffer Flush")
WINDOW = "bench.window"
TOP = 10


def merge(intervals: list) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def subtract(gaps: list, cuts: list) -> list:
    """The parts of sorted disjoint intervals ``gaps`` outside sorted
    disjoint intervals ``cuts``."""
    out, j = [], 0
    for g0, g1 in gaps:
        s = g0
        while j < len(cuts) and cuts[j][1] <= s:
            j += 1
        k = j
        while k < len(cuts) and cuts[k][0] < g1:
            if cuts[k][0] > s:
                out.append((s, cuts[k][0]))
            s = max(s, cuts[k][1])
            k += 1
        if s < g1:
            out.append((s, g1))
    return out


def kind_of(name: str) -> str:
    low = name.lower()
    if name.startswith(("Memcpy", "Memset")):
        return "copy"
    if "spmm" in low:
        return "spmm"
    if any(m in low for m in GEMM_MARKS):
        return "gemm"
    return "other"


def trace(torch, fn) -> dict:
    """Run ``fn`` under the profiler (it must end with the device idle) and
    return the device events, host events and the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
    dev, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s = e.start_ns()
        end = s + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation() and not name.startswith(("bench.", "fedais.")):
                dev.append((s, end, name))
        elif name == WINDOW:
            window = (s, end)
        else:
            host.append((s, end, name, e.is_user_annotation()))
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    dev = [d for d in dev if d[1] > window[0] and d[0] < window[1]]
    dev.sort()
    return {"device": dev, "host": host, "window": window}


def summarize(tr: dict) -> dict:
    """Busy time, per-kind device time and counts, host launches, and the
    breakdown (top device operations, longest idle gaps by host activity)."""
    w0, w1 = tr["window"]
    clipped = [(max(s, w0), min(e, w1)) for s, e, _ in tr["device"]]
    busy = merge(clipped)
    busy_ns = sum(e - s for s, e in busy)
    by_kind: dict = defaultdict(float)
    count: dict = defaultdict(int)
    by_name: dict = defaultdict(float)
    spmm = []
    for s, e, name in tr["device"]:
        k = kind_of(name)
        by_kind[k] += (e - s) / 1e9
        count[k] += 1
        by_name[name] += (e - s) / 1e9
        if k == "spmm":
            spmm.append((e - s) / 1e9)
    launches = sum(1 for s, e, name, _ in tr["host"] if name in HOST_LAUNCHES
                   and s >= w0 and s < w1)
    gaps = []
    prev = w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    book = merge([(s, e) for s, e, name, _ in tr["host"] if name in PROFILER_OPS])
    kept = subtract(gaps, book)
    profiler_ns = sum(e - s for s, e in gaps) - sum(e - s for s, e in kept)
    gaps = kept
    gap_names: dict = defaultdict(float)
    ops = sorted((s, e, n) for s, e, n, a in tr["host"] if not a)
    spans = sorted((s, e, n) for s, e, n, a in tr["host"] if a)
    starts = [s for s, _, _ in ops]
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:2000]:
        gap_names[_host_at(ops, starts, spans, (g0 + g1) // 2)] += (g1 - g0) / 1e9
    return {
        "window_s": (w1 - w0 - profiler_ns) / 1e9,
        "profiler_s": profiler_ns / 1e9,
        "busy_s": busy_ns / 1e9,
        "device_s": dict(by_kind),
        "kernels": count["spmm"] + count["gemm"] + count["other"],
        "spmm_durations_s": spmm,
        "host_launches": launches,
        "breakdown": {
            "device_ops": [[n, t] for n, t in sorted(by_name.items(), key=lambda x: -x[1])[:TOP]],
            "idle_gaps": [[n, t] for n, t in sorted(gap_names.items(), key=lambda x: -x[1])[:TOP]],
        },
    }


def _host_at(ops: list, starts: list, spans: list, t: int) -> str:
    """'span > op': the innermost benchmark or program span and the
    innermost host operation running at host time ``t`` (ops sorted by
    start; an op that contains ``t`` started among the last few hundred
    before it, since host ops nest on one thread)."""
    op = None
    for s, e, name in reversed(ops[max(0, bisect.bisect_right(starts, t) - 400):
                                   bisect.bisect_right(starts, t)]):
        if e >= t:
            op = name
            break
    span = None
    for s, e, name in spans:
        if s > t:
            break
        if e >= t:
            span = name
    return f"{span or 'host'} > {op or 'no host op'}"
