#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py [--out FILE.json] [--profile]

Run from the root of a checkout, on a machine with one NVIDIA H100 (sm_90a)
and the CUDA toolkit (``nvcc``). It builds the port's three kernels from
the sources in the checkout (the block-sparse SpMM, the WKV6 recurrence and
flash attention, one ``nvcc`` each, all at once), holds each against its
plain PyTorch version on the card, and drives three main paths with random
weights from a seed:

* GCN serving: the pubmed configuration at the paper's widths (19,717
  nodes, 500 features, 3 classes, GraphSAGE 256/128, max degree 32, 25%
  node headroom: capacity 24,647 rows) through ``ServedModel`` →
  ``QueryEngine`` → ``LoadGenerator`` (the SpMM kernel);
* LM serving: ``rwkv6-1.6b`` and ``gemma3-12b`` at full width (24 and 48
  layers, bf16) through ``launch.serve_lm_cli.serve``: a prefill of 4 x
  2,048 prompt tokens, then 32 greedy tokens (WKV6 and flash attention);
* FedAIS training: the same pubmed graph over 10 clients (Dirichlet alpha
  0.5: n_max 4,370, g_max 12,374), 5 a round, J = 4 local epochs, batch
  256, fanout 10, GraphSAGE 256/128, 3 rounds through
  ``api.FedEngine(g, fed, "fedais", ...).run()`` with the ``spmm``
  training and eval backends (the SpMM kernel forward and, transposed,
  backward).

Phases, one or more lines each:
  1 device      the card (nvidia-smi name and power limit), torch and CUDA
                versions, the fp32 matmul flags (set to full fp32);
  2 build       nvcc time and the ptxas register report; from the built
                flash library (cuobjdump, so a cached build is read too),
                the bf16 kernel's three instances spill nothing, and its
                SASS holds HGMMA (wgmma) instructions, counted; each of
                the 18 wkv6 instances' and the 8 SpMM instances' registers,
                and none spills;
  3 kernels     the SpMM against its plain version at the serving path's
                shapes, a ragged one, one with two windows of mask columns
                and two column slabs, a dense one and an all-dead one
                (atol = rtol = 1e-5, finite inputs), a second launch bit for
                bit equal to the first, with its time, the plain version's,
                the library call's and the bound (2·D operations per
                nonzero of A); every split ``block_spmm`` did not pick is
                checked the same way and timed; a NaN row of X reaches
                exactly the rows of A that name it; then the training
                path's shapes (a client's loss pass, a batch step at 500 and
                256 columns, and the backward's transposed launch Aᵀ @ dy),
                and the backward through autograd against autograd of the
                plain version (1e-5);
  4 serve       warm fill + warmup + a few hundred ids under both policies;
                historical and fresh logits agree at 1e-4;
  5 traffic     a closed-loop LoadGenerator run (200 queries, 20 updates,
                90/10 historical/fresh, Zipf ids): p50, p99, queries/s;
                no fallback, and the SpMM launch count moved;
  6 check       the served logits against the port's eval path on the card
                and against the port's plain path on the CPU (1e-4); then,
                on the graph the traffic mutated, one more edge insert and a
                refresh, and the refreshed rows' historical logits against
                their fresh logits and the plain CPU path on that graph;
                with one feature row poisoned (NaN), the fresh fallbacks
                count the same chunks under gather, segment and spmm on the
                card and spmm on the CPU;
  7 lm-kernels  WKV6 and flash attention against their plain versions at
                the LM prefill's shapes and at a ragged shape each, in fp32
                (1e-5 / 2e-5, the reference's tolerances) and in bf16 (rtol
                2^-7, one bf16 ulp; atol 1e-4, or 1e-2 for WKV6's y), with
                the kernel's time, the plain version's, SDPA's (attention
                only), the bound and the kernel's own floor; wkv6 also at
                N = 32 and 128 at the prefill's width, T = 1, one step
                past a stage of its input ring and on misaligned bases,
                and at the prefill shapes every launch (columns per
                thread, blocks per row) ``ops.CONFIG`` did not pick, each
                bit for bit equal to the chosen one;
                bf16 attention also at hd 128 (ragged S), non-causal hd 240
                and an hd that is not a multiple of 8, so each width of
                the tensor-core kernel and the FMA kernel's bf16 instance
                (the layouts TMA cannot take) are held;
  8 lm-serve    ``serve`` for each LM: prefill ms, decode tokens/s, peak
                memory, and the launches over the prefill (24 WKV6 for
                rwkv6-1.6b, 48 flash attention for gemma3-12b);
  9 lm-check    at full width, block by block, each block's kernel path
                against its plain path on the same input on the card (output
                and decode state, relative L2 ``TOL_BLOCK_REL``), and the
                whole plain-path prefill against the kernel path's, and
                beside it the plain path against itself with one bf16 ulp
                flipped in as many of the first block's outputs as the
                kernel path changed (both recorded: they measure how far
                the stack carries a rounding difference); at the smoke
                configurations (fp32), the
                card's kernel path against the plain path on the CPU
                (prefill and 4 decode steps, 1e-4);
  10 train      ``FedEngine.run()`` twice from one seed: the SpMM launched
                exactly rounds x (m·(2 + 3J) + 2) times (a loss pass, then
                J steps of 2 forward and 1 transposed launch per client,
                plus the eval's 2 layers a round) and nothing else; the same
                cohorts, batches, tau and test_acc bits in both runs; the
                first LocalUpdate of one client under spmm against gather
                on the card with the same draws (discrete outputs exact,
                ``loss_all`` and the first step's grads 1e-4); ms per round,
                peak memory, test_acc per round.
The SpMM's launch counter is set to 0 just before phase 4 and read just
after phase 5; every counter is set to 0 just before each ``serve`` of
phase 8 and each ``run`` of phase 10 and read just after it. ``--profile``
traces a second traffic run after phase 6, one prefill + 4 decode steps of
each LM in phase 9 and one steady training round in phase 10.
Before the last line it prints a ``{"kernels": [...]}`` line (all three
kernels). The last line is ``{"ok": true, "device": {...}}``. Any failure
raises and the exit code is not 0; without CUDA, or outside a checkout, it
prints no result and exits 2.
"""
from __future__ import annotations

import argparse
import copy
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet, dense): fp32 outside the
# tensor cores, bf16 on them, and HBM3 bandwidth. The bound of a kernel is
# the larger of its bytes over the bandwidth and its operations over the
# peak for their operands' type.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
TOL_KERNEL = 1e-5
TOL_LOGITS = 1e-4
N_IDS = 256
# LM kernels: the reference's own tolerances in fp32 (wkv6 1e-5 on y and S,
# attention 2e-5); in bf16 see _tol
TOL_WKV = 1e-5
TOL_ATTN = 2e-5
# bf16 outputs: both versions round an fp32 value to bf16, so they land at
# most one bf16 ulp apart (2^-7 of the value); the atol covers outputs near
# 0, where the fp32 values differ by their own rounding: about 1e-6 for
# attention, and up to 1e-2 for WKV6's y, a small sum of cancelling terms
# of up to |y| = 17
RTOL_BF16 = 2.0 ** -7
ATOL_BF16_ATTN = 1e-4
ATOL_BF16_WKV_Y = 1e-2
# full-width bf16 prefill, block by block: one block's kernel path vs its
# plain path on the same input (relative L2 error of the block's output and
# decode state). Both take fp32 sums in another order and round them to
# bf16, so an element lands one bf16 ulp (2^-8..2^-7 of it) apart now and
# then: more often where the recurrence's y is a small sum of large
# cancelling terms; the block's norms carry that on into its output
TOL_BLOCK_REL = 1e-2
LM_BATCH, LM_PROMPT, LM_GEN = 4, 2048, 32
LM_ARCHS = ("rwkv6-1.6b", "gemma3-12b")
# FedAIS training: the paper's Pubmed over 10 clients, 5 a round, J = 4
TRAIN_CLIENTS, TRAIN_M, TRAIN_ROUNDS = 10, 5, 3


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


def spmm_bound(torch, n, m, d, mask, nnz, bm, bk):
    """(bound_ms, bound_by, live_fraction): the bytes the block-sparse
    product must move over HBM bandwidth, against the fp32 FMA operations
    these inputs need (2·D per nonzero of A, ``nnz``) over the fp32 peak, for
    this run's mask. The bytes are the live A tiles, the rows of X under a
    column tile that some row tile has live (no other row of X is needed),
    Y and the mask, each once."""
    rows = torch.clamp(n - torch.arange(mask.shape[0], device=mask.device) * bm, max=bm)
    cols = torch.clamp(m - torch.arange(mask.shape[1], device=mask.device) * bk, max=bk)
    live = float((mask.double() * rows[:, None].double() * cols[None, :].double()).sum())
    x_rows = float((mask.any(0).double() * cols.double()).sum())
    frac = float(mask.double().mean()) if mask.numel() else 0.0
    nbytes = 4 * (live + x_rows * d + n * d + mask.numel())
    flops = 2.0 * nnz * d
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            frac)


def check_spmm(torch, ops, ref, timer, name, a, x, mask, reps):
    """One SpMM shape: kernel vs plain version on the card (finite inputs),
    the same bits from a second launch, then times. Every split
    ``block_spmm`` did not pick is checked (1e-5, and twice the same bits)
    and timed too."""
    y = ops.block_spmm(a, x, mask)
    y_again = ops.block_spmm(a, x, mask)
    want = ref.spmm_ref(a, x)
    nnz = int((a != 0).sum())
    torch.cuda.synchronize()
    if y.shape != want.shape or not torch.isfinite(y).all():
        raise AssertionError(f"spmm {name}: shape {tuple(y.shape)} or non-finite output")
    err = float((y - want).abs().max()) if y.numel() else 0.0
    if not torch.allclose(y, want, atol=TOL_KERNEL, rtol=TOL_KERNEL):
        raise AssertionError(f"spmm {name}: max abs err {err} beyond {TOL_KERNEL}")
    if not torch.equal(y, y_again):
        raise AssertionError(f"spmm {name}: a second launch gave other bits")
    n, m = a.shape
    d = x.shape[1]
    bound_ms, bound_by, frac = spmm_bound(torch, n, m, d, mask, nnz, ops.TILE_M, ops.TILE_K)
    live_tiles = int(mask.sum())
    splits = ops.split_count(n, m, d, torch.cuda.get_device_properties(
        a.device).multi_processor_count)
    row = {
        "shape": name, "n": n, "m": m, "d": d, "tile": [ops.TILE_M, ops.TILE_K],
        "splits": splits, "live_fraction": frac, "nnz": nnz,
        "nnz_per_live_tile": nnz / live_tiles if live_tiles else 0.0, "max_abs_err": err,
        "ms": timer(lambda: ops.block_spmm(a, x, mask), reps),
        "plain_ms": timer(lambda: ref.spmm_ref(a, x), reps),
        "library_ms": timer(lambda: torch.matmul(a, x), reps),
        "bound_ms": bound_ms, "bound_by": bound_by, "other_splits": {},
    }
    for s in ops.SPLITS:
        if s == splits:
            continue
        y2, y3 = ops.launch(a, x, mask, s), ops.launch(a, x, mask, s)
        if not torch.allclose(y2, want, atol=TOL_KERNEL, rtol=TOL_KERNEL):
            raise AssertionError(f"spmm {name} at {s} splits: max abs err "
                                 f"{float((y2 - want).abs().max())}")
        if not torch.equal(y2, y3):
            raise AssertionError(f"spmm {name} at {s} splits: a second launch gave "
                                 "other bits")
        row["other_splits"][s] = timer(lambda: ops.launch(a, x, mask, s), reps)
    log(f"phase 3 kernels: spmm {name} ({n} x {m}) @ ({m} x {d}) splits {splits} live "
        f"{frac:.4f} nnz {nnz} ({row['nnz_per_live_tile']:.3f} per live tile) max_abs_err "
        f"{err} kernel {row['ms']} ms plain {row['plain_ms']} ms torch.matmul "
        f"{row['library_ms']} ms bound {bound_ms} ms ({bound_by}); at other splits "
        f"{json.dumps(row['other_splits'])}")
    return row


def check_spmm_nonfinite(torch, ops, name, a, x, mask):
    """One NaN row k of X, at every split: exactly the rows of A with a
    nonzero in column k come out NaN (all of their columns), and every
    other row has the bits the finite X gives it."""
    k = int((a != 0).sum(0).argmax())
    reach = a[:, k] != 0
    xb = x.clone()
    xb[k] = float("nan")
    for s in ops.SPLITS:
        y, yb = ops.launch(a, x, mask, s), ops.launch(a, xb, mask, s)
        nan_rows = torch.isnan(yb).any(1)
        if not (torch.equal(nan_rows, reach) and torch.isnan(yb[reach]).all()
                and torch.equal(yb[~reach], y[~reach])):
            raise AssertionError(f"spmm nonfinite {name} at {s} splits: NaN rows "
                                 f"{int(nan_rows.sum())}, rows naming column {k} "
                                 f"{int(reach.sum())}")
    log(f"phase 3 kernels: spmm nonfinite {name}: a NaN row {k} of X reaches exactly "
        f"the {int(reach.sum())} rows of A that name it, at splits {list(ops.SPLITS)}; "
        "the other rows keep their bits")
    return {"shape": name, "row": k, "rows_reached": int(reach.sum())}


def wkv6_bound(torch, B, T, H, N, dtype):
    """(bound_ms, bound_by): r, k, v (dtype), w (fp32), u read once, y
    (dtype) and S (fp32) written once, over HBM bandwidth, against the
    recurrence's operations, each over the peak for its operands' type.
    Per step and row: 3N for the bonus and 2N for its product with v, 2N^2
    for r·S, N^2 for w·S and N^2 for adding k vᵀ into S, all on the fp32
    state, w or u (fp32 peak); N^2 for the product k vᵀ itself, on two
    inputs of the given dtype (bf16 peak when they are bf16)."""
    esz = torch.tensor([], dtype=dtype).element_size()
    elems = B * T * H * N
    nbytes = 4 * elems * esz + 4 * elems + 4 * H * N + 4 * B * H * N * N
    rows = B * H * T
    kv_peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_ops = (rows * (4.0 * N * N + 5.0 * N) / PEAK_FP32_FLOPS
             + rows * 1.0 * N * N / kv_peak)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def live_pairs(S, causal, window):
    """(query, key) pairs the mask keeps, for one (batch, head)."""
    if not causal:
        return S * S
    w = min(window or S, S)            # row i keeps min(i + 1, w) keys
    return w * (w + 1) // 2 + (S - w) * w


def flash_bound(torch, B, S, H, Hkv, hd, causal, window, dtype):
    """(bound_ms, bound_by): q, k, v read once and o written once over HBM
    bandwidth, against 4·hd operations (q·k and p·v) per live pair over the
    peak for the inputs' type: bf16 inputs and output leave both products
    to the tensor cores (989 TFLOP/s), fp32 ones to the FMA pipes (67)."""
    esz = torch.tensor([], dtype=dtype).element_size()
    nbytes = esz * (2 * B * S * H * hd + 2 * B * S * Hkv * hd)
    flops = 4.0 * hd * B * H * live_pairs(S, causal, window)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def flash_floor(torch, B, S, H, Hkv, hd, causal, window, dtype):
    """The kernel's own floor (ms): the operations it executes, over the peak
    of the units that execute them, or the bound's bytes if more. It counts
    the (query, key) tile pairs the kernel computes, masked parts of the
    diagonal and edge tiles included, with hd at the kernel's padded width
    (64, 128 or 256). bf16 (flash_fwd_tc_kernel): 64-row halves of
    128-row query tiles against 64-key tiles, a tile skipped when no pair
    of the half is live; 2·hd for Q·Kᵀ and 4·hd for P·V (P as hi + lo) per
    pair, on the tensor cores. fp32 (flash_fwd_kernel): 64-row tiles
    against 32-key tiles, 4·hd per pair, on the FMA pipes."""
    hdp = 64 if hd <= 64 else 128 if hd <= 128 else 256
    tc = dtype == torch.bfloat16
    rows, bk = (64, 64) if tc else (64, 32)
    block = 128 if tc else 64
    win = window if (causal and window) else 0
    pairs = 0
    for q0 in range(0, S, block):
        q_last = min(q0 + block, S) - 1
        kt_lo, kt_hi = 0, (S - 1) // bk
        if causal:
            kt_hi = q_last // bk
            if win:
                kt_lo = max(0, q0 - win + 1) // bk
        for first in range(q0, q0 + block, rows):
            last = min(first + rows - 1, S - 1)
            if last < first:
                continue
            for kt in range(kt_lo, kt_hi + 1):
                k0 = kt * bk
                if tc and causal and (k0 > last or (win and k0 + bk - 1 <= first - win)):
                    continue
                pairs += rows * bk
    flops = (6.0 if tc else 4.0) * hdp * B * H * pairs
    t_ops = flops / (PEAK_BF16_FLOPS if tc else PEAK_FP32_FLOPS)
    esz = torch.tensor([], dtype=dtype).element_size()
    t_bytes = esz * (2 * B * S * H * hd + 2 * B * S * Hkv * hd) / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3


def _tol(torch, dtype, tol32, atol_bf16):
    """(atol, rtol): fp32, the reference's tolerance for both; bf16, one
    bf16 ulp relative and ``atol_bf16`` (see ``RTOL_BF16``)."""
    return (tol32, tol32) if dtype == torch.float32 else (atol_bf16, RTOL_BF16)


def cuobjdump(build, name: str, flag: str) -> str:
    """``cuobjdump <flag>`` of the built library (the tool sits beside nvcc),
    so a cached library answers as a fresh build does."""
    tool = Path(build.find_nvcc()).parent / "cuobjdump"
    return subprocess.run([str(tool), flag, str(build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout


def sass_count(build, name: str, opcode: str) -> int:
    """Instructions of ``opcode`` in the built library's SASS."""
    return sum(1 for line in cuobjdump(build, name, "-sass").splitlines()
               if opcode in line)


def res_usage(build, name: str) -> dict:
    """{mangled function: {"REG": n, "STACK": bytes, "LOCAL": bytes, ...}} from
    ``cuobjdump -res-usage``. A spill goes to the stack frame, so STACK and
    LOCAL both 0 means nothing spills."""
    out, fn = {}, None
    for line in cuobjdump(build, name, "-res-usage").splitlines():
        m = re.match(r"\s*Function (\S+):", line)
        if m:
            fn = m.group(1)
        elif fn and "REG:" in line:
            out[fn] = {k: int(v) for k, v in re.findall(r"(\w+):(\d+)", line)}
            fn = None
    return out


def wkv6_floor(torch, B, T, H, N, dtype, cols, splits):
    """The kernel's own floor (ms): the fp32 instructions it executes over
    the card's fp32 issue rate (one instruction per lane and cycle, half
    the fp32 FLOP peak), or the bound's bytes if more. Per step and state
    element an FMA (r·S), a multiply (k·v) and an FMA (w·S + kv); per step,
    row and block, 2 per key row for coef (r·u, then the FMA with k) and
    log2(KT) adds on each of its KT = N/8 lanes; per output, KT - 1 adds of
    the partial sums and the FMA with coef·v. ``cols`` does not change the
    count; ``splits`` repeats coef in every block of a row."""
    kt = N // 8
    rows = B * H * T
    instr = (3.0 * rows * N * N
             + rows * splits * (2.0 * N + kt * (kt.bit_length() - 1))
             + rows * N * float(kt))
    esz = torch.tensor([], dtype=dtype).element_size()
    elems = B * T * H * N
    nbytes = 4 * elems * esz + 4 * elems + 4 * H * N + 4 * B * H * N * N
    return max(instr / (PEAK_FP32_FLOPS / 2), nbytes / PEAK_BYTES_PER_S) * 1e3


def check_wkv6(torch, ops, ref, timer, gen, name, B, T, H, N, dtype, reps, plain_reps,
               others=False, misalign=False):
    """One WKV6 shape: kernel vs plain version on the card, then times.
    ``others`` also checks and times every launch ``ops.configs`` lists
    beside ``ops.CONFIG``'s, each bit for bit equal to it; ``misalign``
    hands the kernel r, k, v, w as views one element past a 16-byte
    boundary (TMA cannot take them; the wrapper copies them first)."""
    dev = gen.device

    def make(x):
        if not misalign:
            return x
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
        view = flat[1:].view(x.shape)
        view.copy_(x)
        assert view.data_ptr() % 16 != 0
        return view

    r, k, v = (make((torch.randn((B, T, H, N), generator=gen, device=dev) * 0.5).to(dtype))
               for _ in range(3))
    w = make(torch.exp(-torch.exp(torch.randn((B, T, H, N), generator=gen, device=dev)
                                  - 2.0)))
    u = torch.randn((H, N), generator=gen, device=dev) * 0.5
    y, s = ops.wkv6(r, k, v, w, u)
    yr, sr = ref.wkv6_ref(r, k, v, w, u)
    torch.cuda.synchronize()
    atol, rtol = _tol(torch, dtype, TOL_WKV, ATOL_BF16_WKV_Y)

    def hold(y, s, what):
        err_y = float((y.float() - yr.float()).abs().max()) if y.numel() else 0.0
        err_s = float((s - sr).abs().max())
        if not (torch.isfinite(y.float()).all() and torch.isfinite(s).all()):
            raise AssertionError(f"wkv6 {what}: non-finite output")
        if not torch.allclose(y.float(), yr.float(), atol=atol, rtol=rtol):
            raise AssertionError(f"wkv6 {what}: y max abs err {err_y} beyond atol {atol} "
                                 f"rtol {rtol}")
        if not torch.allclose(s, sr, atol=TOL_WKV, rtol=TOL_WKV):
            raise AssertionError(f"wkv6 {what}: S max abs err {err_s} beyond {TOL_WKV}")
        return err_y, err_s

    err_y, err_s = hold(y, s, name)
    cols, splits = ops.CONFIG[N]
    bound_ms, bound_by = wkv6_bound(torch, B, T, H, N, dtype)
    row = {"shape": name, "B": B, "T": T, "H": H, "N": N, "dtype": str(dtype),
           "misaligned": misalign, "cols": cols, "splits": splits,
           "atol_y": atol, "rtol_y": rtol, "tol_s": TOL_WKV, "max_abs_err": max(err_y, err_s),
           "ms": timer(lambda: ops.wkv6(r, k, v, w, u), reps),
           "plain_ms": timer(lambda: ref.wkv6_ref(r, k, v, w, u), plain_reps),
           "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
           "floor_ms": wkv6_floor(torch, B, T, H, N, dtype, cols, splits),
           "other_splits": {}}
    for c, sp in (ops.configs(N, dtype) if others else ()):
        if (c, sp) == (cols, splits):
            continue
        y2, s2 = ops.launch(r, k, v, w, u, c, sp)
        hold(y2, s2, f"{name} at cols {c} splits {sp}")
        # no step of the kernel's order depends on the launch
        if not (torch.equal(y2, y) and torch.equal(s2, s)):
            raise AssertionError(f"wkv6 {name}: cols {c} splits {sp} differs in its bits "
                                 f"from cols {cols} splits {splits}")
        row["other_splits"][f"cols{c}_splits{sp}"] = timer(
            lambda: ops.launch(r, k, v, w, u, c, sp), reps)
    log(f"phase 7 lm-kernels: wkv6 {name} B={B} T={T} H={H} N={N} {dtype}"
        f"{' misaligned' if misalign else ''}: max abs err y {err_y} S {err_s} (y atol "
        f"{atol} rtol {rtol}, S {TOL_WKV}); cols {cols} splits {splits}: kernel "
        f"{row['ms']} ms plain {row['plain_ms']} ms library none bound {bound_ms} ms "
        f"({bound_by}) floor {row['floor_ms']} ms"
        + (f"; at other launches {json.dumps(row['other_splits'])}" if others else ""))
    return row


def check_flash(torch, ops, ref, timer, gen, name, B, S, H, Hkv, hd, causal, window, dtype,
                reps):
    import torch.nn.functional as F

    dev = gen.device
    q = torch.randn((B, S, H, hd), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((B, S, Hkv, hd), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    o = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    atol, rtol = _tol(torch, dtype, TOL_ATTN, ATOL_BF16_ATTN)
    err = float((o.float() - want.float()).abs().max())
    if o.shape != want.shape or not torch.isfinite(o.float()).all():
        raise AssertionError(f"flash {name}: shape {tuple(o.shape)} or non-finite output")
    if not torch.allclose(o.float(), want.float(), atol=atol, rtol=rtol):
        raise AssertionError(f"flash {name}: max abs err {err} beyond atol {atol} "
                             f"rtol {rtol}")
    # the library yardstick: one SDPA call on the same inputs in its own
    # (B, H, S, hd) layout, with the same mask; never called by the port
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    kw = {"enable_gqa": Hkv != H}
    if causal and window:
        i = torch.arange(S, device=dev)
        diff = i[:, None] - i[None, :]
        kw["attn_mask"] = (diff >= 0) & (diff < window)
    else:
        kw["is_causal"] = causal
    bound_ms, bound_by = flash_bound(torch, B, S, H, Hkv, hd, causal, window, dtype)
    floor_ms = flash_floor(torch, B, S, H, Hkv, hd, causal, window, dtype)
    row = {"shape": name, "B": B, "S": S, "H": H, "Hkv": Hkv, "hd": hd, "causal": causal,
           "window": window, "dtype": str(dtype), "atol": atol, "rtol": rtol,
           "max_abs_err": err,
           "ms": timer(lambda: ops.flash_attention(q, k, v, causal=causal, window=window),
                       reps),
           "plain_ms": timer(lambda: ref.attention_ref(q, k, v, causal=causal,
                                                       window=window), reps),
           "library_ms": timer(lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw),
                               reps),
           "bound_ms": bound_ms, "bound_by": bound_by, "floor_ms": floor_ms}
    log(f"phase 7 lm-kernels: flash {name} B={B} S={S} H={H} Hkv={Hkv} hd={hd} causal "
        f"{causal} window {window} {dtype}: max abs err {err} (atol {atol} rtol {rtol}); "
        f"kernel "
        f"{row['ms']} ms plain {row['plain_ms']} ms sdpa {row['library_ms']} ms bound "
        f"{bound_ms} ms ({bound_by}) floor {floor_ms} ms")
    return row


def rel_err(torch, got, want) -> float:
    """||got - want|| / ||want|| in fp64 (0 when both are 0)."""
    d = (got.double() - want.double()).norm()
    n = want.double().norm()
    return float(d / n) if n > 0 else float(d)


def flip_ulps(torch, x, frac, gen):
    """x with a random ``frac`` of its elements moved one ulp away from 0
    (one added to their bit pattern)."""
    itype = {2: torch.int16, 4: torch.int32}[x.element_size()]
    pick = torch.rand(x.shape, generator=gen, device=x.device) < frac
    return (x.contiguous().view(itype) + pick.to(itype)).view(x.dtype)


def _state_leaves(state):
    """(name, tensor) for every leaf of a decode state, in a fixed order."""
    out = []
    for u, unit in enumerate(state["units"]):
        for b, st in unit.items():
            out += [(f"unit{u}.{b}.{k}", t) for k, t in st.items()]
    for b, st in state.get("rem", {}).items():
        out += [(f"rem.{b}.{k}", t) for k, t in st.items()]
    return out


def _trace(torch, fn, top: int):
    """Run ``fn`` under ``torch.profiler``: wall time, the device's busy
    time (the sum over the device-side events: kernels, copies, memsets,
    all on one stream) and its busy share, and the events that take most of
    the device and of the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        t = getattr(e, "device_time_total", None)
        return getattr(e, "cuda_time_total", 0) if t is None else t

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    on_dev = [e for e in events if e.device_type == DeviceType.CUDA]
    on_host = [e for e in events if e.device_type == DeviceType.CPU]
    busy_ms = sum(dev_us(e) for e in on_dev) / 1e3
    by_dev = sorted(on_dev, key=dev_us, reverse=True)[:top]
    by_cpu = sorted(on_host, key=lambda e: e.self_cpu_time_total, reverse=True)[:top]
    return out, {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
        "top_device": [{"name": e.key, "count": e.count, "device_ms": dev_us(e) / 1e3}
                       for e in by_dev],
        "top_host": [{"name": e.key, "count": e.count,
                      "self_cpu_ms": e.self_cpu_time_total / 1e3} for e in by_cpu],
    }


def profile_lm(torch, lm, params, cfg, prompts, max_len, top: int = 8) -> dict:
    """One prefill, then 4 decode steps, each traced on its own."""
    n = prompts.shape[1]

    def decode(state, tok):
        for i in range(4):
            logits, state = lm.decode_step(params, cfg, state, tok, n + i)
            tok = logits[:, -1].argmax(-1)[:, None]
        return tok

    with torch.inference_mode():
        (last, state), pre = _trace(torch, lambda: lm.lm_prefill(params, cfg, prompts,
                                                                 max_len), top)
        _, dec = _trace(torch, lambda: decode(state, last.argmax(-1)[:, None]), top)
    return {"prefill": pre, "decode_4_steps": dec}


def lm_serve(torch, serve, counters, cfg, dev, tag, batch, prompt, gen) -> dict:
    """Phase 8 for one model: ``serve`` at full width with every launch
    counter set to 0 just before and read just after; the prefill must
    launch the WKV6 kernel once per ``rwkv`` block and flash attention once
    per ``attn``/``local`` block, and nothing else."""
    kinds = list(cfg.block_pattern) * cfg.n_units + list(cfg.remainder_pattern)
    want = {n: 0 for n in counters}
    want["wkv6"] = kinds.count("rwkv")
    want["flash_attention"] = len(kinds) - kinds.count("rwkv")
    args = argparse.Namespace(arch=cfg.arch_id, batch=batch, prompt_len=prompt, gen=gen,
                              seed=0, device=str(dev))
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    out = serve(args, cfg=cfg)
    torch.cuda.synchronize()
    got = {n: c.launches for n, c in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    toks = out["tokens"]
    if (tuple(toks.shape) != (batch, gen) or int(toks.min()) < 0
            or int(toks.max()) >= cfg.vocab_size):
        raise AssertionError(f"lm-serve {cfg.arch_id}: tokens {tuple(toks.shape)} or out "
                             "of the vocabulary")
    log(f"phase 8 lm-serve: {tag}: {cfg.arch_id} ({cfg.param_count():,} params, "
        f"{cfg.dtype}) batch {batch} prompt {prompt} gen {gen}: prefill "
        f"{out['prefill_s'] * 1e3} ms, decode {out['decode_tok_s']} tokens/s, peak memory "
        f"{peak_gb} GB; launches over the prefill {json.dumps(got)}")
    if got != want:
        raise AssertionError(f"lm-serve {cfg.arch_id}: launches {got}, want {want}")
    return {"params": cfg.param_count(), "batch": batch, "prompt": prompt, "gen": gen,
            "prefill_ms": out["prefill_s"] * 1e3, "decode_tok_s": out["decode_tok_s"],
            "peak_gb": peak_gb, "launches": got}


def lm_check_full(torch, lm, rmsnorm, cfg, dev, tag, batch, prompt, gen, profile) -> dict:
    """Phase 9 at full width, on the weights and prompts ``serve`` drew
    (seed 0).

    Gated, block by block: the prefill runs along the kernel path, and at
    every block the same input also goes through the block's plain path;
    the block's output and its decode state (S, ``x_tm``, ``x_cm`` or the
    K/V) must agree within ``TOL_BLOCK_REL`` (relative L2). Then the last
    logits of that walk must equal those of ``lm_prefill``.

    Recorded, no gate: the first prefill after the init (allocations
    included) and the steady state (the median of three more); the whole
    prefill along the plain path against the kernel path's; and, as its
    witness, the plain path against itself with one bf16 ulp flipped in a
    random share of the first block's output, the share of that output in
    which the kernel path differs from the plain path. If the witness diverges as far as the kernel path does, the stack
    (random bf16 weights) amplifies any one-ulp difference, and the
    end-to-end number measures the model, not a kernel.

    With ``profile``, a traced prefill + 4 decode steps."""
    g = torch.Generator(device=dev).manual_seed(0)
    params = lm.init_lm(g, cfg, dev)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=g, device=dev)
    max_len = prompt + gen
    blocks = [(f"unit{u}.b{i}", up[f"b{i}"], kind) for u, up in enumerate(params["units"])
              for i, kind in enumerate(cfg.block_pattern)]
    blocks += [(f"rem.b{i}", params["rem"][f"b{i}"], kind)
               for i, kind in enumerate(cfg.remainder_pattern)]
    errs = {}
    first_plain = flip_frac = None
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last_k, st_k = lm.lm_prefill(params, cfg, prompts, max_len)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        # the first call after a fresh init allocates its activations anew;
        # three more give the steady state
        steady = []
        for _ in range(3):
            ts = time.perf_counter()
            lm.lm_prefill(params, cfg, prompts, max_len)
            torch.cuda.synchronize()
            steady.append((time.perf_counter() - ts) * 1e3)
        t_walk = time.perf_counter()
        h = params["embed"][prompts]
        for name, bp, kind in blocks:
            out_k, _, sk = lm.apply_block_full(bp, cfg, kind, h, collect_state=True)
            out_p, _, sp = lm.apply_block_full(bp, cfg, kind, h, collect_state=True,
                                               use_kernel=False)
            if not torch.isfinite(out_k.float()).all():
                raise AssertionError(f"lm-check {cfg.arch_id}: {name} output not finite")
            errs[f"{name}.out"] = rel_err(torch, out_k, out_p)
            for key in sk:
                errs[f"{name}.{key}"] = rel_err(torch, sk[key], sp[key])
            if first_plain is None:
                first_plain = out_p
                flip_frac = float((out_k != out_p).double().mean())
            h = out_k
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        walk_last = rmsnorm(params["final_norm"], h, cfg.norm_eps)[:, -1] @ head
        errs["last_logits_vs_lm_prefill"] = rel_err(torch, walk_last, last_k)
        del h, out_k, out_p, sk, sp
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        last_p, st_p = lm.lm_prefill(params, cfg, prompts, max_len, use_kernel=False)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        # the witness: the plain path from the first block's plain output
        # with one ulp flipped in ``flip_frac`` of it
        h = flip_ulps(torch, first_plain, flip_frac, torch.Generator(device=dev).manual_seed(1))
        witness = {"flip_frac": flip_frac,
                   "first_block_rel_err": rel_err(torch, h, first_plain),
                   "kernel_first_block_rel_err": errs[f"{blocks[0][0]}.out"]}
        for _, bp, kind in blocks[1:]:
            h, _, _ = lm.apply_block_full(bp, cfg, kind, h, use_kernel=False)
        last_w = rmsnorm(params["final_norm"], h, cfg.norm_eps)[:, -1] @ head
        witness["last_logits_rel_err"] = rel_err(torch, last_w, last_p)
        del h, first_plain, last_w
    free = {"last_logits": rel_err(torch, last_k, last_p)}
    for (name, a), (_, b) in zip(_state_leaves(st_k), _state_leaves(st_p)):
        free[name] = rel_err(torch, a, b)
    worst = max(errs, key=errs.get)
    free_worst = max(free, key=free.get)
    row = {"block_rel_err": errs, "free_running_rel_err": free, "ulp_witness": witness,
           "warm_prefill_ms": (t1 - t0) * 1e3,
           "steady_prefill_ms": sorted(steady)[1], "plain_prefill_ms": (t3 - t2) * 1e3,
           "block_walk_s": t2 - t_walk}
    log(f"phase 9 lm-check: {cfg.arch_id} full width {cfg.dtype}, block by block on the "
        f"card ({len(blocks)} blocks, kernel path vs plain path on the same input): worst "
        f"of {len(errs)} relative L2 errors {worst} {errs[worst]} (tol {TOL_BLOCK_REL}); "
        f"walk's last logits vs lm_prefill {errs['last_logits_vs_lm_prefill']}")
    log(f"phase 9 lm-check: {cfg.arch_id} free-running (recorded, no gate): plain-path "
        f"prefill vs kernel-path prefill relative L2 error last logits "
        f"{free['last_logits']}, worst {free_worst} {free[free_worst]}; first block's "
        f"state {list(free.items())[1]}; warm prefill kernel path {row['warm_prefill_ms']} "
        f"ms (steady, median of 3 more: {row['steady_prefill_ms']} ms), plain path "
        f"{row['plain_prefill_ms']} ms")
    log(f"phase 9 lm-check: {cfg.arch_id} witness (recorded, no gate): plain path with one "
        f"bf16 ulp flipped in {witness['flip_frac']} of the first block's output (relative "
        f"L2 {witness['first_block_rel_err']}; the kernel path's there "
        f"{witness['kernel_first_block_rel_err']}) vs the plain path, last logits relative "
        f"L2 {witness['last_logits_rel_err']} (kernel path vs plain path "
        f"{free['last_logits']})")
    if errs[worst] > TOL_BLOCK_REL or not torch.isfinite(last_k.float()).all():
        raise AssertionError(f"lm-check {cfg.arch_id}: {worst} relative error "
                             f"{errs[worst]} beyond {TOL_BLOCK_REL}")
    del last_k, st_k, last_p, st_p
    if profile:
        row["profile"] = profile_lm(torch, lm, params, cfg, prompts, max_len)
        for what, prof in row["profile"].items():
            log(f"profile: {tag}: {cfg.arch_id} {what} wall {prof['wall_ms']} ms, device "
                f"busy {prof['device_busy_ms']} ms (share {prof['device_busy_share']})")
            for e in prof["top_device"]:
                log(f"profile: {cfg.arch_id} {what} device {e['device_ms']} ms "
                    f"x{e['count']} {e['name']}")
            for e in prof["top_host"]:
                log(f"profile: {cfg.arch_id} {what} host {e['self_cpu_ms']} ms "
                    f"x{e['count']} {e['name']}")
    return row


def lm_check_smoke(torch, lm, cfg, dev, from_numpy, to_numpy) -> float:
    """Phase 9 at a smoke configuration (fp32): the same params on the card
    (kernel path) and on the CPU (plain path); the prefill's last logits and
    decode state, then 4 decode steps fed the same tokens, at 1e-4."""
    cpu_params = lm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    params = from_numpy(to_numpy(cpu_params), cfg, dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(1))
    steps = torch.randint(0, cfg.vocab_size, (4, 2, 1),
                          generator=torch.Generator().manual_seed(2))
    errs = []

    def hold(a, b, what):
        errs.append(float((a.cpu() - b).abs().max()))
        if not torch.allclose(a.cpu(), b, atol=TOL_LOGITS, rtol=TOL_LOGITS):
            raise AssertionError(f"lm-check {cfg.arch_id} smoke fp32: {what}: card vs CPU "
                                 f"max abs diff {errs[-1]}")

    with torch.inference_mode():
        got, st = lm.lm_prefill(params, cfg, toks.to(dev), 44)
        want, st_c = lm.lm_prefill(cpu_params, cfg, toks, 44)
        hold(got, want, "prefill logits")
        leaves = list(zip(_state_leaves(st), _state_leaves(st_c)))
        for (name, a), (_, b) in leaves:
            hold(a, b, name)
        for i in range(4):
            o, st = lm.decode_step(params, cfg, st, steps[i].to(dev), 40 + i)
            o_c, st_c = lm.decode_step(cpu_params, cfg, st_c, steps[i], 40 + i)
            hold(o, o_c, f"decode step {i}")
    log(f"phase 9 lm-check: {cfg.arch_id} smoke fp32, kernel path on the card vs plain "
        f"path on the CPU: prefill logits, {len(leaves)} state leaves and 4 decode steps "
        f"max abs diff {max(errs)} (tol {TOL_LOGITS})")
    return max(errs)


def spmm_training_shapes(torch, ops, ref, timer, fed, dev, gen, rng) -> tuple[list, dict]:
    """Phase 3 at the training path's shapes, from client 0 of the train
    phase's partition: the loss pass's adjacency (all n_max rows over the
    n_tot = n_max + g_max columns of [own | ghost]) @ the 500 features and @
    the 256 of layer 1; a batch step's (256 sampled rows, neighbors kept by
    the fanout of 10) @ 500 and @ 256; and the backward's transposed launch,
    Aᵀ (n_tot x 256) @ dy (256 x 256), whose rows do not sum to 1. The
    backward is also held through autograd: ``block_spmm``'s against
    autograd of the plain version, at 1e-5, launching the kernel twice."""
    from repro_torch.core.importance import stable_rank

    n_tot = fed.n_max + fed.g_max
    idx = torch.tensor(fed.nbr_idx[0], device=dev)
    nm = torch.tensor(fed.nbr_mask[0], device=dev)
    table0 = torch.cat([torch.tensor(fed.features[0], device=dev),
                        torch.randn((fed.g_max, fed.n_features), generator=gen, device=dev)])
    table1 = torch.randn((n_tot, 256), generator=gen, device=dev)
    rows = []
    a = ops.adjacency_from_neighbors(idx, nm, n_tot)
    mk = ops.adjacency_block_mask(idx, nm, n_tot, ops.TILE_M, ops.TILE_K)
    rows.append(check_spmm(torch, ops, ref, timer, "train_loss_pass_f500", a, table0, mk, 5))
    rows.append(check_spmm(torch, ops, ref, timer, "train_loss_pass_h256", a, table1, mk, 5))
    del a, mk
    batch = torch.tensor(rng.choice(int(fed.client_sizes[0]), 256, replace=False), device=dev)
    b_idx, b_mask = idx[batch], nm[batch]
    ranks = torch.where(b_mask > 0, torch.rand(b_mask.shape, generator=gen, device=dev), 2.0)
    b_mask = b_mask * (stable_rank(ranks) < 10)
    a = ops.adjacency_from_neighbors(b_idx, b_mask, n_tot)
    mk = ops.adjacency_block_mask(b_idx, b_mask, n_tot, ops.TILE_M, ops.TILE_K)
    rows.append(check_spmm(torch, ops, ref, timer, "train_batch_f500", a, table0, mk, 20))
    rows.append(check_spmm(torch, ops, ref, timer, "train_batch_h256", a, table1, mk, 20))
    dy = torch.randn((a.shape[0], 256), generator=gen, device=dev)
    rows.append(check_spmm(torch, ops, ref, timer, "train_transposed_h256",
                           a.t().contiguous(), dy, mk.t().contiguous(), 20))
    x = table1.clone().requires_grad_(True)
    before = ops.block_spmm.launches
    ops.block_spmm(a, x, mk).backward(dy)
    torch.cuda.synchronize()
    launched = ops.block_spmm.launches - before
    xp = table1.clone().requires_grad_(True)
    ref.spmm_ref(a, xp).backward(dy)
    err = float((x.grad - xp.grad).abs().max())
    log(f"phase 3 kernels: spmm backward through autograd (train_batch_h256): dx = Aᵀ·dy by "
        f"the kernel ({launched} launches: forward + transposed) vs autograd of the plain "
        f"version, max abs err {err}")
    if launched != 2 or not torch.allclose(x.grad, xp.grad, atol=TOL_KERNEL, rtol=TOL_KERNEL):
        raise AssertionError(f"spmm backward: {launched} launches, max abs err {err}")
    return rows, {"shape": "train_batch_h256", "launches": launched, "max_abs_err": err}


def poisoned_fallbacks(torch, g, idx, mask, params, dev, ids, GraphStore, ServedModel,
                       QueryEngine) -> dict:
    """Phase 6: one NaN feature row (a neighbor of the first query, not row
    0, which padding slots name), fresh queries in chunks of 8 with the
    fallback on: ``n_fallbacks`` under gather, segment and spmm on the
    card, and spmm on the CPU. Each backend lets the NaN reach only the
    rows that name it, so all four count the same chunks, some but not
    all of them."""
    nbrs = idx[ids[0]][mask[ids[0]] > 0]
    bad = int(nbrs[nbrs != 0][0])
    feats = g.features.copy()
    feats[bad] = float("nan")
    cases = [(be, dev) for be in ("gather", "segment", "spmm")] + [("spmm", "cpu")]
    counts = {}
    for be, d in cases:
        model = ServedModel({k: v.to(d) for k, v in params.items()},
                            GraphStore(feats, idx, mask), backend=be, warm="cold", device=d)
        engine = QueryEngine(model, buckets=(8,), fallback=True)
        for i in range(0, len(ids), 8):
            engine.query(ids[i: i + 8], policy="fresh")
        counts[f"{be}_{torch.device(d).type}"] = engine.n_fallbacks
    n_chunks = -(-len(ids) // 8)
    log(f"phase 6 check: feature row {bad} poisoned, {n_chunks} fresh chunks of 8: "
        f"fallbacks {json.dumps(counts)}")
    if len(set(counts.values())) != 1 or not 0 < counts[f"spmm_{dev.type}"] < n_chunks:
        raise AssertionError(f"check: fallbacks differ by backend or reach no/every chunk: "
                             f"{counts}")
    return {"row": bad, "chunks": n_chunks, "fallbacks": counts}


class RoundTimer:
    """A round callback: the host clock at the end of each round, after a
    synchronise (the round's work is done), and the cohorts."""

    def __init__(self, torch):
        self.torch = torch
        self.stamps = []

    def on_run_start(self, engine, state):
        self.torch.cuda.synchronize()
        self.stamps = [time.perf_counter()]

    def on_round_end(self, ctx):
        self.torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())

    def on_run_end(self, engine, state):
        pass


def train_run(torch, api, fed_args, fedais, counters) -> dict:
    """One seeded ``FedEngine(...).run()`` with every launch counter set to 0
    just before and read just after, keeping every sampled batch (a wrapper
    around ``core.fedais.sample_batch``)."""
    g, fed, kw = fed_args
    timer = RoundTimer(torch)
    eng = api.FedEngine(g, fed, "fedais", callbacks=[api.EvalCallback(), api.HistoryCallback(),
                                                     timer], **kw)
    state = eng.init_state()
    batches = []
    real = fedais.sample_batch

    def sample_batch(*a, **k):
        out = real(*a, **k)
        batches.append(out[0].clone())
        return out

    fedais.sample_batch = sample_batch
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        res = eng.run(state)
        torch.cuda.synchronize()
        launches = {n: c.launches for n, c in counters.items()}
    finally:
        fedais.sample_batch = real
    ms = [(b - a) * 1e3 for a, b in zip(timer.stamps, timer.stamps[1:])]
    return {"engine": eng, "state": state, "result": res, "launches": launches,
            "round_ms": ms, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "batches": batches}


def train_first_update(torch, fedais, ops, ref, eng, state, k, dev) -> dict:
    """The first LocalUpdate of client ``k`` (round 0's first) under ``spmm``
    against ``gather`` on the card, from the same round-start tables and
    the same draws (a ``TorchDraws`` seeded alike): the sampled batches,
    fanout ranks, ghost ``need`` masks, ``n_sync`` and ``n_ghost_pulled``
    exact; ``loss_all`` and the first step's grads at 1e-4. The first
    backward's A and dy (a real step's) are kept to hold the transposed
    launch on them."""
    client = {n: v[k] for n, v in state.arrays.items()}
    names = ("sample_batch", "stable_rank", "ghost_need", "adamw_update")
    out, logs = {}, {}
    real = {n: getattr(fedais, n) for n in names}
    real_bwd = ops._BlockSpmm.backward
    seen = []

    def bwd(ctx, dy):
        if not seen:
            seen.append((ctx.saved_tensors[0].detach().clone(), dy.detach().clone()))
        return real_bwd(ctx, dy)

    for be in ("spmm", "gather"):
        log_be = logs[be] = {n: [] for n in names}
        for n in names:
            def wrapped(*a, _r=real[n], _n=n, _l=log_be, **kw):
                o = _r(*a, **kw)
                _l[_n].append((a, o))
                return o
            setattr(fedais, n, wrapped)
        ops._BlockSpmm.backward = staticmethod(bwd)
        try:
            one = fedais.make_local_update(eng.mcfg, eng.fed.n_max, train_backend=be)
            out[be] = one(state.params, client, state.arrays["features"],
                          state.hist.hist1, state.hist.hist1[k], state.hist.age[k],
                          state.hist.ghost_feat[k], state.prev_loss[k], state.tau,
                          eng.mcfg.neighbor_fanout, 0,
                          fedais.TorchDraws(eng.seed, dev))
            torch.cuda.synchronize()
        finally:
            for n in names:
                setattr(fedais, n, real[n])
            ops._BlockSpmm.backward = real_bwd
    s, gth = logs["spmm"], logs["gather"]
    exact = {}
    for n in ("sample_batch", "stable_rank", "ghost_need"):
        exact[n] = len(s[n]) == len(gth[n]) and all(
            all(torch.equal(x, y) for x, y in zip(
                o1 if isinstance(o1, tuple) else (o1,), o2 if isinstance(o2, tuple) else (o2,)))
            for (_, o1), (_, o2) in zip(s[n], gth[n]))
    st_s, st_g = out["spmm"][4], out["gather"][4]
    exact["n_sync"] = st_s["n_sync"] == st_g["n_sync"]
    exact["n_ghost_pulled"] = float(st_s["n_ghost_pulled"]) == float(st_g["n_ghost_pulled"])
    loss_err = float((st_s["loss_all"] - st_g["loss_all"]).abs().max())
    grads_s, grads_g = s["adamw_update"][0][0][0], gth["adamw_update"][0][0][0]
    grad_err = max(float((grads_s[n] - grads_g[n]).abs().max()) for n in grads_s)
    close = (torch.allclose(st_s["loss_all"], st_g["loss_all"], atol=TOL_LOGITS,
                            rtol=TOL_LOGITS)
             and all(torch.allclose(grads_s[n], grads_g[n], atol=TOL_LOGITS, rtol=TOL_LOGITS)
                     for n in grads_s))
    a, dy = seen[0]
    want = ref.spmm_ref(a.t(), dy)
    got = ops.block_spmm(a.t().contiguous(), dy)
    real_dy_err = float((got - want).abs().max())
    log(f"phase 10 train: first LocalUpdate of client {k}, spmm vs gather on the card, same "
        f"draws: exact {json.dumps(exact)}; loss_all max abs diff {loss_err}, first step's "
        f"grads {grad_err} (gate 1e-4); the transposed launch on that step's real dy "
        f"({tuple(dy.shape)}, max |dy| {float(dy.abs().max())}) vs the plain version, max abs "
        f"err {real_dy_err} (recorded)")
    if not all(exact.values()) or not close:
        raise AssertionError(f"train: spmm vs gather first LocalUpdate: exact {exact}, loss "
                             f"{loss_err}, grads {grad_err}")
    return {"client": k, "exact": exact, "loss_all_err": loss_err, "grad_err": grad_err,
            "real_dy_max_abs_err": real_dy_err}


def profile_traffic(torch, engine, load_cls, top: int = 8) -> dict:
    """A second closed-loop run (seed 1) under ``torch.profiler``."""
    gen = load_cls(engine, seed=1, n_queries=200, n_updates=20, mode="closed",
                   concurrency=8, policy_mix={"historical": 0.9, "fresh": 0.1})
    return _trace(torch, gen.run, top)[1]


class RecordingSelector:
    """The default selector, keeping the cohorts it drew."""

    def __init__(self, base):
        self.base, self.cohorts = base, []

    def select(self, engine, state):
        sel = self.base.select(engine, state)
        self.cohorts.append([int(c) for c in sel])
        return sel


def train_phase(torch, api, fedais, ops, ref, counters, g, fed, dev, tag,
                profile) -> tuple[dict, int]:
    """Phase 10: ``FedEngine(g, fed, "fedais", ...).run()`` on the card with
    ``train_backend = eval_backend = "spmm"``, twice from the same seed.
    Gates: the SpMM launched exactly rounds x (m·(2 + 3J) + 2) times and
    nothing else launched (a loss pass and J steps of 2 forward + 1
    transposed launch per client, the eval's 2 layers per round); finite
    history; the two runs draw the same cohorts and batches and give the
    same tau and test_acc bits; the first LocalUpdate under spmm against
    gather (``train_first_update``). Recorded: ms per round (the first,
    then the steady rounds), peak memory, test_acc per round; under
    ``profile`` a traced steady round."""
    runs = []
    for _ in range(2):
        sel = RecordingSelector(api.UniformSelector())
        kw = dict(rounds=TRAIN_ROUNDS, clients_per_round=TRAIN_M, seed=0, selector=sel,
                  train_backend="spmm", eval_backend="spmm", device=dev)
        run = train_run(torch, api, (g, fed, kw), fedais, counters)
        run["cohorts"] = sel.cohorts
        runs.append(run)
    r1, r2 = runs
    eng, res = r1["engine"], r1["result"]
    J = eng.mcfg.local_epochs
    want = {n: 0 for n in counters}
    want["spmm"] = TRAIN_ROUNDS * (TRAIN_M * (2 + 3 * J) + 2)
    hist = res.history
    steady = sorted(r1["round_ms"][1:] + r2["round_ms"][1:])
    log(f"phase 10 train: {tag}: fedais on pubmed ({fed.n_clients} clients, {TRAIN_M} a "
        f"round, J {J}, batch {eng.bsz}, fanout {eng.mcfg.neighbor_fanout}, GraphSAGE "
        f"{eng.H1}/128, spmm) {TRAIN_ROUNDS} rounds: ms per round {r1['round_ms']} (second "
        f"run {r2['round_ms']}); first {r1['round_ms'][0]}, steady median "
        f"{steady[len(steady) // 2]}; peak memory {r1['peak_gb']} GB; launches "
        f"{json.dumps(r1['launches'])} (want {json.dumps(want)}); cohorts {r1['cohorts']}; "
        f"tau {hist['tau']}; test_acc {hist['test_acc']}; test_loss {hist['test_loss']}")
    if r1["launches"] != want or r2["launches"] != want:
        raise AssertionError(f"train: launches {r1['launches']} / {r2['launches']}, want {want}")
    if (len(hist["test_acc"]) != TRAIN_ROUNDS or not all(0.0 <= a <= 1.0 for a in hist["test_acc"])
            or not all(math.isfinite(x) for x in hist["test_loss"])):
        raise AssertionError(f"train: history {hist}")
    same = {"cohorts": r1["cohorts"] == r2["cohorts"],
            "batches": len(r1["batches"]) == len(r2["batches"]) == TRAIN_ROUNDS * TRAIN_M * J
            and all(torch.equal(a, b) for a, b in zip(r1["batches"], r2["batches"])),
            "tau": hist["tau"] == r2["result"].history["tau"],
            "test_acc": hist["test_acc"] == r2["result"].history["test_acc"]}
    log(f"phase 10 train: a second seeded run: the same {json.dumps(same)}")
    if not all(same.values()):
        raise AssertionError(f"train: two seeded runs differ: {same}")
    first = train_first_update(torch, fedais, ops, ref, eng, eng.init_state(),
                               r1["cohorts"][0][0], dev)
    rec = {"rounds": TRAIN_ROUNDS, "clients_per_round": TRAIN_M, "local_epochs": J,
           "batch": eng.bsz, "round_ms": [r1["round_ms"], r2["round_ms"]],
           "first_round_ms": r1["round_ms"][0], "steady_round_ms": steady[len(steady) // 2],
           "peak_gb": r1["peak_gb"], "launches": r1["launches"], "history": hist,
           "final": res.final, "cohorts": r1["cohorts"], "first_update": first}
    if profile:
        sel = RecordingSelector(api.UniformSelector())
        peng = api.FedEngine(g, fed, "fedais", rounds=2, clients_per_round=TRAIN_M, seed=0,
                             selector=sel, train_backend="spmm", eval_backend="spmm",
                             device=dev)
        pstate = peng.init_state()
        peng.run_round(pstate, 0)
        _, prof = _trace(torch, lambda: peng.run_round(pstate, 1), 10)
        rec["profile"] = prof
        log(f"profile: {tag}: train round 1 wall {prof['wall_ms']} ms, device busy "
            f"{prof['device_busy_ms']} ms (share {prof['device_busy_share']})")
        for e in prof["top_device"]:
            log(f"profile: train device {e['device_ms']} ms x{e['count']} {e['name']}")
        for e in prof["top_host"]:
            log(f"profile: train host {e['self_cpu_ms']} ms x{e['count']} {e['name']}")
    return rec, r1["launches"]["spmm"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the record as JSON here")
    ap.add_argument("--profile", action="store_true",
                    help="trace a second traffic run after phase 6, one LM "
                         "prefill + 4 decode steps per model in phase 9 and one "
                         "training round in phase 10 with torch.profiler, and "
                         "print where their time goes")
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

    import repro_torch.api as api
    import repro_torch.core.fedais as fedais
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.convert import (
        lm_params_from_numpy,
        lm_params_to_numpy,
        params_from_numpy,
        params_to_numpy,
    )
    from repro_torch.federated.partition import partition_graph
    from repro_torch.federated.server import build_eval_graph, eval_logits, evaluate_global
    from repro_torch.graph.csr import build_padded_neighbors
    from repro_torch.graph.data import make_dataset
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.spmm import ops, ref
    from repro_torch.kernels.wkv6 import ops as wops
    from repro_torch.kernels.wkv6 import ref as wref
    from repro_torch.launch.serve_lm_cli import serve
    from repro_torch.launch.train import mini_config
    from repro_torch.models import lm
    from repro_torch.models.layers import rmsnorm
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
    # the bf16 flash kernel runs on the tensor cores (HGMMA is wgmma in
    # SASS) and spills nothing
    hgmma = sass_count(build, "flash_attention", "HGMMA")
    tc_fns = {}
    for n, r in res_usage(build, "flash_attention").items():
        m = re.search(r"flash_fwd_tc_kernelILi(\d+)E", n)
        if m:
            tc_fns[f"flash_fwd_tc_kernel<{m.group(1)}>"] = {
                "registers": r.get("REG"), "stack_bytes": r.get("STACK"),
                "local_bytes": r.get("LOCAL")}
    for n, r in sorted(tc_fns.items()):
        log(f"phase 2 build: flash_attention: {n}: {r['registers']} registers at launch "
            f"(setmaxnreg then gives the consumers 240), stack {r['stack_bytes']} B, "
            f"local {r['local_bytes']} B: nothing spilled")
    log(f"phase 2 build: flash_attention: {hgmma} HGMMA instructions in the library's "
        f"SASS; {len(tc_fns)} tensor-core kernel instances")
    if hgmma == 0:
        raise AssertionError("build: no HGMMA in the flash attention library: the bf16 "
                             "kernel does not run on the tensor cores")
    # three widths (64, 128, 256), none with a stack frame or local memory
    if len(tc_fns) != 3 or any(r["stack_bytes"] != 0 or r["local_bytes"] != 0
                               for r in tc_fns.values()):
        raise AssertionError(f"build: the bf16 flash kernel's instances spill or are "
                             f"missing: {tc_fns}")
    record["flash_build"] = {"hgmma": hgmma, "tc_kernels": tc_fns}
    # every instance of the wkv6 kernel (3 head sizes x 3 column tiles x 2
    # types) keeps its state tile in registers: no stack, no local memory
    wkv_fns = {n: {"registers": r.get("REG"), "stack_bytes": r.get("STACK"),
                   "local_bytes": r.get("LOCAL")}
               for n, r in res_usage(build, "wkv6").items() if "wkv6_kernel" in n}
    for n, r in sorted(wkv_fns.items()):
        log(f"phase 2 build: wkv6: {n}: {r['registers']} registers, stack "
            f"{r['stack_bytes']} B, local {r['local_bytes']} B")
    if len(wkv_fns) != 18 or any(r["stack_bytes"] != 0 or r["local_bytes"] != 0
                                 for r in wkv_fns.values()):
        raise AssertionError(f"build: wkv6 kernel instances spill or are missing: {wkv_fns}")
    record["wkv6_build"] = wkv_fns
    # every instance of the SpMM kernel (4 column widths x 16-byte or 4-byte
    # loads of X) keeps its sums and its batch of A in registers
    spmm_fns = {n: {"registers": r.get("REG"), "stack_bytes": r.get("STACK"),
                    "local_bytes": r.get("LOCAL")}
                for n, r in res_usage(build, "spmm").items() if "spmm_nnz_kernel" in n}
    for n, r in sorted(spmm_fns.items()):
        log(f"phase 2 build: spmm: {n}: {r['registers']} registers, stack "
            f"{r['stack_bytes']} B, local {r['local_bytes']} B")
    if len(spmm_fns) != 8 or any(r["stack_bytes"] != 0 or r["local_bytes"] != 0
                                 for r in spmm_fns.values()):
        raise AssertionError(f"build: spmm kernel instances spill or are missing: "
                             f"{spmm_fns}")
    record["spmm_build"] = spmm_fns

    # -- the configuration ------------------------------------------------------
    g = make_dataset("pubmed", scale=1, max_features=500, seed=0)
    idx, mask = build_padded_neighbors(g.adjacency_lists(), 32, seed=0)
    store = GraphStore(g.features, idx, mask)
    cap, n_nodes = store.capacity, g.n_nodes
    log(f"config: pubmed scale 1: {n_nodes} nodes, {len(g.edges)} edges, "
        f"{g.n_features} features, {g.n_classes} classes, hidden {HIDDEN}, "
        f"max_deg 32, capacity {cap}")
    t0 = time.perf_counter()
    fed = partition_graph(g, TRAIN_CLIENTS, alpha=0.5, seed=0)
    log(f"config: train: {TRAIN_CLIENTS} clients (Dirichlet alpha 0.5), n_max {fed.n_max}, "
        f"g_max {fed.g_max}, n_tot {fed.n_max + fed.g_max}, client sizes "
        f"{fed.client_sizes.tolist()}, {fed.n_cross_edges} cross edges; partitioned in "
        f"{time.perf_counter() - t0:.2f} s")

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
    nonfinite = [check_spmm_nonfinite(torch, ops, "fresh_b128", a, feat, mk)]
    del a, mk
    a = torch.rand((1000, 3001), generator=gen, device=dev)
    a = torch.where(torch.rand(a.shape, generator=gen, device=dev) < 0.01, a, 0.0)
    x = torch.randn((3001, 77), generator=gen, device=dev)
    mk = ops.block_mask_from_dense(a, ops.TILE_M, ops.TILE_K)
    shapes.append(check_spmm(torch, ops, ref, timer, "ragged", a, x, mk, 20))
    nonfinite.append(check_spmm_nonfinite(torch, ops, "ragged", a, x, mk))
    # the shapes below draw from their own generator, so that the later
    # phases draw what they drew before these were added. More than 1,024
    # mask columns (two windows of the kernel's live-tile list) and D over
    # 512 (two column slabs, the second ragged)
    gen_new = torch.Generator(device=dev).manual_seed(1)
    a = torch.rand((100, 40000), generator=gen_new, device=dev)
    a = torch.where(torch.rand(a.shape, generator=gen_new, device=dev) < 0.002, a, 0.0)
    x = torch.randn((40000, 600), generator=gen_new, device=dev)
    shapes.append(check_spmm(torch, ops, ref, timer, "windows_slabs", a, x,
                             ops.block_mask_from_dense(a, ops.TILE_M, ops.TILE_K), 10))
    # every element nonzero: 32 FMAs per row of every tile, each row summing
    # to 1 as the mean aggregation's adjacency does
    a_raw = torch.rand((512, 2048), generator=gen_new, device=dev) + 0.1
    x = torch.randn((2048, 128), generator=gen_new, device=dev)
    mk = ops.block_mask_from_dense(a_raw, ops.TILE_M, ops.TILE_K)
    a = a_raw / a_raw.sum(1, keepdim=True)
    shapes.append(check_spmm(torch, ops, ref, timer, "dense", a, x, mk, 5))
    # recorded, no gate: the rows before they are normalised (entries in
    # [0.1, 1.1), |y| above 100), where a chain of 2,048 / splits fp32
    # FMAs per output drifts from the library's blocked sums
    want = ref.spmm_ref(a_raw, x)
    raw = {s: float((ops.launch(a_raw, x, mk, s) - want).abs().max()) for s in ops.SPLITS}
    log(f"phase 3 kernels: spmm dense_unnormalised (recorded, no gate): max abs err by "
        f"split {json.dumps(raw)}, max |y| {float(want.abs().max())}")
    record["spmm_dense_unnormalised"] = {"max_abs_err": raw,
                                         "max_abs_y": float(want.abs().max())}
    del a_raw, want
    a = torch.zeros((300, 500), device=dev)
    x = torch.randn((500, 64), generator=gen, device=dev)
    dead = torch.zeros((10, 16), dtype=torch.int32, device=dev)
    row = check_spmm(torch, ops, ref, timer, "all_dead", a, x, dead, 20)
    if any(ops.launch(a, x, dead, s).abs().max() != 0 for s in ops.SPLITS):
        raise AssertionError("spmm all_dead: output is not exactly zero")
    shapes.append(row)
    del a, x, dead, table1, mk
    # the training path's shapes, from their own generators too
    train_shapes, record["spmm_backward"] = spmm_training_shapes(
        torch, ops, ref, timer, fed, dev, torch.Generator(device=dev).manual_seed(2),
        np.random.default_rng(2))
    shapes += train_shapes
    record["spmm_shapes"] = shapes
    record["spmm_nonfinite"] = nonfinite

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
    log(f"phase 4 serve: warm fill + warmup {t_setup} s ({warm_launches} warmup "
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
    record["poisoned"] = poisoned_fallbacks(torch, g, idx, mask, params, dev, ids[:128],
                                            GraphStore, ServedModel, QueryEngine)

    if args.profile:
        prof = profile_traffic(torch, engine, LoadGenerator)
        record["profile"] = prof
        log(f"profile: {kind}, {smi}: traffic wall {prof['wall_ms']} ms, device busy "
            f"{prof['device_busy_ms']} ms (share {prof['device_busy_share']})")
        for e in prof["top_device"]:
            log(f"profile: device {e['device_ms']} ms x{e['count']} {e['name']}")
        for e in prof["top_host"]:
            log(f"profile: host {e['self_cpu_ms']} ms x{e['count']} {e['name']}")

    del engine, model, cpu_engine, cpu_model, store, cpu_store
    torch.cuda.empty_cache()

    # -- phase 7: lm-kernels against their plain versions ----------------------
    bf16, f32 = torch.bfloat16, torch.float32
    wkv_rows = [
        check_wkv6(torch, wops, wref, timer, gen, "prefill_bf16", 4, 2048, 32, 64, bf16,
                   20, 2, others=True),
        check_wkv6(torch, wops, wref, timer, gen, "prefill_fp32", 4, 2048, 32, 64, f32,
                   10, 2, others=True),
        check_wkv6(torch, wops, wref, timer, gen, "ragged_fp32", 2, 77, 4, 64, f32, 20, 3),
        check_wkv6(torch, wops, wref, timer, gen, "ragged_bf16", 2, 77, 4, 64, bf16, 20, 3),
        # the other head sizes at the prefill's width (d 2,048)
        check_wkv6(torch, wops, wref, timer, gen, "n32_bf16", 4, 2048, 64, 32, bf16, 10, 1),
        check_wkv6(torch, wops, wref, timer, gen, "n128_bf16", 4, 2048, 16, 128, bf16, 10,
                   1),
        # one step; one step past a stage of the input ring
        check_wkv6(torch, wops, wref, timer, gen, "t1_bf16", 4, 1, 32, 64, bf16, 20, 3),
        check_wkv6(torch, wops, wref, timer, gen, "stage_plus_1_fp32", 2,
                   wops.STAGE_STEPS + 1, 4, 64, f32, 20, 3),
        # bases the copy engine cannot take
        check_wkv6(torch, wops, wref, timer, gen, "misaligned_bf16", 2, 77, 4, 64, bf16, 20,
                   3, misalign=True),
    ]
    flash_rows = [
        check_flash(torch, fops, fref, timer, gen, "local_bf16", 4, 2048, 16, 8, 240, True,
                    1024, bf16, 10),
        check_flash(torch, fops, fref, timer, gen, "attn_bf16", 4, 2048, 16, 8, 240, True,
                    None, bf16, 10),
        check_flash(torch, fops, fref, timer, gen, "local_fp32", 4, 2048, 16, 8, 240, True,
                    1024, f32, 5),
        check_flash(torch, fops, fref, timer, gen, "attn_fp32", 4, 2048, 16, 8, 240, True,
                    None, f32, 5),
        check_flash(torch, fops, fref, timer, gen, "ragged_fp32", 2, 1000, 6, 2, 64, True,
                    None, f32, 10),
        check_flash(torch, fops, fref, timer, gen, "ragged_local_bf16", 2, 1000, 6, 2, 64,
                    True, 256, bf16, 10),
        check_flash(torch, fops, fref, timer, gen, "ragged_bf16_hd128", 2, 1000, 8, 4, 128,
                    True, None, bf16, 10),
        check_flash(torch, fops, fref, timer, gen, "noncausal_bf16", 1, 512, 4, 4, 240,
                    False, None, bf16, 10),
        # hd not a multiple of 8: TMA cannot take it, bf16 runs the FMA kernel
        check_flash(torch, fops, fref, timer, gen, "odd_hd_bf16", 1, 300, 4, 2, 36, True,
                    None, bf16, 10),
    ]
    record["wkv6_shapes"], record["flash_shapes"] = wkv_rows, flash_rows
    del timer
    torch.cuda.empty_cache()

    # -- phase 8: lm-serve (the LM main paths; counts from 0 before each) ------
    counters = {"spmm": ops.block_spmm, "wkv6": wops.wkv6,
                "flash_attention": fops.flash_attention}
    tag = f"{kind}, {smi}"
    lm_counts = {}
    for arch in LM_ARCHS:
        row = lm_serve(torch, serve, counters, get_config(arch), dev, tag, LM_BATCH,
                       LM_PROMPT, LM_GEN)
        record.setdefault("lm_serve", {})[arch] = row
        lm_counts[arch] = row["launches"]
        torch.cuda.empty_cache()

    # -- phase 9: lm-check ------------------------------------------------------
    for arch in LM_ARCHS:
        record.setdefault("lm_check", {})[arch] = lm_check_full(
            torch, lm, rmsnorm, get_config(arch), dev, tag, LM_BATCH, LM_PROMPT, LM_GEN,
            args.profile)
        torch.cuda.empty_cache()
    for arch in (*LM_ARCHS, "mini"):
        cfg = mini_config() if arch == "mini" else get_smoke_config(arch)
        lm_check_smoke(torch, lm, cfg, dev, lm_params_from_numpy, lm_params_to_numpy)

    # -- phase 10: train (the FedAIS main path; counts from 0) -------------------
    record["train"], train_launches = train_phase(torch, api, fedais, ops, ref, counters, g,
                                                  fed, dev, tag, args.profile)

    # -- the kernels line --------------------------------------------------------
    warm = shapes[0]
    kernels = [{
        "name": "spmm_block_f32", "route": "cuda",
        "source": "src/repro_torch/kernels/spmm/csrc/spmm.cu",
        "replaces": "src/repro/kernels/spmm/spmm.py:45",
        "launches": launches + train_launches,
        "launches_by_path": {"gcn_serving": launches, "fedais_training": train_launches},
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "ms": warm["ms"], "plain_ms": warm["plain_ms"], "bound_ms": warm["bound_ms"],
        "bound_by": warm["bound_by"], "library_ms": warm["library_ms"],
        "timed_shape": "warm_fill", "shapes": shapes,
    }]
    for name, src, replaces, rows, count in (
            ("wkv6_fwd", "src/repro_torch/kernels/wkv6/csrc/wkv6.cu",
             "src/repro/kernels/wkv6/wkv6.py:54", wkv_rows, lm_counts["rwkv6-1.6b"]["wkv6"]),
            ("flash_attention_fwd",
             "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/flash_attention.py:89", flash_rows,
             lm_counts["gemma3-12b"]["flash_attention"])):
        main_row = rows[0]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": count, "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"], "timed_shape": main_row["shape"],
            # floor_ms is a model of the kernel's work, not a measurement:
            # it stays in the phase-7 rows of the record, not in this line
            "shapes": [{k: v for k, v in r.items() if k != "floor_ms"} for r in rows]})
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
