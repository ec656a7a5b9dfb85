"""``bench/traced_spans.py``: a toy cell's ``--trace 1`` run with the
program's spans on, on the CPU. The profiler of a CPU build traces the host
alone, and its window ends with a ``torch.cuda.synchronize()`` that a CPU
build refuses, so that one call is a no-op here. Every reading of the
spans is a finite number, the phases follow the rounds the window traced,
and the result line still says ``correct``. The split of the device's busy
time between stamp kernels is tested on a made-up trace."""
from __future__ import annotations

import json
import math

import benchutil
import torch


def test_traced_spans_reads_every_span(tmp_path, capsys, monkeypatch):
    import traced_spans

    from repro_torch.utils import spans

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    root = benchutil.toy_root(tmp_path)
    try:
        rc = traced_spans.main(["--workload", benchutil.TOY_CELL, "--seed", "3000000019",
                                "--seconds", "0.5"], root=root, require_chip=False,
                               device="cpu")
    finally:
        spans.reset()
    assert rc == 0 and not spans.enabled()
    result, line = (json.loads(x) for x in capsys.readouterr().out.strip().splitlines()[-2:])
    assert result["correct"]
    read = line["readings"]
    assert len(read) == 12 and all(math.isfinite(v) and v >= 0 for v in read.values())
    rounds, counts = line["rounds"], line["phase_counts"]
    assert line["counters"]["rounds"] == rounds
    assert counts["loss_pass"] == 2 * rounds and counts["train_step"] == 2 * 4 * rounds
    assert counts["eval"] == line["counters"]["evals"] == 2
    # a CPU trace has no stamp kernel to split the device's busy time by
    assert line["phase_busy_ms_per_step"] is None


def test_phase_busy_splits_the_device_between_stamps():
    from traced_spans import phase_busy

    stamp = "(anonymous namespace)::stamp_kernel(unsigned long long*)"
    dev = [(0, 1, stamp), (2, 10, "gemm"), (8, 12, "copy"), (20, 21, stamp),
           (21, 30, "other"), (40, 41, stamp),                # round: a, b
           (50, 51, stamp), (55, 65, "eval"), (70, 71, stamp)]   # eval
    got = phase_busy({"device": sorted(dev)}, [["a", "b"], ["eval"]])
    # a: the stamp's own 1 + [2, 12] + the next stamp's start = 11 of 20 ns;
    # b: 1 + 9 = 10 of 20; eval 1 + 10 = 11 of 20
    assert got == {"a": 11e-6, "b": 10e-6, "eval": 11e-6}
    assert phase_busy({"device": sorted(dev)}, [["a"], ["eval"]]) is None
