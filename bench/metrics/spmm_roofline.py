"""The SpMM launches' least time over their device time, in percent: for
each launch of the traced window, max(bytes its inputs need at 3.35 TB/s,
2·D a nonzero at 67 TFLOP/s), from the inputs (fedbench.work), summed, over
the summed device time of the kernels whose name holds ``spmm``. Nothing is
read where the traced launches and the counted ones differ in number."""


def read(run):
    times = run.spmm_durations_s
    if not times or len(times) != len(run.spmm_work) or sum(times) <= 0:
        return None
    return 100.0 * sum(w["bound_s"] for w in run.spmm_work) / sum(times)
