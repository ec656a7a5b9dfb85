"""The round's model operations (the GraphSAGE products and 2·D a live
neighbour of each aggregation, forward and backward, the evals' share
included, counted from shapes and inputs by fedbench.work) over the
measured window's time a round, as a share of one H100's fp32 peak
(67 TFLOP/s outside the tensor cores: the configuration is fp32 with TF32
off), in percent."""

PEAK_FLOPS = 67e12


def read(run):
    if not run.step_ms or not run.flops_per_round:
        return None
    return 100.0 * run.flops_per_round / (run.step_ms / 1e3) / PEAK_FLOPS
