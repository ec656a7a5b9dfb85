"""Device time of the kernels whose name holds ``spmm``, per round."""


def read(run):
    return 1e3 * run.device_s.get("spmm", 0.0) / run.rounds if run.rounds else None
